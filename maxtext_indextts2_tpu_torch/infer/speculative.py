"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of the JAX package's ``infer/speculative.py``. One round:

1. Draft: K autoregressive steps of the draft model on its own KV cache
   propose d_1..d_K (the decode attention kernel K1 and the row update K2
   on a CUDA device, as any decode step), and one more step writes d_K's
   own row (its output is not used).
2. Verify: ONE target forward over [t_0, d_1..d_K] (K+1 positions) in
   ``MODE_VERIFY``: each slot's span is written at its ``cache_index``
   through K2 at span K+1, ``cache_index`` left as it is, and the span is
   scored against the whole cache (``models/attention.py``).
3. Accept: greedy longest-prefix match (d_j == the target's argmax m_{j-1});
   emit the accepted drafts and one bonus token m_a, advance pos by a+1, and
   set every ``cache_index`` of both models to the new pos.

With greedy sampling the emitted stream is EXACTLY the target's greedy
decode, whatever the draft proposes; the draft only changes how many tokens
a round commits. The cache discipline rests on every decode read being
bounded by ``cache_index`` (or the verify positions), so rows of rejected
drafts are dead until overwritten. Greedy only, and dense caches only: as in
the JAX package, a paged cache is not wired up.

Where this differs from the JAX package, on purpose: the JAX round drafts
with K steps, so after a round that accepts all K drafts the draft's cache
has no row for d_K, and every later draft step attends to whatever that row
held; the draft's proposals degrade from then on (a target used as its own
draft commits K+1 tokens in its first round only). The extra step here
writes that row, so a draft as good as the target commits K+1 tokens every
round. The emitted stream is the same either way.

On a CUDA device a round is ONE captured CUDA graph (``infer/cuda_graphs.py``),
as the JAX package jits it: the round reads and writes both decode states in
place and makes no device-to-host read.
"""

from __future__ import annotations

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.infer.cuda_graphs import GraphCache, state_tensors
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.models import MODE_AUTOREGRESSIVE, MODE_VERIFY


def _set_positions(decode_state, tokens, new_pos):
    """The committed stream's last token and length into a decode state, and
    the length into every layer's ``cache_index``, in place."""
    decode_state["tokens"].copy_(tokens)
    decode_state["pos"].copy_(new_pos)
    for unit in decode_state["cache"]:
        for c in unit:
            c.cache_index.copy_(new_pos)


class SpeculativeEngine:
    """Two engines, target and draft, whose slots move in lockstep."""

    def __init__(self, cfg: Config, draft_cfg: Config, device=None, num_draft_tokens: int = 4):
        if cfg.decode_sampling_strategy != "greedy" or \
                draft_cfg.decode_sampling_strategy != "greedy":
            raise ValueError("speculative decoding is greedy-only (rejection sampling is "
                             "not implemented, in the JAX package either)")
        if cfg.paged_attention or draft_cfg.paged_attention:
            raise ValueError("speculative decoding takes dense KV caches: the verify span is "
                             "not wired up for a paged cache (as in the JAX package)")
        for key in ("vocab_size", "max_target_length", "per_device_batch_size"):
            if getattr(cfg, key) != getattr(draft_cfg, key):
                raise ValueError(f"target and draft differ in {key}: {getattr(cfg, key)} != "
                                 f"{getattr(draft_cfg, key)}")
        if int(num_draft_tokens) < 1:
            raise ValueError(f"num_draft_tokens {num_draft_tokens} < 1")
        self.target = Engine(cfg, device=device)
        self.draft = Engine(draft_cfg, device=self.target.device)
        self.cfg = cfg
        self.K = int(num_draft_tokens)
        self.num_slots = self.target.num_slots
        self.device = self.target.device
        self.graphs = GraphCache()

    def load_params(self, target_path: str | None = None, draft_path: str | None = None):
        self.target.load_params(target_path)
        self.draft.load_params(draft_path)
        self.graphs.clear()

    # ----------------------------------------------------------- lifecycle
    def prefill(self, tokens: np.ndarray, true_length: int):
        """Prefill BOTH models; the first token is the target's."""
        t_prefix, first = self.target.prefill(tokens, true_length)
        d_prefix, _ = self.draft.prefill(tokens, true_length)
        return {"target": t_prefix, "draft": d_prefix}, first

    def init_decode_state(self):
        return {"target": self.target.init_decode_state(),
                "draft": self.draft.init_decode_state()}

    def insert(self, prefix, state, slot: int):
        self.target.insert(prefix["target"], state["target"], slot)
        self.draft.insert(prefix["draft"], state["draft"], slot)
        return state

    # ------------------------------------------------------------- decode
    @torch.no_grad()
    def _round(self, state, impl: str | None = None):
        """One round for every slot, in place, with no device-to-host read.
        Returns (tokens [slots, K+1], n_new [slots]): per slot,
        tokens[:, :n_new] are newly committed."""
        cfg, K = self.cfg, self.K
        tstate, dstate = state["target"], state["draft"]
        t0 = tstate["tokens"].clone()  # [S] last committed token
        pos0 = tstate["pos"].clone()  # [S] == cache_index of both models
        active = tstate["active"]
        ones = torch.ones_like(t0)[:, None]

        # 1. draft K tokens on the draft model's own cache; a (K+1)-th step
        # writes d_K's row, so that no row of an accepted draft is missing
        tok, pos, drafts = t0, pos0, []
        for _ in range(K + 1):
            logits = self.draft.model(tok[:, None], pos[:, None], ones,
                                      mode=MODE_AUTOREGRESSIVE, cache=dstate["cache"],
                                      impl=impl)[:, 0]
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
            drafts.append(tok)
        drafts = torch.stack(drafts[:K], dim=1)  # [S, K]

        # 2. verify: one target pass over [t0, d_1..d_K]
        tokens_v = torch.cat([t0[:, None], drafts], dim=1)  # [S, K+1]
        span = torch.arange(K + 1, dtype=torch.int32, device=t0.device)
        positions_v = torch.clamp(pos0[:, None] + span[None, :], max=cfg.max_target_length - 1)
        logits_v = self.target.model(tokens_v, positions_v, torch.ones_like(tokens_v),
                                     mode=MODE_VERIFY, cache=tstate["cache"], impl=impl)
        preds = torch.argmax(logits_v, dim=-1).to(torch.int32)  # [S, K+1]

        # 3. accept the longest matching prefix and a bonus token
        match = (drafts == preds[:, :K]).to(torch.int32)
        acc = torch.sum(torch.cumprod(match, dim=1), dim=1)  # [S] in [0, K]
        # never run past the context: cap commits so that pos stays < max_length
        room = torch.clamp(cfg.max_target_length - 1 - pos0, min=1)
        n_new = torch.minimum(acc + 1, room)
        acc = n_new - 1
        bonus = torch.gather(preds, 1, acc[:, None].long())[:, 0]
        j = span[None, :]
        padded = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        out = torch.where(j < acc[:, None], padded,
                          torch.where(j == acc[:, None], preds, torch.zeros_like(preds)))
        out = torch.where(j < n_new[:, None], out, torch.zeros_like(out))
        n_new = torch.where(active, n_new, torch.zeros_like(n_new))
        new_pos = pos0 + n_new
        last = torch.where(active, bonus, t0)
        for s in (tstate, dstate):
            _set_positions(s, last, new_pos)
        return out, n_new

    def generate(self, state, impl: str | None = None, _eager: bool = False):
        """One speculative round for every active slot: on a CUDA device ONE
        replay of the round's captured graph; eagerly with ``impl="plain"``
        (comparisons), ``_eager`` or on the CPU. Returns (state, tokens
        [slots, K+1], n_new [slots]), both on the device."""
        for eng in (self.target, self.draft):
            eng._check_params()
        if impl is not None or _eager or self.device.type != "cuda":
            toks, n_new = self._round(state, impl)
        else:
            tensors = state_tensors(state["target"]) + state_tensors(state["draft"])
            toks, n_new = self.graphs.run(("speculative", self.K), tensors,
                                          lambda: self._round(state), [])
        return state, toks, n_new

    # --------------------------------------------------------- convenience
    def generate_stream(self, prompt_tokens: np.ndarray, max_new_tokens: int):
        """Single-stream helper; returns (tokens, rounds): ``rounds`` counts
        target passes, so max_new_tokens / rounds is the tokens a round."""
        prefix, first = self.prefill(prompt_tokens, len(prompt_tokens))
        state = self.init_decode_state()
        state = self.insert(prefix, state, 0)
        out = [int(first.cpu()[0])]
        rounds = 0
        while len(out) < max_new_tokens:
            state, toks, n_new = self.generate(state)
            rounds += 1
            n = int(n_new[0].item())
            out.extend(int(t) for t in toks[0, :n].cpu().tolist())
        return out[:max_new_tokens], rounds
