"""Inference engine: prefill / insert / generate continuous-batching slots.

Counterpart of the JAX package's ``infer/engine.py``. The decode state is a
dictionary::

    {"cache": per-layer KVCaches, batch dim = num_slots,
     "tokens": [slots] int32 last sampled token,
     "pos": [slots] int32 next position,
     "active": [slots] bool}

``prefill`` runs the model over one prompt and returns a prefix (a cache of
batch 1 plus the first token); ``insert`` copies that prefix into a slot of
the decode state; ``generate`` advances every slot one token;
``prefill_insert_many`` admits several prompts with one packed prefill.

PyTorch runs eagerly, so nothing is compiled or bucketed: a prompt is not
padded to ``max_prefill_predict_length``, and ``refresh_decode`` /
``refresh_prefill`` (which drop compiled programs in the JAX package) are
no-ops kept so that callers port unchanged.

IN-PLACE: where the JAX engine returns a new decode state from a donated
one, this engine MUTATES the decode state it is given and returns the same
object. ``insert`` writes only the prefix's valid rows into the slot and
resets the slot's segment ids and write index; rows beyond the prefix keep
the previous occupant's bytes and are never read, since every decode mask is
bounded by the slot's ``cache_index`` and segment ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.infer.sampling import sample_tokens
from maxtext_indextts2_tpu_torch.models import (
    MODE_AUTOREGRESSIVE,
    MODE_PREFILL,
    Transformer,
)
from maxtext_indextts2_tpu_torch.models.layers import _unsupported, to_dtype


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU, and no GPU is an error: entry points never
    fall back to the CPU on their own. Tests pass ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this package runs on the GPU unless the caller "
                "asks for the CPU explicitly (device='cpu')")
        return torch.device("cuda")
    return torch.device(device)


def _flat_caches(cache) -> list:
    """The per-unit / per-sub-layer nesting flattened to a list of KVCaches."""
    return [c for unit in cache for c in unit]


class Engine:
    def __init__(self, cfg: Config, device=None, model: Transformer | None = None,
                 params=None):
        self.device = resolve_device(device)
        if cfg.scan_layers:
            if not cfg.serve_unroll_layers and model is None:
                _unsupported("serving with scan-stacked layers (serve_unroll_layers=false)",
                             "5, decode extras")
            # the model is always built unrolled; scan-stacked weights are
            # unstacked by utils/param_bridge.py
            cfg = dataclasses.replace(cfg, scan_layers=False)
        if cfg.paged_attention:
            _unsupported("paged_attention", "5, decode extras")
        if cfg.spec_num_draft_tokens > 0:
            _unsupported("speculative decoding", "5, decode extras")
        self.cfg = cfg
        self.model = model if model is not None else Transformer(cfg, device=self.device)
        self.model.eval()
        self.params = None  # set by load_params / set_params: the model's state dict
        self.num_slots = int(cfg.per_device_batch_size * cfg.num_devices)
        self.generator = torch.Generator(device=self.device).manual_seed(int(cfg.seed))
        if params is not None:
            self.set_params(params)

    # ------------------------------------------------------------- params
    def _cast_for_serving(self, cast_dtype=None):
        if cast_dtype is None and self.cfg.serve_params_dtype:
            cast_dtype = to_dtype(self.cfg.serve_params_dtype)
        if cast_dtype is None:
            return
        for name, p in self.model.named_parameters():
            # float32 weights only, and anything named "scale" (norm scales,
            # quantization scales) stays float32, as in the JAX engine
            if p.dtype == torch.float32 and "scale" not in name:
                p.data = p.data.to(cast_dtype)

    def load_params(self, path: str | None = None, cast_dtype=None):
        """Seeded random weights (``init_weights_seed``), then the serving
        cast. No checkpoint format is ported yet."""
        path = path or self.cfg.load_parameters_path
        if path:
            _unsupported("loading a checkpoint from disk", "4, checkpointing")
        self.model.init_params(self.cfg.init_weights_seed)
        self._cast_for_serving(cast_dtype)
        self.params = self.model.state_dict()
        return self.params

    def set_params(self, state_dict, cast_dtype=None):
        """Take weights from a state dict (e.g. ``utils.param_bridge
        .params_from_jax``), then the serving cast."""
        want = self.model.state_dict()
        missing = sorted(set(want) - set(state_dict))
        extra = sorted(set(state_dict) - set(want))
        if missing or extra:
            raise KeyError(f"state dict mismatch: missing {missing}, unexpected {extra}")
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                src = torch.as_tensor(state_dict[name])
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
                p.data = src.to(device=self.device, dtype=p.dtype).clone()
        self._cast_for_serving(cast_dtype)
        self.params = self.model.state_dict()
        return self.params

    def refresh_decode(self):
        """No-op: eager PyTorch holds no compiled decode programs."""

    def refresh_prefill(self):
        """No-op: eager PyTorch holds no compiled prefill programs."""

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return sample_tokens(
            logits, self.generator, cfg.decode_sampling_strategy,
            cfg.decode_sampling_temperature, cfg.decode_sampling_top_k,
            cfg.decode_sampling_nucleus_p,
        )

    def _check_params(self):
        if self.params is None:
            raise RuntimeError("load_params() or set_params() first")

    # ------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, tokens: np.ndarray, true_length: int):
        """One prompt -> (prefix, first_token [1] on the device). The prefix
        cache holds ``true_length`` rows (no padding to a bucket)."""
        self._check_params()
        cfg = self.cfg
        n = int(true_length)
        if not 1 <= n <= cfg.max_prefill_predict_length:
            raise ValueError(f"prompt length {n} outside [1, {cfg.max_prefill_predict_length}]")
        toks = torch.as_tensor(np.asarray(tokens[:n], np.int32), device=self.device)[None, :]
        positions = torch.arange(n, dtype=torch.int32, device=self.device)[None, :]
        segs = torch.ones_like(toks)
        cache = self.model.init_cache(1, n, self.device)
        logits = self.model(toks, positions, segs, mode=MODE_PREFILL, cache=cache)
        last = logits[:, n - 1]  # [1, V]
        first_token = self._sample(last)
        prefix = {
            "cache": cache,
            "token": first_token,
            "pos": torch.tensor([n], dtype=torch.int32, device=self.device),
            "length": n,
            "logits": last,
        }
        return prefix, first_token

    # ------------------------------------------------------- decode state
    def init_decode_state(self):
        cfg = self.cfg
        slots = self.num_slots
        return {
            "cache": self.model.init_cache(slots, cfg.max_target_length, self.device),
            "tokens": torch.zeros((slots,), dtype=torch.int32, device=self.device),
            "pos": torch.zeros((slots,), dtype=torch.int32, device=self.device),
            "active": torch.zeros((slots,), dtype=torch.bool, device=self.device),
        }

    # ------------------------------------------------------------- insert
    @staticmethod
    def _insert_cache(full, pre, slot: int, start: int, length: int):
        """Copy rows [start, start+length) of batch row 0 of the prefix cache
        ``pre`` to rows [0, length) of ``slot`` in ``full``; reset the slot's
        segment ids and write index. Touches only this slot, in place."""
        for dst, src in zip(_flat_caches(full), _flat_caches(pre)):
            dst.cached_key[slot, :length] = src.cached_key[0, start:start + length]
            dst.cached_value[slot, :length] = src.cached_value[0, start:start + length]
            if dst.quantize:
                dst.key_scale[slot, :length] = src.key_scale[0, start:start + length]
                dst.value_scale[slot, :length] = src.value_scale[0, start:start + length]
            dst.cached_segment_ids[slot, :length] = 1
            dst.cached_segment_ids[slot, length:] = 0
            dst.cache_index[slot] = length

    @torch.no_grad()
    def insert(self, prefix, decode_state, slot: int):
        """Put a prefix into ``slot``. Mutates and returns ``decode_state``."""
        slot, n = int(slot), int(prefix["length"])
        if not 0 <= slot < self.num_slots:
            raise ValueError(f"slot {slot} outside [0, {self.num_slots})")
        self._insert_cache(decode_state["cache"], prefix["cache"], slot, 0, n)
        decode_state["tokens"][slot] = prefix["token"][0]
        decode_state["pos"][slot] = n
        decode_state["active"][slot] = True
        return decode_state

    @torch.no_grad()
    def prefill_insert_many(self, decode_state, prompts: list[np.ndarray],
                            slots: list[int], bucket: int | None = None):
        """Fused admission: pack k prompts into one prefill (segment ids
        1..k, positions restarting at each prompt), copy each prompt's span
        into its slot and sample each first token, with no device-to-host
        copy. ``bucket`` bounds the packed length as in the JAX engine (there
        it is also the padded width; here nothing is padded). Mutates
        ``decode_state``; returns (decode_state, first_tokens [k] on the
        device)."""
        self._check_params()
        cfg = self.cfg
        p = bucket or cfg.max_prefill_predict_length
        if p > cfg.max_prefill_predict_length:
            raise ValueError(f"bucket {p} > prefill limit {cfg.max_prefill_predict_length}")
        k = len(prompts)
        if k < 1 or k != len(slots) or len(set(slots)) != k:
            raise ValueError(f"need one distinct slot per prompt, got {k} prompts, slots {slots}")
        if not all(0 <= int(s) < self.num_slots for s in slots):
            raise ValueError(f"slots {slots} outside [0, {self.num_slots})")
        lengths = [len(t) for t in prompts]
        total = sum(lengths)
        if min(lengths) < 1 or total > p:
            raise ValueError(f"prompt lengths {lengths}: each >= 1 and {total} in all <= {p}")

        inputs = np.zeros((1, total), np.int32)
        positions = np.zeros((1, total), np.int32)
        segs = np.zeros((1, total), np.int32)
        starts = []
        off = 0
        for i, t in enumerate(prompts):
            n = len(t)
            starts.append(off)
            inputs[0, off:off + n] = t
            positions[0, off:off + n] = np.arange(n)
            segs[0, off:off + n] = i + 1
            off += n

        dev = self.device
        cache = self.model.init_cache(1, total, dev)
        logits = self.model(
            torch.as_tensor(inputs, device=dev), torch.as_tensor(positions, device=dev),
            torch.as_tensor(segs, device=dev), mode=MODE_PREFILL, cache=cache)
        last_rows = torch.as_tensor(
            [s + n - 1 for s, n in zip(starts, lengths)], dtype=torch.long, device=dev)
        first_tokens = self._sample(logits[0, last_rows])  # [k]

        for slot, start, n in zip(slots, starts, lengths):
            self._insert_cache(decode_state["cache"], cache, int(slot), start, n)
        slot_idx = torch.as_tensor([int(s) for s in slots], dtype=torch.long, device=dev)
        decode_state["tokens"][slot_idx] = first_tokens
        decode_state["pos"][slot_idx] = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        decode_state["active"][slot_idx] = True
        return decode_state, first_tokens

    # ------------------------------------------------------------ release
    @torch.no_grad()
    def release_slot(self, decode_state, slot: int):
        """Mark a finished request's slot inactive (its ``pos`` stops)."""
        return self.release_slots(decode_state, [int(slot)])

    @torch.no_grad()
    def release_slots(self, decode_state, slots):
        mask = np.zeros(self.num_slots, bool)
        mask[list(slots)] = True
        decode_state["active"] &= ~torch.as_tensor(mask, device=self.device)
        return decode_state

    # ------------------------------------------------------------ generate
    @torch.no_grad()
    def _generate_step(self, decode_state, impl: str | None = None):
        """One token for every slot. Returns (new_tokens [slots], logits
        [slots, V]); the state is updated in place."""
        cfg = self.cfg
        tokens = decode_state["tokens"][:, None]
        pos = decode_state["pos"][:, None]
        logits = self.model(
            tokens, pos, torch.ones_like(tokens), mode=MODE_AUTOREGRESSIVE,
            cache=decode_state["cache"], impl=impl,
        )[:, 0]
        new_tokens = self._sample(logits)
        active = decode_state["active"]
        decode_state["tokens"] = torch.where(active, new_tokens, decode_state["tokens"])
        # SATURATE at the cache end: a slot whose stream finished host-side
        # but was never released keeps active=True and would otherwise step
        # past max_target_length; a cache row past the end is an illegal
        # address on CUDA and ends the context for the whole process
        decode_state["pos"] = torch.clamp(
            decode_state["pos"] + active.to(torch.int32), max=cfg.max_target_length - 1)
        return new_tokens, logits

    def generate(self, decode_state, impl: str | None = None):
        """One decode step. ``impl="plain"`` routes the kernels to their
        plain versions (on-device comparisons only). Returns
        (decode_state, new_tokens [slots] on the device)."""
        self._check_params()
        new_tokens, _ = self._generate_step(decode_state, impl)
        return decode_state, new_tokens

    def generate_n(self, decode_state, n: int, impl: str | None = None):
        """n decode steps with no device-to-host copy in between. Returns
        (decode_state, tokens [n, slots] on the device): the caller fetches
        them with ONE copy."""
        self._check_params()
        steps = [self._generate_step(decode_state, impl)[0] for _ in range(n)]
        return decode_state, torch.stack(steps)

    # --------------------------------------------------------- convenience
    def generate_stream(self, prompt_tokens: np.ndarray, max_new_tokens: int):
        """Single-stream decode helper: prefill -> insert(0) -> generate loop."""
        prefix, first = self.prefill(prompt_tokens, len(prompt_tokens))
        state = self.init_decode_state()
        state = self.insert(prefix, state, 0)
        steps = [first[:1]]
        for _ in range(max_new_tokens - 1):
            state, toks = self.generate(state)
            steps.append(toks[:1])
        return [int(t) for t in torch.cat(steps).cpu().tolist()]
