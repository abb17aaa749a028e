"""High-throughput offline batch inference.

Counterpart of the JAX package's ``infer/offline_engine.py``: fills every
decode slot, generates until each sequence finishes, and refills from the
work queue, with no server. On a CUDA device each decode step is a replay of
the engine's captured graph (``infer/cuda_graphs.py``).

Run::

    python -m maxtext_indextts2_tpu_torch.infer.offline_engine <config.yml> \\
        [prompts_path=<jsonl of {"prompt": [ids...]}>] [max_new_tokens=16] [device=cpu]

(the GPU unless ``device=cpu``; one JSON line a prompt).
"""

from __future__ import annotations

import numpy as np

from maxtext_indextts2_tpu_torch.config import Config
from maxtext_indextts2_tpu_torch.infer.engine import Engine


class OfflineEngine:
    def __init__(self, cfg: Config, engine: Engine | None = None, eos_id: int | None = None,
                 device=None):
        self.engine = engine or Engine(cfg, device=device)
        self.eos_id = eos_id
        if self.engine.params is None:
            self.engine.load_params()

    def generate_batch(self, prompts: list[np.ndarray], max_new_tokens: int) -> list[list[int]]:
        """Each prompt's completion (its first token from the prefill, then
        ``max_new_tokens - 1`` decode steps or up to ``eos_id``)."""
        eng = self.engine
        state = eng.init_decode_state()
        results: list[list[int] | None] = [None] * len(prompts)
        slot_req = [-1] * eng.num_slots  # request index per slot
        remaining = np.zeros(eng.num_slots, np.int32)
        next_req = 0
        active = 0

        def admit(state):
            nonlocal next_req, active
            for slot in range(eng.num_slots):
                if slot_req[slot] == -1 and next_req < len(prompts):
                    p = prompts[next_req]
                    prefix, first = eng.prefill(p, len(p))
                    state = eng.insert(prefix, state, slot)
                    results[next_req] = [int(first.cpu()[0])]
                    slot_req[slot] = next_req
                    remaining[slot] = max_new_tokens - 1
                    next_req += 1
                    active += 1
            return state

        state = admit(state)
        while active > 0:
            state, toks = eng.generate(state)
            toks = toks.cpu().numpy()
            refill = False
            for slot in range(eng.num_slots):
                ri = slot_req[slot]
                if ri < 0:
                    continue
                tok = int(toks[slot])
                results[ri].append(tok)
                remaining[slot] -= 1
                if remaining[slot] <= 0 or (self.eos_id is not None and tok == self.eos_id):
                    slot_req[slot] = -1
                    active -= 1
                    refill = True
            if refill:
                state = admit(state)
        return [r if r is not None else [] for r in results]


def main(argv=None):
    """Batch-decode prompts from a JSONL file ({"prompt": [ids...]}) or a
    default pair of prompts."""
    import json
    import sys

    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv, device = split_device_arg(list(sys.argv[1:] if argv is None else argv))
    prompts_path, max_new = "", 16
    keep = []
    for a in argv:
        if a.startswith("prompts_path="):
            prompts_path = a.split("=", 1)[1]
        elif a.startswith("max_new_tokens="):
            max_new = int(a.split("=", 1)[1])
        else:
            keep.append(a)
    cfg = load_config(keep)
    if prompts_path:
        with open(prompts_path) as fh:
            prompts = [np.asarray(json.loads(line)["prompt"], np.int32) for line in fh]
    else:
        prompts = [np.arange(1, 6, dtype=np.int32), np.arange(7, 15, dtype=np.int32)]
    outs = OfflineEngine(cfg, device=device).generate_batch(prompts, max_new)
    for p, o in zip(prompts, outs):
        print(json.dumps({"prompt": p.tolist(), "completion": o}))
    return outs


if __name__ == "__main__":
    main()
