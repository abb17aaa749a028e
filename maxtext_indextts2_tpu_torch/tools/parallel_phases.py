"""The multi-rank phases of ``chip_smoke.py``: several ranks on one card.

Each rank is a spawned process that joins the process group through
``parallel/mesh.maybe_initialize_distributed`` (``tcp://127.0.0.1:<free
port>``), takes ``cuda:{LOCAL_RANK % device_count}`` (one card: all share
it, so the group is gloo) and loads the kernel library the parent built.
:func:`run_ranks` spawns them and returns what each rank's body returned; a
rank that raises fails the call.

The parent computes the one-rank references first (:func:`attention_reference`,
:func:`train_reference`) and writes them under its temporary directory; a
rank compares its own pieces against them. Every body reports, for each of
its runs: the seconds, the K9-K11 launches, the collectives' calls and bytes
(``parallel/comm.stats``), the weight gathers and gradient reductions
(``parallel/fsdp.stats``), the rank's peak memory, and the numbers its run
is held to.

The splits inside the layers (``parallel/tensor.py``) run in the same two
spawns: :func:`split_two_ranks` (``tp_serve`` dense, paged and
``int8w_serve``, ``ar_context_serve``, ``ep_serve``, ``ep_train``) before
the elastic resize, :func:`split_four_ranks` (``tp_train``) after the cp 4
attention, each held to a one-rank reference the parent makes first
(:func:`split_references`); a serving run reports its streams, how far
its logits lie from the reference's behind the tokens they share and in
the teacher-forced logits of the reference's first two streams, and its
peak memory beside the one-rank engine's; every run the launches of each
hand-written kernel (:func:`kernel_counts`).

Run alone (after the kernels are built): ``python -m
maxtext_indextts2_tpu_torch.tools.parallel_phases`` prints every run's line.
"""

from __future__ import annotations

import gc
import json
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TTS_1B = os.path.join(REPO, "maxtext_indextts2_tpu_torch", "configs", "models", "tts-1b.yml")
# the tts-1b training recipe (bfloat16 weights and moments), at a learning
# rate whose updates show; the same in every run of a comparison
TRAIN_ARGS = [TTS_1B, "dataset_type=synthetic", "remat_policy=save_attn_and_mlp",
              "attention=flash", "weight_dtype=bfloat16", "scan_layers=false",
              "cast_logits_to_fp32=false", "learning_rate=1e-4", "warmup_steps_fraction=0"]
# a parameter of two runs may differ by 2 learning rates a step (an Adam
# update, m / (sqrt(v) + eps), lies within about [-1, 1] an element, so two
# runs' updates differ by at most 2) plus this share of its value (a
# bfloat16 rounding apart)
UPDATES_PER_STEP, PARAM_ROUNDING = 2.0, 2.0 ** -7
FSDP_STEPS = 3
PIPELINE_STEPS = 2
ONE_RANK_ROWS = 4  # the recipe's 4 x 2048 tokens: 2 rows a rank on two ranks
# the depth of the splits' tp_train, tp_serve_int8w and ar_context_serve
# runs: 4 of tts-1b's 20 layers (full width)
SPLIT_LAYERS = 4
LAYERS = [f"base_num_decoder_layers={SPLIT_LAYERS}"]
CONTEXT_TOKENS = 16384
ELASTIC_ARGS = TRAIN_ARGS + ["base_num_decoder_layers=4", "steps=5", "per_device_batch_size=2",
                             "ici_fsdp_parallelism=2"]
ELASTIC_FAIL_AT = 3
ATTENTION = dict(b=1, s=CONTEXT_TOKENS, h=16, hkv=8, d=128)
# the splits inside the layers: tts-1b served whole (20 layers) over tensor 2
# (dense K1 and paged K4), at 4 layers with int8w_serve weights and over
# context_autoregressive 2 (dot_product decode: each rank half the cache's
# rows), qwen3-30b-a3b at full width and 2 of its 48 layers over expert 2,
# served and trained; tts-1b's recipe at 4 layers trained over fsdp 2 x
# tensor 2 (ops/smoke.py's SPLIT_* shapes)
SPLIT_SLOTS, SPLIT_STEPS, SPLIT_PROMPT_MAX = 8, 32, 256
SPLIT_SERVE_ARGS = [TTS_1B, "decode_attention=ragged", "serve_params_dtype=bfloat16",
                    "decode_sampling_strategy=greedy", "max_prefill_predict_length=256",
                    "max_target_length=1024", "scan_layers=false",
                    f"per_device_batch_size={SPLIT_SLOTS}"]
SPLIT_PAGED = ["paged_attention=true", "pagedattn_tokens_per_page=64",
               "pagedattn_num_pages=160"]
SPLIT_INT8W = ["quantization=int8w_serve"] + LAYERS
AR_CONTEXT_ARGS = [a for a in SPLIT_SERVE_ARGS if not a.startswith("decode_attention")] \
    + ["decode_attention=dot_product"] + LAYERS
EP_SERVE_ARGS = ["model_name=qwen3-30b-a3b", "base_num_decoder_layers=2",
                 "weight_dtype=bfloat16", "serve_params_dtype=bfloat16", "dtype=bfloat16",
                 "decode_attention=ragged", "decode_sampling_strategy=greedy",
                 "max_prefill_predict_length=256", "max_target_length=1024", "scan_layers=false",
                 f"per_device_batch_size={SPLIT_SLOTS}"]
EP_TRAIN_ARGS = ["model_name=qwen3-30b-a3b", "base_num_decoder_layers=2",
                 "dataset_type=synthetic", "weight_dtype=bfloat16", "dtype=bfloat16",
                 "scan_layers=false", "remat_policy=full", "max_target_length=1024",
                 "learning_rate=1e-4", "warmup_steps_fraction=0"]
EP_TRAIN_STEPS = 2


def probe_names(cfg) -> tuple:
    """The weights whose first-step gradients are held to the reference: the
    embedding and a layer on each pipeline stage (the first and the last)."""
    return ("token_embedder.embedding", "decoder.layers_0.self_attention_0.query.kernel",
            f"decoder.layers_{cfg.num_decoder_layers - 1}.mlp_0.wo.kernel")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(world: int, body: str, tmp: str, *args) -> list:
    import torch.multiprocessing as mp

    port = free_port()
    mp.start_processes(_entry, args=(world, port, tmp, body, args), nprocs=world, join=True,
                       start_method="spawn")
    return [torch.load(os.path.join(tmp, f"{body}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _entry(rank, world, port, tmp, body, args):
    from maxtext_indextts2_tpu_torch.ops import _build
    from maxtext_indextts2_tpu_torch.parallel.mesh import maybe_initialize_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # no host-name lookup
    device = maybe_initialize_distributed(init_method=f"tcp://127.0.0.1:{port}")
    _build.load_library()
    try:
        out = BODIES[body](device, tmp, *args)
        torch.save(out, os.path.join(tmp, f"{body}_rank{rank}.pt"))
    finally:
        if dist.is_initialized():  # an elastic rank may have left its group
            dist.destroy_process_group()


def reset_kernel_counts() -> None:
    """Every hand-written kernel's launch count to 0 (this process's)."""
    from maxtext_indextts2_tpu_torch.ops import (
        flash_attention, grouped_matmul, inplace_update, int8w_matmul, ragged_decode_attention,
    )

    for counts in (flash_attention.launch_counts, grouped_matmul.launch_counts):
        for k in counts:
            counts[k] = 0
    ragged_decode_attention.launch_count = ragged_decode_attention.paged_launch_count = 0
    inplace_update.launch_count = int8w_matmul.launch_count = 0


def kernel_counts() -> dict:
    """The launches of the splits' kernels since :func:`reset_kernel_counts`,
    under chip_smoke.py's kernel names."""
    from maxtext_indextts2_tpu_torch.ops import (
        flash_attention, grouped_matmul, inplace_update, int8w_matmul, ragged_decode_attention,
    )

    gm = grouped_matmul.launch_counts
    return {"ragged_decode_attention": ragged_decode_attention.launch_count,
            "paged_decode_attention": ragged_decode_attention.paged_launch_count,
            "inplace_row_update": inplace_update.launch_count, **flash_attention.launch_counts,
            "int8w_matmul": int8w_matmul.launch_count,
            "grouped_matmul_bf16": gm["grouped_matmul"],
            "grouped_matmul_dgrad": gm["grouped_matmul_dgrad"],
            "grouped_matmul_wgrad": gm["grouped_matmul_wgrad"]}


def _measured(fn, *args, **kwargs) -> dict:
    """``fn``'s result with the run's seconds, K9-K11 launches, collectives,
    gathers, peak memory and the memory held before it began (this
    rank's)."""
    from maxtext_indextts2_tpu_torch.ops import flash_attention
    from maxtext_indextts2_tpu_torch.parallel import comm, fsdp

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in flash_attention.launch_counts:
        flash_attention.launch_counts[k] = 0
    comm.reset_stats()
    fsdp.stats.update(gathers=0, reductions=0, gather_seconds=0.0, reduce_seconds=0.0)
    reset_kernel_counts()
    start = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0, launches=dict(flash_attention.launch_counts),
               kernel_launches=kernel_counts(),
               collective_calls=dict(comm.stats["calls"]),
               collective_bytes=dict(comm.stats["bytes"]),
               host_staged_bytes=comm.stats["staged_bytes"], fsdp=dict(fsdp.stats),
               peak_bytes=torch.cuda.max_memory_allocated(), start_bytes=start)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _units(got: torch.Tensor, want: torch.Tensor, updates: float) -> float:
    """The largest |got - want| over its tolerance: ``updates`` Adam updates
    (the learning rate each) and :data:`PARAM_ROUNDING` of the value."""
    from maxtext_indextts2_tpu_torch.config import load_config

    lr = load_config(TRAIN_ARGS).learning_rate
    d = (got.float() - want.float()).abs()
    return float((d / (updates * lr + PARAM_ROUNDING * want.float().abs())).max().item())


def _err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max(1, max |want|))."""
    diff = float((got.float() - want.float().to(got.device)).abs().max().item())
    return diff, diff / max(1.0, float(want.float().abs().max().item()))


# ------------------------------------------------------------ references


def attention_inputs(seed: int = 0) -> dict:
    """q [1,S,16,128], k, v [1,S,8,128] and the output's gradient, bfloat16
    (natural order, on the CPU)."""
    g = torch.Generator().manual_seed(seed)
    a = ATTENTION

    def rnd(n):
        return torch.randn((a["b"], a["s"], n, a["d"]), generator=g).to(torch.bfloat16)

    return {"q": rnd(a["h"]), "k": rnd(a["hkv"]), "v": rnd(a["hkv"]), "do": rnd(a["h"])}


def attention_reference(tmp: str, device) -> str:
    """One-rank K9-K11 on the whole tensors: the output and q / k / v
    gradients, written with the inputs."""
    from maxtext_indextts2_tpu_torch.ops.flash_attention import flash_attention_sharded

    x = attention_inputs()
    q, k, v = (x[n].to(device).clone().requires_grad_(True) for n in ("q", "k", "v"))
    o = flash_attention_sharded(q, k, v, None)
    o.backward(x["do"].to(device))
    x.update(o=o.detach().cpu(), dq=q.grad.cpu(), dk=k.grad.cpu(), dv=v.grad.cpu())
    path = os.path.join(tmp, "attention_reference.pt")
    torch.save(x, path)
    return path


def train_reference(tmp: str, device, extra: list, steps: int, name: str,
                    save_params: bool, base: list = TRAIN_ARGS) -> dict:
    """The one-rank steps of ``base + extra`` (default :data:`TRAIN_ARGS`) on the synthetic batch:
    each step's metrics, the first step's gradients of :func:`probe_names`, and
    (``save_params``) the parameters after the last step, written to
    ``{tmp}/{name}_params.pt``."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.train.data import synthetic

    cfg = load_config(base + extra)
    state = train.setup_train_state(cfg, device)
    batch = {k: torch.from_numpy(np.array(v)).to(device)
             for k, v in synthetic.make_batch(cfg, 0, cfg.global_batch_size_to_train_on).items()}
    probes, hist = {}, []
    for step in range(steps):
        if step == 0:
            loss, aux = train.loss_fn(state.model, cfg, batch)
            names = [n for n in probe_names(cfg) if n in state.params]
            grads = torch.autograd.grad(loss, [state.params[n] for n in names])
            probes = {n: g.float().cpu() for n, g in zip(names, grads)}
            del grads, loss, aux
        hist.append({k: float(v) for k, v in train.train_step(cfg, state, batch).items()})
    out = {"history": hist, "probes": probes, "lr_max": cfg.learning_rate}
    if save_params:
        path = os.path.join(tmp, f"{name}_params.pt")
        torch.save({n: p.detach().cpu() for n, p in state.params.items()}, path)
        out["params_path"] = path
    torch.save(out, os.path.join(tmp, f"{name}_reference.pt"))
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------- rank runs


def _attention_runs(device, tmp, cp: int, algorithms) -> dict:
    """Each algorithm on this rank's shard of the load-balanced sequence,
    forward and backward, against the reference's shard."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.ops.flash_attention import (
        flash_attention_sharded,
        load_balanced_reorder,
    )
    from maxtext_indextts2_tpu_torch.parallel import create_device_mesh
    from maxtext_indextts2_tpu_torch.parallel.sharding import shard

    mesh = create_device_mesh(load_config([f"ici_context_parallelism={cp}",
                                           "ici_fsdp_parallelism=1"]), device)
    ref = torch.load(os.path.join(tmp, "attention_reference.pt"))

    def piece(t):
        return shard(load_balanced_reorder(t, cp, axis=1), "activation_batch",
                     "activation_length", mesh=mesh).to(device)

    pos = piece(torch.arange(ATTENTION["s"], dtype=torch.int32)[None])
    out = {}
    for algorithm in algorithms:
        def run():
            q, k, v = (piece(ref[n]).clone().requires_grad_(True) for n in ("q", "k", "v"))
            do = piece(ref["do"])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            o = flash_attention_sharded(q, k, v, None, mesh=mesh, positions=pos,
                                        algorithm=algorithm)
            o.backward(do)
            torch.cuda.synchronize()
            attention_peak = torch.cuda.max_memory_allocated() - base
            errs = {n: _err(t, piece(ref[n])) for n, t in
                    (("o", o.detach()), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}
            return {"errors": errs, "attention_peak_bytes": attention_peak}
        out[algorithm] = _measured(run)
    return out


def _train_run(device, tmp, extra: list, steps: int, reference: str | None = None,
               keep_at: int = 0, base: list = TRAIN_ARGS) -> dict:
    """``steps`` sharded steps of ``base + extra`` on the synthetic
    global batch, each rank on its piece; the first step's probe gradients
    and the final pieces against the reference where given; a copy of the
    pieces after ``keep_at`` steps (``_kept``)."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.parallel import create_device_mesh
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.train.data import synthetic

    cfg = load_config(base + extra)
    mesh = create_device_mesh(cfg, device)
    state = train.setup_train_state(cfg, device, mesh=mesh)
    rows = cfg.global_batch_size_to_train_on
    batch = {k: torch.from_numpy(np.array(v)).to(device)
             for k, v in synthetic.make_batch(cfg, 0, rows).items()}
    local = train.local_batch(cfg, batch, mesh)
    micro = cfg.gradient_accumulation_steps
    state_bytes = sum(t.numel() * t.element_size() for t in state.shards.values())
    state_bytes += sum(t.numel() * t.element_size() for key in ("mu", "nu")
                       for t in state.opt_state.get(key, {}).values())
    hist, probes, kept = [], {}, None
    torch.cuda.synchronize()
    t_step = time.perf_counter()
    for step in range(steps):
        def loss_of(i, mb):
            loss, aux = train.loss_fn(state.model, cfg, mb)
            return loss, aux["total_weights"]

        loss, grads = train.sharded_grads(cfg, state, train._microbatches(local, micro), loss_of,
                                          train._token_weight)
        if step == 0:
            probes = {n: state.plan.full(n, grads[n]).float().cpu()
                      for n in probe_names(cfg) if n in grads}
        m = train.apply_gradients(cfg, state, grads, {"loss": loss})
        hist.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        hist[-1]["seconds"] = time.perf_counter() - t_step
        t_step = time.perf_counter()
        if step + 1 == keep_at:
            kept = {n: t.detach().clone() for n, t in state.shards.items()}
        del grads
    out = {"history": hist, "rows": rows, "state_bytes": state_bytes,
           "units": list(state.model.decoder.unit_names)}
    if reference is not None:
        ref = torch.load(os.path.join(tmp, f"{reference}_reference.pt"))
        out["probe_errors"] = {n: _err(g, ref["probes"][n]) for n, g in probes.items()}
        if "params_path" in ref and steps == len(ref["history"]):
            want = torch.load(ref["params_path"], mmap=True)
            diff = units = 0.0
            for n, t in state.shards.items():
                w = state.plan.local(n, want[n]).to(device)
                diff = max(diff, float((t.float() - w.float()).abs().max().item()))
                units = max(units, _units(t, w, UPDATES_PER_STEP * steps))
            out["param_max_abs_diff"], out["param_diff_in_tolerance_units"] = diff, units
    out["_kept"] = kept
    return out


def two_ranks(device, tmp) -> dict:
    """Every two-rank run, in order: context-parallel attention at cp 2, FSDP,
    Zero-1 and its counterpart without, the pipeline (and with delayed
    forwarding), a context-parallel training step, the splits' runs
    (:func:`split_two_ranks`), and last the elastic resize (which leaves the
    process group)."""
    from maxtext_indextts2_tpu_torch.train.elastic import elastic_train_loop

    out = {"attention_cp2": _attention_runs(device, tmp, 2, ("ring", "allgather", "ulysses"))}
    out["fsdp"] = _measured(_train_run, device, tmp,
                            ["ici_fsdp_parallelism=2", "per_device_batch_size=2"], FSDP_STEPS,
                            "fsdp")
    out["fsdp"].pop("_kept")
    # Zero-1 on the same 4 rows in two microbatches, against the one-rank
    # steps; the run without it takes one step to count its gathers
    out["zero1"] = _measured(_train_run, device, tmp, ["ici_fsdp_parallelism=2",
                                                       "per_device_batch_size=1",
                                                       "gradient_accumulation_steps=2",
                                                       "zero1_fsdp_ag_once=true"],
                             FSDP_STEPS, "fsdp")
    # the gathers a step with and without Zero-1, one step each at 4 layers
    small = ["ici_fsdp_parallelism=2", "per_device_batch_size=1", "gradient_accumulation_steps=2",
             "base_num_decoder_layers=4"]
    out["zero1_small"] = _measured(_train_run, device, tmp, small + ["zero1_fsdp_ag_once=true"], 1)
    out["zero1_without"] = _measured(_train_run, device, tmp, small, 1)
    for key in ("zero1", "zero1_small", "zero1_without"):
        out[key].pop("_kept")
    for name, delay in (("pipeline", "false"), ("pipeline_delayed", "true")):
        run = _measured(_train_run, device, tmp,
                        ["ici_stage_parallelism=2", "ici_fsdp_parallelism=1",
                         "per_device_batch_size=2",
                         f"pipeline_delay_activation_forwarding={delay}"], PIPELINE_STEPS,
                        "fsdp")
        run.pop("_kept")
        out[name] = run
    run = _measured(_train_run, device, tmp,
                    ["ici_context_parallelism=2", "ici_fsdp_parallelism=1",
                     "context_parallel_algorithm=ring", "per_device_batch_size=0.5",
                     f"max_target_length={CONTEXT_TOKENS}"], 1, "context")
    run.pop("_kept")
    out["context_train"] = run
    fired = []

    def inject(step):
        if step == ELASTIC_FAIL_AT and not fired:
            fired.append(step)
            raise RuntimeError(f"injected failure at step {step}")

    from maxtext_indextts2_tpu_torch.config import load_config

    out.update(split_two_ranks(device, tmp))  # the splits' runs, before the group shrinks
    out["elastic"] = _measured(lambda: {"result": elastic_train_loop(
        load_config(ELASTIC_ARGS), snapshot_period=2, failure_injector=inject,
        devices_fn=lambda: [0] if fired else [0, 1], device=device)})
    return out


def four_ranks(device, tmp) -> dict:
    return {"attention_cp4": _attention_runs(device, tmp, 4, ("ring",)),
            **split_four_ranks(device, tmp)}


# ----------------------------------------------- splits inside the layers


def split_prompts(vocab: int, seed: int = 7) -> list:
    """:data:`SPLIT_SLOTS` prompts of 16 to :data:`SPLIT_PROMPT_MAX` tokens."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, SPLIT_PROMPT_MAX + 1, size=SPLIT_SLOTS)
    lengths[0] = SPLIT_PROMPT_MAX
    return [rng.integers(1, vocab, size=int(n)).astype(np.int32) for n in lengths]


def _teacher_forced(engine, prompt, stream) -> torch.Tensor:
    """The float32 logits of ``engine``'s prefill forward over prompt +
    stream at the rows that predict the stream's tokens (on the CPU)."""
    from maxtext_indextts2_tpu_torch.models import MODE_PREFILL

    dev = engine.device
    full = np.concatenate([prompt, np.asarray(stream[:-1], np.int32)])
    toks = torch.as_tensor(full, device=dev)[None]
    pos = torch.arange(len(full), dtype=torch.int32, device=dev)[None]
    with torch.no_grad():
        logits = engine.model(toks, pos, torch.ones_like(toks), mode=MODE_PREFILL,
                              cache=engine.model.init_cache(1, len(full), dev))[0].float()
    return logits[len(prompt) - 1:].cpu()


def serve_run(engine, prompts, steps: int, eager: bool = False) -> dict:
    """Every prompt prefilled into its own slot, then ``steps`` tokens for
    all slots in one dispatch (``eager``: launched one by one, as a mesh
    engine always does): the greedy streams (first token included) and the
    logits behind them, ``[slots, steps, V]`` float32 (the prefill's last
    row, then each decode step's)."""
    state = engine.init_decode_state()
    rows = []
    for i, p in enumerate(prompts):
        prefix, _ = engine.prefill(p, len(p))
        rows.append(prefix["logits"][0].float())
        engine.insert(prefix, state, i)
    first = state["tokens"].clone()
    decode = []  # a decode step's logits [slots, 1, V] (a captured step adds none)
    hook = engine.model.register_forward_hook(lambda m, a, y: decode.append(y[:, 0].float()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        state, toks = engine.generate_n(state, steps - 1, _eager=eager)
        torch.cuda.synchronize()
    finally:
        hook.remove()
    decode_s = time.perf_counter() - t0
    toks = torch.cat([first[None], toks]).cpu().numpy()
    if len(decode) != steps - 1:
        raise RuntimeError(f"{len(decode)} decode steps seen of {steps - 1} (captured?)")
    return {"streams": [toks[:, i].tolist() for i in range(len(prompts))],
            "logits": torch.stack([torch.stack(rows), *decode], dim=1).cpu(),
            "decode_seconds": decode_s, "captures": engine.graphs.captures}


def serve_reference(tmp: str, device, args: list, name: str) -> dict:
    """The one-rank engine of ``args`` (seeded weights) on
    :func:`split_prompts`, its decode launched one by one as a mesh
    engine's is: its streams, the gap between the largest and second logit
    behind each token, its peak memory above what was held before, and
    (written to ``{tmp}/{name}_reference.pt`` with the rest) its logits
    and the teacher-forced logits of its first two streams."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    engine = Engine(load_config(args), device=device)
    engine.load_params()
    prompts = split_prompts(engine.cfg.vocab_size)
    out = serve_run(engine, prompts, SPLIT_STEPS, eager=True)
    out["forced"] = [_teacher_forced(engine, prompts[i], out["streams"][i]) for i in range(2)]
    top = torch.topk(out["logits"], 2, dim=-1).values
    out.update(prompts=prompts, gaps=(top[..., 0] - top[..., 1]).tolist(),
               peak_bytes=torch.cuda.max_memory_allocated() - start,
               param_bytes=sum(p.numel() * p.element_size() for p in engine.model.parameters()))
    torch.save(out, os.path.join(tmp, f"{name}_reference.pt"))
    del engine, out["logits"], out["forced"]
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _serve_split(device, tmp, args: list, name: str) -> dict:
    """The engine of ``args`` on its mesh (seeded weights, this rank's
    pieces) on the reference's prompts: its streams, and the largest
    difference from the reference's logits behind the tokens both streams
    share (up to and with each stream's first parting) and in the
    teacher-forced logits of the reference's first two streams."""
    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.parallel import create_device_mesh

    ref = torch.load(os.path.join(tmp, f"{name}_reference.pt"), weights_only=False)
    cfg = load_config(args)
    mesh = create_device_mesh(cfg, device)
    engine = Engine(cfg, device=device, mesh=mesh)
    engine.load_params()
    out = serve_run(engine, ref["prompts"], SPLIT_STEPS)
    got, want = out.pop("logits"), ref["logits"]
    decode_err = 0.0
    for i, (a, b) in enumerate(zip(out["streams"], ref["streams"])):
        shared = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(b))
        rows = min(shared, SPLIT_STEPS - 1) + 1  # row j: the logits behind token j
        decode_err = max(decode_err, float((got[i, :rows] - want[i, :rows]).abs().max()))
    forced = [_teacher_forced(engine, ref["prompts"][i], ref["streams"][i]) for i in range(2)]
    forced_err = max(float((g - w).abs().max()) for g, w in zip(forced, ref["forced"]))
    out.update(logit_max_abs_err=max(decode_err, forced_err), decode_logit_max_abs_err=decode_err,
               forced_logit_max_abs_err=forced_err,
               logit_max_abs=max(float(want.abs().max()),
                                 *(float(w.abs().max()) for w in ref["forced"])))
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in engine.model.parameters())
    del engine
    return out


def split_two_ranks(device, tmp) -> dict:
    """The two-rank runs of the splits: tp_serve (dense, paged, then with
    int8w_serve weights), ar_context_serve, ep_serve, ep_train."""
    per_rank = [f"per_device_batch_size={SPLIT_SLOTS // 2}"]
    out = {"tp_serve": _measured(_serve_split, device, tmp,
                                 SPLIT_SERVE_ARGS + ["ici_tensor_parallelism=2"] + per_rank,
                                 "tp_serve"),
           "tp_serve_paged": _measured(_serve_split, device, tmp,
                                       SPLIT_SERVE_ARGS + SPLIT_PAGED
                                       + ["ici_tensor_parallelism=2"] + per_rank,
                                       "tp_serve_paged"),
           "tp_serve_int8w": _measured(_serve_split, device, tmp,
                                       SPLIT_SERVE_ARGS + SPLIT_INT8W
                                       + ["ici_tensor_parallelism=2"] + per_rank,
                                       "tp_serve_int8w"),
           "ar_context_serve": _measured(_serve_split, device, tmp,
                                         AR_CONTEXT_ARGS
                                         + ["ici_context_autoregressive_parallelism=2"]
                                         + per_rank, "ar_context_serve"),
           "ep_serve": _measured(_serve_split, device, tmp,
                                 EP_SERVE_ARGS + ["ici_expert_parallelism=2"] + per_rank,
                                 "ep_serve")}
    run = _measured(_train_run, device, tmp, ["ici_expert_parallelism=2",
                                              "per_device_batch_size=1"],
                    EP_TRAIN_STEPS, "ep_train", base=EP_TRAIN_ARGS)
    run.pop("_kept")
    out["ep_train"] = run
    return out


def split_four_ranks(device, tmp) -> dict:
    """tp_train: the tts-1b recipe at :data:`SPLIT_LAYERS` layers over
    fsdp 2 x tensor 2, against its one-rank reference."""
    run = _measured(_train_run, device, tmp,
                    ["ici_fsdp_parallelism=2", "ici_tensor_parallelism=2",
                     "per_device_batch_size=1"] + LAYERS, FSDP_STEPS, "tp_train")
    run.pop("_kept")
    return {"tp_train": run}


def split_references(tmp: str, device) -> dict:
    """Every one-rank reference of the splits' runs."""
    return {
        "tp_train": train_reference(tmp, device,
                                    [f"per_device_batch_size={ONE_RANK_ROWS}"] + LAYERS,
                                    FSDP_STEPS, "tp_train", True),
        "tp_serve": serve_reference(tmp, device, SPLIT_SERVE_ARGS, "tp_serve"),
        "tp_serve_paged": serve_reference(tmp, device, SPLIT_SERVE_ARGS + SPLIT_PAGED,
                                          "tp_serve_paged"),
        "tp_serve_int8w": serve_reference(tmp, device, SPLIT_SERVE_ARGS + SPLIT_INT8W,
                                          "tp_serve_int8w"),
        "ar_context_serve": serve_reference(tmp, device, AR_CONTEXT_ARGS, "ar_context_serve"),
        "ep_serve": serve_reference(tmp, device, EP_SERVE_ARGS, "ep_serve"),
        "ep_train": train_reference(tmp, device, ["per_device_batch_size=2"], EP_TRAIN_STEPS,
                                    "ep_train", True, base=EP_TRAIN_ARGS),
    }


BODIES = {"two_ranks": two_ranks, "four_ranks": four_ranks}


def elastic_reference(device) -> dict:
    """One process, the elastic run's schedule: steps 0-1 on the two ranks'
    global batch (the snapshot of step 2), then steps 2-4 on one rank's."""
    import dataclasses

    from maxtext_indextts2_tpu_torch.config import load_config
    from maxtext_indextts2_tpu_torch.train import train
    from maxtext_indextts2_tpu_torch.train.data import synthetic

    args = [a for a in ELASTIC_ARGS if not a.startswith(("ici_fsdp", "per_device"))]
    big = load_config(args + ["per_device_batch_size=4"])
    small = dataclasses.replace(big, per_device_batch_size=2, global_batch_size_to_train_on=2,
                                global_batch_size_to_load=2, micro_batch_size_to_train_on=2)
    state = train.setup_train_state(big, device)
    batch = {k: torch.from_numpy(np.array(v)).to(device)
             for k, v in synthetic.make_batch(big, 0, 4).items()}
    for _ in range(2):
        train.train_step(big, state, batch)
    for _ in range(3):
        m = train.train_step(small, state, {k: v[:2] for k, v in batch.items()})
    return {k: float(v) for k, v in m.items()}


def main():
    import tempfile

    from maxtext_indextts2_tpu_torch.ops import _build

    _build.load_library()
    from maxtext_indextts2_tpu_torch.infer.engine import resolve_device

    with tempfile.TemporaryDirectory(prefix="parallel_phases_") as tmp:
        device = resolve_device(None)  # the card, or an error
        attention_reference(tmp, device)
        train_reference(tmp, device, [f"per_device_batch_size={ONE_RANK_ROWS}"], FSDP_STEPS,
                        "fsdp", True)
        train_reference(tmp, device, ["per_device_batch_size=1",
                                      f"max_target_length={CONTEXT_TOKENS}"], 1, "context",
                        False)
        split_references(tmp, device)
        for body, world in (("two_ranks", 2), ("four_ranks", 4)):
            for rank, res in enumerate(run_ranks(world, body, tmp)):
                print(json.dumps({"body": body, "rank": rank, **res}, default=str), flush=True)
        print(json.dumps({"elastic_reference": elastic_reference(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
