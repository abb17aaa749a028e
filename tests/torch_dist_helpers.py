"""Rank bodies of the port's multi-rank CPU tests (gloo).

Ranks are ``torch.multiprocessing`` spawns that join a gloo group through a
``FileStore`` in the test's own directory (no TCP port: parallel test
workers never collide, and no host-name lookup), and write their results
there. This module imports only ``torch``, numpy and the
port: a spawned rank must not import a test file, which imports JAX.
:func:`run_ranks` returns each rank's result (what its body returns, saved
with ``torch.save``), in rank order.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, tmp, body, args):
    torch.set_num_threads(1)
    os.environ["WORLD_SIZE"] = str(world)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # no host-name lookup
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    out = globals()[body](*args)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    if dist.is_initialized():  # an elastic rank may have left its group
        dist.barrier()  # no rank leaves while another still reads from it
        dist.destroy_process_group()
    # the result is on disk: leave without the interpreter's teardown of the
    # process group's threads (under load it has aborted a finished rank)
    os._exit(0)


def run_ranks(tmp_path, world: int, body: str, *args) -> list:
    tmp = str(tmp_path)
    mp.start_processes(_entry, args=(world, tmp, body, args), nprocs=world, join=True,
                       start_method="spawn")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _cfg(args):
    from maxtext_indextts2_tpu_torch.config import load_config

    return load_config(list(args))


# ------------------------------------------------------------ attention


def attention(cfg_args, cases):
    """Context-parallel flash attention of each case of ``cases``
    ((algorithm, inputs, kwargs): ``inputs`` q, k, v, pos, seg and ``do``,
    the output's gradient, all [B, S, ...] numpy in the load-balanced order)
    on this rank's shard. Returns, a case, the rank's output and q / k / v
    gradients, and the collective calls."""
    from maxtext_indextts2_tpu_torch.ops.flash_attention import flash_attention_sharded
    from maxtext_indextts2_tpu_torch.parallel import comm, create_device_mesh, shard

    mesh = create_device_mesh(_cfg(cfg_args), device="cpu")
    out = []
    for algorithm, inputs, kwargs in cases:
        local = {k: shard(torch.from_numpy(np.array(v)), "activation_batch",
                          "activation_length", mesh=mesh) for k, v in inputs.items()}
        q, k, v = (local[n].clone().requires_grad_(True) for n in ("q", "k", "v"))
        comm.reset_stats()
        o = flash_attention_sharded(q, k, v, local["seg"], mesh=mesh, positions=local["pos"],
                                    algorithm=algorithm, **kwargs)
        o.backward(local["do"])
        out.append({"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
                    "calls": dict(comm.stats["calls"])})
    return out


# ------------------------------------------------------------- training


def train(cases, steps):
    """Each case (config args, weights, global batch; numpy): ``steps``
    train steps of the sharded state, each rank on its piece of the batch.
    Returns, a case, the history, the gathered parameters and moments (the
    one-rank names), the gather / reduction counts, this rank's piece bytes
    and the share of parameter bytes left whole."""
    from maxtext_indextts2_tpu_torch.parallel import create_device_mesh, fsdp
    from maxtext_indextts2_tpu_torch.parallel.sharding import assert_params_sufficiently_sharded
    from maxtext_indextts2_tpu_torch.train import train as ttrain

    out = []
    for cfg_args, weights, batch in cases:
        cfg = _cfg(cfg_args)
        mesh = create_device_mesh(cfg, device="cpu")
        state = ttrain.setup_train_state(cfg, "cpu", {k: torch.from_numpy(np.array(v))
                                                      for k, v in weights.items()}, mesh=mesh)
        tb = ttrain.local_batch(cfg, {k: torch.from_numpy(np.array(v))
                                      for k, v in batch.items()}, mesh)
        fsdp.stats.update(gathers=0, reductions=0, gather_seconds=0.0, reduce_seconds=0.0)
        history = [{k: float(v) for k, v in ttrain.train_step(cfg, state, tb).items()}
                   for _ in range(steps)]
        counts = {k: fsdp.stats[k] for k in ("gathers", "reductions")}
        view = ttrain.gathered_state(state)
        share = assert_params_sufficiently_sharded(
            state.plan.specs_with_bytes(state.shards), mesh, 1.0)
        out.append({"history": history, "params": view.params, "mu": view.opt_state.get("mu"),
                    "nu": view.opt_state.get("nu"), "count": view.opt_state.get("count"),
                    "counts": counts, "unsharded_share": share,
                    "piece_bytes": sum(t.numel() * t.element_size()
                                       for t in state.shards.values())})
    return out


def pipeline(cases):
    """Each case (config args, weights, tokens): the pipelined model's logits
    and the gradient of mean(logits**2) (the JAX pipeline test's loss),
    gathered to the one-rank names."""
    from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN
    from maxtext_indextts2_tpu_torch.parallel import comm, create_device_mesh
    from maxtext_indextts2_tpu_torch.train import train as ttrain

    out = []
    for cfg_args, weights, tokens in cases:
        cfg = _cfg(cfg_args)
        mesh = create_device_mesh(cfg, device="cpu")
        state = ttrain.setup_train_state(cfg, "cpu", {k: torch.from_numpy(np.array(v))
                                                      for k, v in weights.items()}, mesh=mesh)
        tok = torch.from_numpy(np.array(tokens))
        b, s = tok.shape
        pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
        seg = torch.ones((b, s), dtype=torch.int32)
        comm.reset_stats()
        state.plan.gather(state.shards, state.params)
        logits = state.model(tok, pos, seg, mode=MODE_TRAIN)
        loss = torch.mean(torch.square(logits.float()))
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        calls = dict(comm.stats["calls"])
        pieces = state.plan.reduce(dict(zip(names, grads)))
        out.append({"logits": logits.detach(), "grads": state.plan.full_state_dict(pieces),
                    "calls": calls, "units": list(state.model.decoder.unit_names)})
    return out


def elastic(cfg_args, fail_at: int, survivors: list[int]):
    """An elastic run whose ranks all fail once at step ``fail_at``, after
    which only ``survivors`` are alive: the resize continues from the
    snapshot. Returns the loop's result on this rank."""
    from maxtext_indextts2_tpu_torch.train.elastic import elastic_train_loop

    world = dist.get_world_size()
    failed = []

    def inject(step):
        if step == fail_at and not failed:
            failed.append(step)
            raise RuntimeError(f"injected failure at step {step}")

    def alive():
        return survivors if failed else list(range(world))

    return elastic_train_loop(_cfg(cfg_args), snapshot_period=2, failure_injector=inject,
                              devices_fn=alive, device="cpu")


def mesh_and_loop(cfg_args, ckpt_dir):
    """The mesh's layout on this rank (summary, DTensor placements, a piece
    of a batch, a multi-host batch) and the training entry point on the
    mesh: two steps with checkpoints, then a resume to four."""
    from maxtext_indextts2_tpu_torch.parallel import (
        create_device_mesh,
        logical_to_placements,
        mesh_shape_summary,
        shard,
    )
    from maxtext_indextts2_tpu_torch.train import train as ttrain
    from maxtext_indextts2_tpu_torch.train.data.multihost import MultiHostDataLoadIterator

    cfg = _cfg(cfg_args)
    mesh = create_device_mesh(cfg, device="cpu")
    rows = np.arange(2 * 8).reshape(2, 8)
    it = MultiHostDataLoadIterator(iter([{"inputs": rows}]), mesh, "cpu")
    out = {"summary": mesh_shape_summary(mesh), "rank": mesh.rank, "coords": mesh.coords,
           "placements": [repr(p) for p in logical_to_placements(("embed", "mlp"), mesh)],
           "piece": shard(torch.arange(4 * 8).reshape(4, 8), "activation_batch",
                          "activation_length", mesh=mesh),
           "multihost": next(it)["inputs"]}
    extra = dict(enable_checkpointing=True, checkpoint_dir=ckpt_dir, checkpoint_period=2,
                 async_checkpointing=False)
    first = ttrain.train_loop(_cfg(list(cfg_args) + ["steps=2"] + [f"{k}={v}" for k, v in
                                                                  extra.items()]),
                              device="cpu", quiet=True)
    resumed = ttrain.train_loop(_cfg(list(cfg_args) + ["steps=4"] + [f"{k}={v}" for k, v in
                                                                    extra.items()]),
                                device="cpu", quiet=True)
    out["losses"] = [h["loss"] for h in first["history"] + resumed["history"]]
    return out


# ------------------------------------------------ splits inside the layers


def serve(cases):
    """Each case (config args, weights, prompts, steps): an engine on the
    mesh of the config with the whole weights. Returns, a case, the greedy
    stream of each prompt, the first tokens and ``steps`` tokens of the first
    two prompts decoding together in slots 0 and 1, the teacher-forced
    (gathered) logits of the first prompt's stream, the decode captures,
    the collectives of the streams, and the shapes of a decode cache."""
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.models.attention import MODE_PREFILL
    from maxtext_indextts2_tpu_torch.parallel import comm, create_device_mesh

    out = []
    for cfg_args, weights, prompts, steps in cases:
        cfg = _cfg(cfg_args)
        mesh = create_device_mesh(cfg, device="cpu")
        eng = Engine(cfg, device="cpu", mesh=mesh)
        eng.set_params({k: torch.from_numpy(np.array(v)) for k, v in weights.items()})
        comm.reset_stats()
        streams = [eng.generate_stream(p, steps) for p in prompts]
        calls = dict(comm.stats["calls"])
        k = min(2, len(prompts))
        state, first = eng.prefill_insert_many(eng.init_decode_state(), list(prompts[:k]),
                                               list(range(k)))
        state, toks = eng.generate_n(state, steps)
        full = np.concatenate([prompts[0], np.array(streams[0][:-1], np.int32)])
        t = torch.as_tensor(full)[None]
        pos = torch.arange(t.shape[1], dtype=torch.int32)[None]
        with torch.no_grad():
            logits = eng.model(t, pos, torch.ones_like(t), mode=MODE_PREFILL,
                               cache=eng.model.init_cache(1, t.shape[1], "cpu"))
        cache = state["cache"][0][0]
        shapes = {name: tuple(getattr(cache, name).shape)
                  for name in ("key_pages", "cached_key", "cached_ckv") if hasattr(cache, name)}
        out.append({"streams": streams, "first": first.numpy(), "multi": toks[:, :k].numpy(),
                    "logits": logits[0].numpy(), "captures": eng.graphs.captures,
                    "calls": calls, "shapes": shapes})
    return out


def seeded(cases):
    """Each case (config args with a mesh): the engine on that mesh with its
    seeded weights (``load_params`` without a path) against the one-rank
    engine's seeded weights, each cut to this rank's piece. Returns, a case,
    the names whose pieces differ and the bytes of the rank's parameters and
    of the one-rank engine's."""
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.parallel import create_device_mesh

    out = []
    for cfg_args in cases:
        cfg = _cfg(cfg_args)
        eng = Engine(cfg, device="cpu", mesh=create_device_mesh(cfg, device="cpu"))
        got = eng.load_params()
        one = Engine(cfg, device="cpu")
        whole = one.load_params()
        out.append({"differ": sorted(n for n, w in whole.items()
                                     if not torch.equal(got[n], eng._piece(n, w))),
                    "bytes": sum(t.numel() * t.element_size() for t in got.values()),
                    "one_rank_bytes": sum(t.numel() * t.element_size()
                                          for t in whole.values())})
    return out


def collectives(cases):
    """Each case (input [n, ...] numpy, gradient [n, ...] numpy): on group
    rank r, row r goes through each autograd collective of the tensor and
    expert splits. Returns, a case, their outputs and input gradients."""
    from maxtext_indextts2_tpu_torch.parallel import comm

    group = dist.group.WORLD
    rank, world = dist.get_rank(), dist.get_world_size()
    out = []
    for x, g in cases:
        res = {}
        for name in ("f", "g"):
            xr = torch.from_numpy(np.array(x[rank])).requires_grad_(True)
            y = comm.copy_to_group(xr, group) if name == "f" else \
                comm.reduce_from_group(xr, group, xr.dtype)
            y.backward(torch.from_numpy(np.array(g[rank])))
            res[name] = (y.detach(), xr.grad)
        # rank r sends r + 1 rows to rank 0 and one row to every other rank
        sends = [rank + 1 if j == 0 else 1 for j in range(world)]
        recvs = [j + 1 if rank == 0 else 1 for j in range(world)]
        rows = torch.from_numpy(np.array(x[rank]))[:sum(sends)].clone().requires_grad_(True)
        y = comm.AllToAllV.apply(rows, group, sends, recvs)
        y.backward(torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape))
        res["all_to_all_v"] = (y.detach(), rows.grad, sends, recvs)
        res["all_to_all"] = comm.all_to_all(torch.from_numpy(np.array(x[rank])), group, 0, 0)
        out.append(res)
    return out


def moe(cases):
    """Each case (config args, weights, global tokens, steps): the MoE
    model's serving forward on the mesh (every rank the whole batch) and
    ``steps`` train steps of its sharded state on the global batch. Returns,
    a case, the forward's logits and the step history with the gathered
    parameters."""
    from maxtext_indextts2_tpu_torch.infer.engine import Engine
    from maxtext_indextts2_tpu_torch.models.attention import MODE_PREFILL
    from maxtext_indextts2_tpu_torch.parallel import comm, create_device_mesh
    from maxtext_indextts2_tpu_torch.train import train as ttrain

    out = []
    for cfg_args, weights, batch, steps in cases:
        cfg = _cfg(cfg_args)
        mesh = create_device_mesh(cfg, device="cpu")
        eng = Engine(cfg, device="cpu", mesh=mesh)
        whole = {k: torch.from_numpy(np.array(v)) for k, v in weights.items()}
        eng.set_params(whole)
        t = torch.from_numpy(np.array(batch["inputs"]))
        comm.reset_stats()
        with torch.no_grad():
            logits = eng.model(t, torch.from_numpy(np.array(batch["inputs_position"])),
                               torch.ones_like(t), mode=MODE_PREFILL,
                               cache=eng.model.init_cache(t.shape[0], t.shape[1], "cpu"))
        calls = dict(comm.stats["calls"])
        state = ttrain.setup_train_state(cfg, "cpu", whole, mesh=mesh)
        tb = ttrain.local_batch(cfg, {k: torch.from_numpy(np.array(v))
                                      for k, v in batch.items()}, mesh)
        history = [{k: float(v) for k, v in ttrain.train_step(cfg, state, tb).items()}
                   for _ in range(steps)]
        out.append({"logits": logits.numpy(), "calls": calls, "history": history,
                    "params": ttrain.gathered_state(state).params})
    return out


def several(calls):
    """Each (body name, args) of ``calls`` in turn, in one spawn of the
    ranks: the results in order."""
    return [globals()[body](*args) for body, args in calls]


def pipeline_split(cases):
    """Each case (config args, weights, tokens): the pipelined model under a
    tensor split, its logits gathered over the vocabulary and the gradient
    of mean(logits**2) (each rank's share of the sum over its vocabulary
    slice), gathered to the one-rank names."""
    from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN
    from maxtext_indextts2_tpu_torch.parallel import comm, create_device_mesh
    from maxtext_indextts2_tpu_torch.train import train as ttrain

    out = []
    for cfg_args, weights, tokens in cases:
        cfg = _cfg(cfg_args)
        mesh = create_device_mesh(cfg, device="cpu")
        state = ttrain.setup_train_state(cfg, "cpu", {k: torch.from_numpy(np.array(v))
                                                      for k, v in weights.items()}, mesh=mesh)
        tok = torch.from_numpy(np.array(tokens))
        b, s = tok.shape
        pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
        seg = torch.ones((b, s), dtype=torch.int32)
        state.plan.gather(state.shards, state.params)
        logits = state.model(tok, pos, seg, mode=MODE_TRAIN)  # this rank's vocabulary slice
        loss = torch.sum(torch.square(logits.float())) / (logits.numel() * state.model.tp.size)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        pieces = state.plan.reduce(dict(zip(names, grads)))
        whole = comm.all_gather(logits.detach(), state.model.tp.group, logits.ndim - 1)
        out.append({"logits": whole, "grads": state.plan.full_state_dict(pieces),
                    "units": list(state.model.decoder.unit_names)})
    return out
