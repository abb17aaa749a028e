"""Pipeline parallelism: decoder units over the ``stage`` ranks.

Counterpart of the JAX package's ``models/pipeline.py``. The decoder's units
(one ``DecoderLayer`` of ``len(attention_pattern)`` sub-layers each) are laid
out stage-major as in the JAX package, u = s*R + r for stage s and repeat r
of S stages and R = ``num_pipeline_repeats``; unit u runs as layer r*S + s
of the unpipelined decoder, so the port names it ``layers_{r*S+s}`` and a
state dict is the one-rank state dict. Rank s of the ``stage`` group holds
its R units (``Decoder.keep_stage_units``).

The schedule is the JAX package's: M*R + d*(S-1) iterations, stage s running
microbatch (i - d*s) mod M of repeat (i - d*s) div M at iteration i (a bubble
iteration runs nothing), with d = 2 under
``pipeline_delay_activation_forwarding``. Activations ``[mb, L, E]`` cross to
the next stage by send and receive; the last stage's output of a repeat
before the last goes back to stage 0 (the JAX package's circular storage),
and the last repeat's is the microbatch's output. Every stage rank runs the
embedding and the head on the same batch, so the outputs are broadcast from
the last stage and the input gradient from the first.

The backward runs the schedule in reverse with an explicit recompute: each
stage keeps its units' inputs from the forward, recomputes one unit at a
time under autograd, and sends the input's gradient to the stage before.
As in the JAX package the decoder is pipelined only in training, and the
MoE load-balance loss is dropped inside the pipelined region.
"""

from __future__ import annotations

import torch

from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN
from maxtext_indextts2_tpu_torch.parallel import comm


class PipelineRun:
    """One pipelined forward of a region: the schedule, its units and what
    the backward needs."""

    def __init__(self, units, group, stages: int, repeats: int, microbatches: int,
                 delay: int, positions, segment_ids, impl):
        self.units, self.group = units, group
        self.S, self.R, self.M, self.d = stages, repeats, microbatches, delay
        self.s = comm.group_rank(group)
        self.positions, self.segment_ids, self.impl = positions, segment_ids, impl
        self.inputs: dict[int, torch.Tensor] = {}

    @property
    def iterations(self) -> int:
        return self.M * self.R + self.d * (self.S - 1)

    def virt(self, i: int) -> int | None:
        """The (microbatch, repeat) index of this stage at iteration i."""
        v = i - self.d * self.s
        return v if 0 <= v < self.M * self.R else None

    def run_unit(self, v: int, x):
        m, r = v % self.M, v // self.M
        pos = self.positions.reshape(self.M, -1, self.positions.shape[-1])[m]
        seg = self.segment_ids.reshape(self.M, -1, self.segment_ids.shape[-1])[m]
        return self.units[r](x, pos, seg, MODE_TRAIN, None, self.impl, None)


_BACKWARD_TAG = 1 << 20


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: PipelineRun, x, *params):
        ctx.run = run
        S, M, R, s = run.S, run.M, run.R, run.s
        x_mb = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        outputs = torch.zeros_like(x_mb)
        pending = []
        for i in range(run.iterations):
            v = run.virt(i)
            if v is None:
                continue
            m, r = v % M, v // M
            if s == 0:
                inp = x_mb[m] if r == 0 else comm.recv(x_mb[m], run.group, S - 1, tag=v - M)
            else:
                inp = comm.recv(x_mb[m], run.group, s - 1, tag=v)
            run.inputs[v] = inp
            out = run.run_unit(v, inp)
            if s < S - 1:
                pending.append(comm.isend(out, run.group, s + 1, tag=v))
            elif r < R - 1:
                pending.append(comm.isend(out, run.group, 0, tag=v))
            else:
                outputs[m] = out
        for p in pending:
            p.wait()
        return comm.broadcast(outputs, run.group, S - 1).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        run = ctx.run
        S, M, R, s = run.S, run.M, run.R, run.s
        g_mb = g.reshape(M, g.shape[0] // M, *g.shape[1:])
        unit_params = [list(u.parameters()) for u in run.units]
        grads = [[torch.zeros_like(p) for p in ps] for ps in unit_params]
        dx = torch.zeros_like(g_mb)
        pending = []
        for i in reversed(range(run.iterations)):
            v = run.virt(i)
            if v is None:
                continue
            m, r = v % M, v // M
            if s < S - 1:
                g_out = comm.recv(g_mb[m], run.group, s + 1, tag=_BACKWARD_TAG + v)
            elif r < R - 1:
                g_out = comm.recv(g_mb[m], run.group, 0, tag=_BACKWARD_TAG + v)
            else:
                g_out = g_mb[m]
            with torch.enable_grad():
                inp = run.inputs.pop(v).detach().requires_grad_(True)
                out = run.run_unit(v, inp)
                got = torch.autograd.grad(out, [inp] + unit_params[r], g_out, allow_unused=True)
            for acc, gp in zip(grads[r], got[1:]):
                if gp is not None:
                    acc.add_(gp)
            if s > 0:
                pending.append(comm.isend(got[0], run.group, s - 1, tag=_BACKWARD_TAG + v))
            elif r > 0:
                pending.append(comm.isend(got[0], run.group, S - 1, tag=_BACKWARD_TAG + v - M))
            else:
                dx[m] = got[0]
        for p in pending:
            p.wait()
        dx = comm.broadcast(dx, run.group, 0).reshape(g.shape)
        return (None, dx, *[gp for ps in grads for gp in ps])


def pipeline_forward(units, group, cfg, x, positions, segment_ids, impl=None):
    """The pipelined region: ``units`` are this stage's, in repeat order."""
    stages = comm.group_size(group)
    repeats, micro = cfg.num_pipeline_repeats, cfg.num_pipeline_microbatches
    if len(units) != repeats:
        raise ValueError(f"stage holds {len(units)} units, the pipeline needs "
                         f"num_pipeline_repeats={repeats}")
    if x.shape[0] % micro:
        raise ValueError(f"batch {x.shape[0]} must divide into {micro} microbatches")
    run = PipelineRun(units, group, stages, repeats, micro,
                      2 if cfg.pipeline_delay_activation_forwarding else 1,
                      positions, segment_ids, impl)
    params = [p for u in units for p in u.parameters()]
    return _Pipeline.apply(run, x, *params)
