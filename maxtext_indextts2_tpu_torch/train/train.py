"""Training runtime: train state, train / eval step, train loop, CLI.

Counterpart of the JAX package's ``train/train.py`` on one device: the
model's forward in ``MODE_TRAIN`` (flash attention K9-K11 and the remat
policy of ``models/decoder.py``), masked cross-entropy with z-loss (or, with
``fused_vocab_ce_chunk`` / ``fused_vocab_ce_tile``, the vocabulary-fused
variants of ``ops/losses.py``), the gradients by autograd, in-step gradient accumulation over microbatches,
global-norm clipping with the scale cast to each leaf's dtype, and the
optimizer of ``train/optimizers.py`` in optax's order. The parameters and
the optimizer's moments are updated in place.

Run: ``python -m maxtext_indextts2_tpu_torch.train.train <config.yml> key=value ...``
on the GPU; ``device=cpu`` asks for the CPU explicitly. Every
``dataset_type`` of the JAX package is taken (``synthetic``, ``emilia_audio``,
``grain``, ``c4_mlperf``, ``tfds``, ``hf``): the iterators yield numpy batches,
as the JAX package's do, and :class:`DeviceBatches` moves each to the state's
device as int32 tensors (the synthetic iterator's batch is made there once).
With ``enable_dropout`` and ``dropout_rate > 0`` each MLP's activation product
is dropped out in training (``models/layers.MlpDropout``): the step's masks
are an input of :func:`loss_fn` / :func:`train_step`, drawn by default from a
generator on the device seeded with ``seed`` and the step (:func:`step_dropout`).
``quantization=int8 | int8w | fp8`` trains through AQT's quantized products
(``ops/quantization.aqt_dot``); the stochastic-rounding noise of a step's
input gradients is an input too (:func:`step_aqt_noise`), and the MFU counts
the same FLOPs whatever the quantization, as the JAX package's does.
``lora_rank > 0`` with ``lora_only_training`` updates the ``lora_*`` weights
only (``train/optimizers.lora_only``). MoE models train (the sparse route
through the grouped products' backward kernels on the card, the dense einsum
route on the CPU), with the mean of the MoE sub-layers' load-balance losses
times ``load_balance_loss_weight`` added to the loss (``moe_lb_loss``), and
``mtp_num_layers > 0`` adds the multi-token-prediction loss times
``mtp_loss_scaling_factor`` (``mtp_loss``), as the JAX package's ``loss_fn``.
On several ranks (``torchrun``, or ``parallel/mesh.maybe_initialize_distributed``)
the step runs on the mesh of ``parallel/mesh.py``: the batch is split over
the ``activation_batch`` axes (and its sequence over ``context``, in the
load-balanced order, with ``ops/flash_attention.flash_attention_sharded``
running the attention), the parameters and the AdamW moments are split over
the axes that their logical names resolve to (``parallel/fsdp.py``: FSDP,
one unit the whole model), each rank's loss is its share of the global mean,
the gradients are summed over the batch ranks, and clipping takes the global
norm; the step equals the one-rank step on the same global batch.
``zero1_fsdp_ag_once`` gathers the weights once for all microbatches and
reduce-scatters their summed gradients once. Under ``tensor`` /
``autoregressive`` / ``tensor_sequence`` / ``expert`` the layers compute on their split
(``parallel/tensor.py``: heads, ``mlp`` and vocabulary, or experts) and the
loss is the vocabulary-parallel cross-entropy of the rank's logit slice; a
tensor-split weight's gradient is summed over the batch ranks only. With ``ici_stage_parallelism``
the decoder runs as a pipeline (``models/pipeline.py``). Metrics are logged
and checkpoints written by rank 0, from gathered state (the one-rank names).
``colocated_python_data_input`` runs the input pipeline in a spawned CPU
process (``train/data/colocated.py``).
``enable_checkpointing=true`` restores the newest checkpoint of
``checkpoint_dir`` before the loop and saves every ``checkpoint_period``
steps and at the end (``train/checkpointing.py``; the emergency two-tier
manager with ``enable_emergency_checkpoint``). As in the JAX package, the
data iterator's position is not part of a checkpoint.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from maxtext_indextts2_tpu_torch.config import Config, load_config
from maxtext_indextts2_tpu_torch.infer.engine import resolve_device
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.models.attention import MODE_TRAIN
from maxtext_indextts2_tpu_torch.models.decoder import _remat_policy
from maxtext_indextts2_tpu_torch.models.layers import MlpDropout, to_dtype
from maxtext_indextts2_tpu_torch.ops import losses
from maxtext_indextts2_tpu_torch.ops.quantization import AQT_MODES, AqtNoise
from maxtext_indextts2_tpu_torch.parallel import tensor
from maxtext_indextts2_tpu_torch.parallel.fsdp import ShardedParams
from maxtext_indextts2_tpu_torch.parallel.mesh import (
    check_executed_axes,
    create_device_mesh,
    maybe_initialize_distributed,
    world_size,
)
from maxtext_indextts2_tpu_torch.train import checkpointing
from maxtext_indextts2_tpu_torch.train.data.synthetic import SyntheticDataIterator
from maxtext_indextts2_tpu_torch.train.optimizers import (
    GradientTransformation,
    apply_updates,
    create_learning_rate_schedule,
    get_optimizer,
)
from maxtext_indextts2_tpu_torch.utils import flops as flops_lib
from maxtext_indextts2_tpu_torch.utils.metrics import MetricLogger


@dataclasses.dataclass
class TrainState:
    """Parameters (the model's own, ``requires_grad``), optimizer state and
    the number of steps taken."""

    step: int
    model: Transformer
    params: dict[str, torch.Tensor]
    opt_state: dict
    tx: GradientTransformation
    # on a mesh of several ranks: the sharding plan and this rank's pieces of
    # the parameters (the optimizer's state is over the pieces; ``params``
    # hold the full weights only between a gather and its release)
    mesh: Any = None
    plan: ShardedParams | None = None
    shards: dict[str, torch.Tensor] | None = None

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    @property
    def trained(self) -> dict[str, torch.Tensor]:
        """What the optimizer updates: the pieces on a mesh, else the parameters."""
        return self.params if self.plan is None else self.shards


def check_training_config(cfg: Config) -> None:
    """Raise on what this slice of the port does not train (before any
    weight is made); an unknown remat policy raises too."""
    if cfg.quantization == "int8w_serve":
        raise ValueError("quantization=int8w_serve is a serving structure: its int8 kernels "
                         "take no gradient (train with int8, int8w or fp8)")
    check_executed_axes(cfg)
    tensor.check_model(cfg)
    _remat_policy(cfg.remat_policy)
    if tensor.tensor_degree(cfg) > 1 and (cfg.fused_vocab_ce_chunk > 0
                                          or cfg.fused_vocab_ce_tile > 0):
        tensor.refuse("the vocabulary-fused cross-entropy under a tensor split")


def setup_train_state(cfg: Config, device=None, params: dict | None = None,
                      mesh=None) -> TrainState:
    """The model with seeded weights (``init_weights_seed``) or ``params``
    (a state dict, e.g. from ``utils/param_bridge.params_from_jax``), made
    trainable, and a fresh optimizer state. On a ``mesh`` of several ranks
    every rank makes the whole model from the same seed (or ``params``),
    keeps its stage's pipeline units and its pieces of each weight, and
    makes the optimizer's state over those pieces."""
    check_training_config(cfg)
    device = resolve_device(device)
    sharded = mesh is not None and mesh.size > 1
    model = Transformer(cfg, device=device)
    if params is None:
        model.init_params(cfg.init_weights_seed)
    else:
        model.load_state_dict(params, strict=True)
    units = frozenset()
    if sharded and mesh.shape["stage"] > 1:
        units = model.decoder.keep_stage_units(mesh)
    for p in model.parameters():
        p.requires_grad_(True)
    named = dict(model.named_parameters())
    tx = get_optimizer(cfg, create_learning_rate_schedule(cfg))
    plan = shards = None
    if sharded:
        plan = ShardedParams(named, mesh, cfg.emb_dim, units)
        shards = plan.shard_(named)
        tensor.split_model(model, mesh)
        for m in model.modules():
            if hasattr(m, "batch_group"):  # the MoE's load-balance loss: the global batch's
                m.batch_group = plan.batch_group
    with torch.no_grad():
        opt_state = tx.init(named if plan is None else shards)
    return TrainState(step=0, model=model, params=named, opt_state=opt_state, tx=tx,
                      mesh=mesh if sharded else None, plan=plan, shards=shards)


def fused_ce(model: Transformer, cfg: Config, y: torch.Tensor, targets: torch.Tensor,
             weights: torch.Tensor):
    """The vocabulary-fused CE of the JAX package's ``loss_fn`` over the
    final-normed hidden states ``y``: int8 when ``fused_ce_int8`` and
    ``fused_vocab_ce_chunk``, else streaming when ``fused_vocab_ce_tile``,
    else chunked. (mean_loss, total_weight)."""
    kernel, scale = model.unembedding_kernel()
    ldt = cfg.fused_ce_logits_dtype or None
    if cfg.fused_ce_int8 and cfg.fused_vocab_ce_chunk > 0:
        return losses.chunked_unembed_cross_entropy_int8(
            y, kernel, targets, weights, z_loss=cfg.z_loss_weight,
            chunk=cfg.fused_vocab_ce_chunk, soft_cap=cfg.final_logits_soft_cap, scale=scale,
            logits_dtype=ldt or "bfloat16")
    dt = torch.float32 if cfg.logits_dot_in_fp32 else to_dtype(cfg.dtype)
    if cfg.fused_vocab_ce_tile > 0:
        return losses.streaming_unembed_cross_entropy(
            y, kernel, targets, weights, z_loss=cfg.z_loss_weight,
            max_tile=cfg.fused_vocab_ce_tile, soft_cap=cfg.final_logits_soft_cap, scale=scale,
            compute_dtype=dt)
    return losses.chunked_unembed_cross_entropy(
        y, kernel, targets, weights, z_loss=cfg.z_loss_weight, chunk=cfg.fused_vocab_ce_chunk,
        soft_cap=cfg.final_logits_soft_cap, scale=scale, compute_dtype=dt, logits_dtype=ldt)


def step_dropout(cfg: Config, step: int, device) -> MlpDropout | None:
    """The MLP dropout of training step ``step`` (None when dropout is off):
    masks drawn from a generator on ``device`` seeded with ``seed`` and the
    step, as the JAX package's step draws from its key split off ``seed``."""
    if not (cfg.enable_dropout and cfg.dropout_rate > 0):
        return None
    seed = int(np.random.SeedSequence([cfg.seed, step]).generate_state(1)[0])
    return MlpDropout(cfg.dropout_rate,
                      generator=torch.Generator(device=device).manual_seed(seed))


def step_aqt_noise(cfg: Config, step: int, device) -> AqtNoise | None:
    """The stochastic-rounding noise of training step ``step``'s AQT input
    gradients (None when the config quantizes none): drawn from a generator
    on ``device`` seeded with ``seed`` and the step, as the JAX package's step
    folds its AQT key off its step key."""
    if cfg.quantization not in ("int8", "fp8"):
        return None
    seed = int(np.random.SeedSequence([cfg.seed, step, 1]).generate_state(1)[0])
    return AqtNoise(generator=torch.Generator(device=device).manual_seed(seed))


def loss_fn(model: Transformer, cfg: Config, batch: dict, is_train: bool = True,
            impl: str | None = None, dropout: MlpDropout | None = None,
            aqt_noise: AqtNoise | None = None):
    """(mean loss over valid tokens, aux) for one batch. In training with
    ``fused_vocab_ce_chunk`` or ``fused_vocab_ce_tile`` the logits are never
    materialised (:func:`fused_ce`); evaluation keeps the materialised CE,
    as in the JAX package. ``dropout``: the MLP dropout (training only).
    ``aqt_noise``: the AQT input gradients' noise, fixed before the forward
    and its remat regions run (None: PyTorch's default generator)."""
    fused = is_train and (cfg.fused_vocab_ce_chunk > 0 or cfg.fused_vocab_ce_tile > 0)
    if cfg.quantization in AQT_MODES:
        model.set_aqt_noise(aqt_noise)
    sown: dict = {}
    out = model(batch["inputs"], batch["inputs_position"], batch["inputs_segmentation"],
                mode=MODE_TRAIN, impl=impl, return_prelogits=fused,
                dropout=dropout if is_train else None,
                targets=batch["targets"] if cfg.mtp_num_layers > 0 else None, aux=sown)
    weights = (batch["targets_segmentation"] != 0).to(torch.float32)
    if fused:
        loss, total_weights = fused_ce(model, cfg, out, batch["targets"], weights)
    else:
        loss, total_weights = losses.masked_cross_entropy(out, batch["targets"], weights,
                                                          cfg.z_loss_weight, tp=model.tp)
    aux = {"ce_loss": loss, "total_weights": total_weights}
    # the auxiliary losses the JAX package sows: the mean of each MoE
    # sub-layer's load-balance loss, and the MTP loss, each times its weight
    if sown.get("moe_lb_loss"):
        moe_loss = torch.stack(sown["moe_lb_loss"]).mean() * cfg.load_balance_loss_weight
        loss = loss + moe_loss
        aux["moe_lb_loss"] = moe_loss
    if "mtp_loss" in sown:
        mtp_loss = sown["mtp_loss"] * cfg.mtp_loss_scaling_factor
        loss = loss + mtp_loss
        aux["mtp_loss"] = mtp_loss
    return loss, aux


def _grads(loss: torch.Tensor, leaves: list) -> list:
    """d loss / d leaf for every leaf; zeros for a leaf that no gradient
    reaches (a MoE router's selection bias: it picks the experts, and the
    JAX package's gradient of it is zero)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


def _clip_by_global_norm(grads: dict, max_norm: float):
    """The float32 scale cast to each leaf's dtype: bfloat16 grads stay bfloat16."""
    norm = _global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm


def train_step(cfg: Config, state: TrainState, batch: dict, impl: str | None = None,
               dropout=None, aqt_noise: AqtNoise | None = None) -> dict:
    """One optimizer step (with in-step gradient accumulation over
    ``gradient_accumulation_steps`` microbatches); updates ``state`` in place
    and returns the step's metrics as 0-d tensors. ``dropout``: the step's
    MLP dropout, one ``MlpDropout`` or one a microbatch (default, when the
    config turns dropout on: :func:`step_dropout`). ``aqt_noise``: the
    step's AQT noise (default :func:`step_aqt_noise`); microbatches draw on
    from its generator."""
    names = list(state.params)
    leaves = [state.params[n] for n in names]
    micro = cfg.gradient_accumulation_steps
    if aqt_noise is None:
        aqt_noise = step_aqt_noise(cfg, state.step, state.device)
    if dropout is None:
        dropout = step_dropout(cfg, state.step, state.device)
    if not isinstance(dropout, (list, tuple)):
        dropout = [dropout] * micro
    if state.plan is not None:
        def loss_of(i, mb):
            loss, aux = loss_fn(state.model, cfg, mb, impl=impl, dropout=dropout[i],
                                aqt_noise=aqt_noise)
            return loss, aux["total_weights"]

        loss, grads = sharded_grads(cfg, state, _microbatches(batch, micro), loss_of,
                                    lambda mb: _token_weight(mb))
        return apply_gradients(cfg, state, grads, {"loss": loss, "ce_loss": loss})
    if micro > 1:
        grads = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=state.device)
        for i in range(micro):
            mb = {k: v.reshape(micro, v.shape[0] // micro, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, _ = loss_fn(state.model, cfg, mb, impl=impl, dropout=dropout[i],
                              aqt_noise=aqt_noise)
            g = _grads(loss, leaves)
            with torch.no_grad():
                grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
                loss_sum = loss_sum + loss.detach()
        with torch.no_grad():
            grads = {n: g / torch.tensor(micro, dtype=g.dtype) for n, g in zip(names, grads)}
            loss = loss_sum / micro
        aux = {"ce_loss": loss}
    else:
        loss, aux = loss_fn(state.model, cfg, batch, impl=impl, dropout=dropout[0],
                            aqt_noise=aqt_noise)
        grads = dict(zip(names, _grads(loss, leaves)))
        loss = loss.detach()
        aux = {k: v.detach() for k, v in aux.items() if k != "total_weights"}

    return apply_gradients(cfg, state, grads, {"loss": loss, **aux})


def apply_gradients(cfg: Config, state: TrainState, grads: dict, metrics: dict,
                    clip: bool = True) -> dict:
    """Clip by the global norm (where ``clip``), update in optax's order,
    count the step; returns ``metrics`` with ``grad_norm`` and
    ``param_norm``. On a mesh the gradients are of this rank's pieces and
    the norms are global."""
    plan = state.plan

    def norm(tensors: dict):
        return _global_norm(tensors.values()) if plan is None else plan.global_norm(tensors)

    with torch.no_grad():
        grad_norm = norm(grads)
        # ``grads`` is changed in place and emptied: the caller's dict holds
        # no second copy of the gradients through the update
        if clip and cfg.gradient_clipping_threshold > 0:
            scale = torch.clamp(cfg.gradient_clipping_threshold / torch.clamp(grad_norm, min=1e-12),
                                max=1.0)
            for n in list(grads):
                grads[n] = grads[n] * scale.to(grads[n].dtype)
        updates, state.opt_state = state.tx.update(grads, state.opt_state, state.trained)
        grads.clear()
        apply_updates(state.trained, updates)
        del updates
        state.step += 1
        return {"loss": metrics.pop("loss"), "grad_norm": grad_norm,
                "param_norm": norm(state.trained), **metrics}


def _microbatches(batch: dict, micro: int) -> list[dict]:
    if micro == 1:
        return [batch]
    return [{k: v.reshape(micro, v.shape[0] // micro, *v.shape[1:])[i] for k, v in batch.items()}
            for i in range(micro)]


def _token_weight(mb: dict) -> torch.Tensor:
    return (mb["targets_segmentation"] != 0).sum().to(torch.float32)


def sharded_grads(cfg: Config, state: TrainState, microbatches: list[dict], loss_of, weight_of):
    """(the global mean loss, the mean gradients of this rank's pieces) over
    ``microbatches`` on the mesh. ``loss_of(i, mb)``: this rank's (mean loss,
    its weight) of microbatch i; ``weight_of(mb)``: its weight before the
    forward. Each rank's loss counts with its share of the microbatch's
    global weight, so the gradients summed over the batch ranks are those of
    the global mean. Without ``zero1_fsdp_ag_once`` each microbatch gathers
    the weights and reduce-scatters its gradients; with it, once a step."""
    plan, micro = state.plan, len(microbatches)
    names = list(state.params)
    once = cfg.zero1_fsdp_ag_once
    totals = [plan.batch_sum(weight_of(mb)) for mb in microbatches]
    pieces, full = None, None
    loss_sum = torch.zeros((), dtype=torch.float32, device=state.device)
    if once:
        plan.gather(state.shards, state.params)
    for i, mb in enumerate(microbatches):
        if not once:
            plan.gather(state.shards, state.params)
        loss, weight = loss_of(i, mb)
        share = loss * (weight / torch.clamp(totals[i], min=1e-6))
        g = _grads(share, [state.params[n] for n in names])
        with torch.no_grad():
            loss_sum = loss_sum + plan.batch_sum(share.detach())
            if once:
                full = g if full is None else [a + b for a, b in zip(full, g)]
            else:
                plan.release(state.params)
                r = plan.reduce(dict(zip(names, g)))
                pieces = r if pieces is None else {n: pieces[n] + r[n] for n in names}
        del g
    with torch.no_grad():
        if once:
            plan.release(state.params)
            pieces = plan.reduce(dict(zip(names, full)))
        if micro > 1:
            pieces = {n: g / torch.tensor(micro, dtype=g.dtype) for n, g in pieces.items()}
        return loss_sum / micro, pieces


def eval_step(cfg: Config, state: TrainState, batch: dict) -> dict:
    """The eval loss of ``batch`` (on a mesh: of the global batch whose piece
    it is, with the weights gathered around it)."""
    with torch.no_grad():
        if state.plan is not None:
            state.plan.gather(state.shards, state.params)
        loss, aux = loss_fn(state.model, cfg, batch, is_train=False)
        weight = aux["total_weights"]
        if state.plan is not None:
            state.plan.release(state.params)
            total = state.plan.batch_sum(weight)
            loss, weight = state.plan.batch_sum(loss * weight) / total, total
    return {"eval_loss": loss, "eval_total_weights": weight}


def local_batch(cfg: Config, batch: dict, mesh, micro: int | None = None) -> dict:
    """This rank's piece of a global batch: rows split over the
    ``activation_batch`` axes within each microbatch (so that a rank's
    microbatch i is its piece of the global microbatch i), the sequence over
    ``activation_length`` after the load-balanced reorder of context
    parallelism (as the JAX train loop reorders)."""
    if mesh is None or mesh.size == 1:
        return batch
    from maxtext_indextts2_tpu_torch.ops.flash_attention import load_balanced_reorder
    from maxtext_indextts2_tpu_torch.parallel.sharding import shard

    cp = mesh.shape["context"]
    reorder = cp > 1 and cfg.context_parallel_load_balance and cfg.attention != "dot_product"
    micro = cfg.gradient_accumulation_steps if micro is None else micro
    out = {}
    for k, v in batch.items():
        if reorder:
            v = load_balanced_reorder(v, cp, axis=1)
        v = v.reshape(micro, v.shape[0] // micro, *v.shape[1:])
        v = shard(v, None, "activation_batch", "activation_length", mesh=mesh)
        out[k] = v.reshape(-1, *v.shape[2:])
    return out


def gathered_state(state: TrainState):
    """A one-rank view of a sharded state (full parameters and moments under
    their one-rank names, on the CPU), gathered on every rank: what a
    checkpoint holds."""
    import types

    plan = state.plan
    opt = dict(state.opt_state)
    for key in ("mu", "nu"):
        if key in opt:
            opt[key] = plan.full_state_dict(opt[key])
    return types.SimpleNamespace(params=plan.full_state_dict(state.shards), opt_state=opt,
                                 step=state.step)


@torch.no_grad()
def load_gathered_state(state: TrainState, view) -> None:
    """Take this rank's pieces of a one-rank view into ``state`` in place."""
    plan = state.plan
    for name, t in state.shards.items():
        t.copy_(plan.local(name, view.params[name]))
    for key in ("mu", "nu"):
        if key in state.opt_state:
            for name, t in state.opt_state[key].items():
                t.copy_(plan.local(name, view.opt_state[key][name]))
    if "count" in state.opt_state:
        state.opt_state["count"] = view.opt_state["count"]
    state.step = view.step


class DeviceBatches:
    """A numpy batch iterator whose batches arrive on ``device`` as int32
    tensors, the dtype of :class:`SyntheticDataIterator`'s. ``get_state`` /
    ``set_state`` reach the wrapped iterator where it has them (grain)."""

    def __init__(self, source, device):
        self.source, self.device = source, torch.device(device)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32)).to(self.device)
                for k, v in next(self.source).items()}

    def get_state(self):
        return self.source.get_state()

    def set_state(self, state):
        self.source.set_state(state)


def make_host_iterator(cfg: Config):
    """The numpy batch iterator of ``cfg.dataset_type`` (every type but
    ``synthetic``), as the JAX package's ``create_data_iterator`` builds it."""
    if cfg.dataset_type == "emilia_audio":
        from maxtext_indextts2_tpu_torch.train.data.audio_iterator import (
            make_emilia_audio_train_iterator,
        )

        return make_emilia_audio_train_iterator(cfg)
    if cfg.dataset_type == "hf":
        from maxtext_indextts2_tpu_torch.train.data.hf_pipeline import make_hf_iterator

        return make_hf_iterator(cfg)
    if cfg.dataset_type == "grain":
        from maxtext_indextts2_tpu_torch.train.data.grain_pipeline import make_grain_iterator

        return make_grain_iterator(cfg)
    if cfg.dataset_type == "tfds":
        from maxtext_indextts2_tpu_torch.train.data.tfds_pipeline import make_tfds_iterator

        return make_tfds_iterator(cfg)
    if cfg.dataset_type == "c4_mlperf":
        from maxtext_indextts2_tpu_torch.train.data.mlperf_pipeline import (
            make_c4_mlperf_iterator,
        )

        return make_c4_mlperf_iterator(cfg)
    raise ValueError(f"unknown dataset_type: {cfg.dataset_type}")


def create_data_iterator(cfg: Config, device):
    if cfg.colocated_python_data_input:
        from maxtext_indextts2_tpu_torch.train.data.colocated import ColocatedDataIterator

        return DeviceBatches(ColocatedDataIterator(cfg), device)
    if cfg.dataset_type == "synthetic":
        return SyntheticDataIterator(cfg, device=device)
    return DeviceBatches(make_host_iterator(cfg), device)


def _take(batch: dict, n: int) -> dict:
    """The first ``n`` rows (the load / train remainder dropped)."""
    return {k: v[:n] for k, v in batch.items()}


def run_eval(cfg: Config, state: TrainState, num_batches: int | None = None) -> dict:
    """Average eval loss over ``eval_steps`` batches: the emilia eval stream
    for ``dataset_type=emilia_audio``, else synthetic batches (as in the JAX
    package)."""
    n = num_batches or (cfg.eval_steps if cfg.eval_steps > 0 else 4)
    if cfg.dataset_type == "emilia_audio":
        from maxtext_indextts2_tpu_torch.train.data.audio_iterator import (
            make_emilia_audio_eval_iterator,
        )

        eval_iter = DeviceBatches(make_emilia_audio_eval_iterator(cfg), state.device)
    else:
        eval_iter = SyntheticDataIterator(cfg, cfg.global_batch_size_to_eval_on,
                                          device=state.device)
    total, weight = 0.0, 0.0
    for _ in range(n):
        batch = _take(next(eval_iter), cfg.global_batch_size_to_eval_on)
        m = eval_step(cfg, state, local_batch(cfg, batch, state.mesh, micro=1))
        total += float(m["eval_loss"]) * float(m["eval_total_weights"])
        weight += float(m["eval_total_weights"])
    return {"eval_loss": total / max(weight, 1e-9), "eval_weight": weight}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_checkpointer(cfg: Config):
    """(checkpoint manager or None, save period): the emergency manager's
    period is its local tier's, and it routes each save to the tiers due."""
    if not cfg.enable_checkpointing:
        return None, cfg.checkpoint_period
    if cfg.enable_emergency_checkpoint:
        manager = checkpointing.EmergencyCheckpointManager(cfg)
        return manager, manager.local_period
    return checkpointing.CheckpointManager(cfg), cfg.checkpoint_period


def world_mesh(cfg: Config, device=None):
    """(the mesh, this rank's device) of a run launched on several ranks
    (``torchrun``: the process group is joined here); (None, ``device``) on one."""
    if world_size() == 1:
        return None, device
    device = maybe_initialize_distributed(cfg, device)
    return create_device_mesh(cfg, device), device


def _save(checkpointer, step: int, state: TrainState, final: bool, rank0: bool) -> None:
    """Save ``state`` (gathered on every rank of a mesh; rank 0 writes)."""
    view = state if state.plan is None else gathered_state(state)
    if rank0:
        checkpointer.save(step, view, force=final)


def _restore(checkpointer, state: TrainState) -> None:
    if state.plan is None:
        checkpointer.maybe_restore(state)
        return
    view = gathered_state(state)  # every rank reads the one-rank checkpoint
    if checkpointer.maybe_restore(view) is not None:
        load_gathered_state(state, view)


def train_loop(cfg: Config, device=None, quiet: bool = False) -> dict[str, Any]:
    """Runs from the restored step (or 0) to ``cfg.steps``; returns the last
    step's metrics (floats) and, under ``history``, every step's logged
    scalars."""
    mesh, device = world_mesh(cfg, device)
    state = setup_train_state(cfg, device, mesh=mesh)
    rank0 = state.mesh is None or state.mesh.rank == 0
    data_iter = create_data_iterator(cfg, state.device)
    checkpointer, save_period = make_checkpointer(cfg)
    if checkpointer is not None:
        _restore(checkpointer, state)
    if not rank0:  # rank 0 logs
        cfg_log, quiet = dataclasses.replace(cfg, metrics_file="", enable_tensorboard=False), True
    logger = MetricLogger(cfg if rank0 else cfg_log, quiet=quiet)
    step_tflops = flops_lib.training_tflops_per_step(cfg)
    tokens = cfg.global_batch_size_to_train_on * cfg.max_target_length
    history, metrics = [], {}
    try:
        _sync(state.device)
        last = time.perf_counter()
        for step in range(state.step, cfg.steps):
            batch = _take(next(data_iter), cfg.global_batch_size_to_train_on)
            metrics = train_step(cfg, state, local_batch(cfg, batch, state.mesh))
            _sync(state.device)
            now = time.perf_counter()
            history.append(logger.write_step(step, metrics, step_time=now - last,
                                             tflops_per_step=step_tflops,
                                             tokens_per_step=tokens))
            last = now
            final = cfg.save_final_checkpoint and step == cfg.steps - 1
            if checkpointer is not None and ((step + 1) % save_period == 0 or final):
                # forced on the final step: the emergency manager then writes
                # the durable tier even off its cadence
                _save(checkpointer, step, state, final, rank0)
            if cfg.eval_interval > 0 and (step + 1) % cfg.eval_interval == 0:
                eval_metrics = run_eval(cfg, state)
                logger.write_step(step, eval_metrics, step_time=0.0)
                target = cfg.target_eval_loss
                if target > 0 and eval_metrics["eval_loss"] <= target:
                    if not quiet:
                        print(f"target_eval_loss {target} reached at step {step}; stopping")
                    break
                last = time.perf_counter()
    finally:
        logger.close()
        if checkpointer is not None:
            checkpointer.close()
    out = {k: float(v) for k, v in metrics.items()}
    out["history"] = history
    return out


def main(argv=None):
    import sys

    from maxtext_indextts2_tpu_torch.infer.server import split_device_arg

    argv = list(sys.argv[1:] if argv is None else argv)
    argv, device = split_device_arg(argv)
    cfg = load_config(argv)
    metrics = train_loop(cfg, device=device)
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_rank() == 0:
        print({k: v for k, v in metrics.items() if k != "history"})
    return metrics


if __name__ == "__main__":
    main()
