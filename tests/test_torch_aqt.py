"""The AQT matmuls of training (``quantization=int8 | int8w | fp8``) against
the JAX package, whose ``DenseGeneral`` runs AQT's ``config_v4`` on the CPU.

- The codes and scales of ``ops/quantization.aqt_quantize`` equal AQT's
  bitwise (int8, e4m3, e5m2; bfloat16 and float32 operands).
- ``DenseGeneral``'s forward and its input and kernel gradients equal JAX's
  (jitted, as the JAX package runs it) bitwise, given the same
  stochastic-rounding noise. JAX draws that noise from the module's key;
  :class:`JaxAqtNoise` captures it (a debug callback beside AQT's own draw,
  nothing in either package changed) and the port takes it as an input.
- Three training steps of a 2-layer float32 ``tts`` model against JAX's
  jitted ``train_step``, with the noise JAX drew, under sgd: its update is
  linear in the gradient, so the comparison reads the quantized gradients
  themselves (Adam would turn a near-zero gradient's last-bit difference into
  a whole step of either sign). The attention and the norms sum in other
  orders in the two frameworks, and a last-bit difference in a quantized
  operand moves a code at a rounding boundary by one step: 1/127 of its row's
  scale for int8, up to a quarter of the value for e5m2. Hence: loss within
  1e-4 (values ~6.8), grad_norm and param_norm within 2e-4 relative, and
  every parameter within 1e-4, all but 1 in 200 within 2e-6.
- The MFU counts the same FLOPs whatever the quantization.
"""

import dataclasses
import functools

import flax.linen.module as flax_module
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from aqt.jax.v2 import config as aqt_config
from aqt.jax.v2 import stochastic_rounding
from aqt.jax.v2.numerics import fp8_numerics
from torch_port_helpers import configs, jax_tree, numpy_weights

from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.models.layers import DenseGeneral as JaxDense
from maxtext_indextts2_tpu.ops.quantization import _aqt_cfg
from maxtext_indextts2_tpu.train import optimizers as joptim
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu.utils import flops as jflops
from maxtext_indextts2_tpu_torch.models.layers import DenseGeneral
from maxtext_indextts2_tpu_torch.ops import quantization as q
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.train.data import synthetic
from maxtext_indextts2_tpu_torch.utils import flops
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax

DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}
DIMS = (((1,), (0,)), ((), ()))  # x [M, K] . w [K, N]


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    if a.dtype in (ml_dtypes.float8_e4m3fn, ml_dtypes.float8_e5m2):
        return torch.from_numpy(a.view(np.uint8).copy())  # compared as bit patterns
    return torch.from_numpy(np.array(a))


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _key_bytes(key) -> tuple:
    data = key if key.dtype == np.uint32 else jax.random.key_data(key)
    return tuple(np.asarray(data).ravel().tolist())


class JaxAqtNoise:
    """The stochastic-rounding noise JAX's AQT draws for each quantized
    ``DenseGeneral``, by the port's module name. AQT splits each
    ``AqtDotGeneral``'s key into the input gradient's g key (``set_context``)
    and draws ``uniform(key) - 0.5`` (int8, ``JaxUniform``) or
    ``random.bits(key)`` masked (fp8, ``fp_mantissa_round``) with it in the
    backward. Debug callbacks beside both report the values; matching them
    by key gives each module its draw."""

    def __init__(self, monkeypatch):
        self.paths, self.draws = {}, {}
        set_context = aqt_config.set_context

        def recording_set_context(cfg, key, *args, **kwargs):
            if key is not None:
                module = flax_module._context.module_stack[-1]
                path = ".".join(module.path[:-1])  # the DenseGeneral holding this "aqt"
                g_key = jax.random.split(jax.random.split(key, 3)[1], 2)[0]
                jax.debug.callback(functools.partial(self._path, path), g_key)
            return set_context(cfg, key, *args, **kwargs)

        uniform = stochastic_rounding.JaxUniform.__call__

        def recording_uniform(obj, shape, key, noise_sharing_axes=()):
            noise = uniform(obj, shape, key, noise_sharing_axes)
            jax.debug.callback(self._draw, key, noise)
            return noise

        def recording_mantissa_round(x, mantissa_bits, key):
            # fp8_numerics.fp_mantissa_round, with its random bits reported
            word = jnp.uint16 if x.dtype == jnp.bfloat16 else jnp.uint32
            drop = jnp.finfo(x.dtype).nmant - mantissa_bits
            mask = word((1 << drop) - 1)
            bits = jax.random.bits(key, x.shape, word) & mask
            jax.debug.callback(self._draw, key, bits)
            xb = jax.lax.bitcast_convert_type(x, word) + bits
            return jax.lax.bitcast_convert_type(jax.lax.bitwise_and(xb, ~mask), x.dtype)

        monkeypatch.setattr(aqt_config, "set_context", recording_set_context)
        monkeypatch.setattr(stochastic_rounding.JaxUniform, "__call__", recording_uniform)
        monkeypatch.setattr(fp8_numerics, "fp_mantissa_round", recording_mantissa_round)

    def _path(self, path, key):
        self.paths[_key_bytes(key)] = path

    def _draw(self, key, value):
        value = np.asarray(value)
        self.draws[_key_bytes(key)] = value.astype(np.int32) if value.dtype.kind == "u" else value

    def by_name(self) -> dict[str, torch.Tensor]:
        out = {self.paths[k]: torch.from_numpy(np.array(v)) for k, v in self.draws.items()}
        assert len(out) == len(self.draws), "a draw whose module was not seen"
        return out


# ------------------------------------------------------------------ codes


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_aqt_codes_and_scales_equal_jax(mode, dtype):
    """AQT's forward quantizers (x a scale a row, the kernel a scale a
    column) and, for fp8, the e5m2 codes of the input gradient, jitted as the
    JAX package runs them: bitwise."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=(19, 72)) * rng.uniform(0.1, 4, size=(19, 1))).astype(jdt)
    w = jnp.asarray(rng.normal(size=(72, 40)) * 0.05).astype(jdt)
    x = x.at[3].set(0)  # an all-zero row: AQT scales it by 1
    import copy

    cfg = copy.deepcopy(_aqt_cfg(mode))
    cfg.fwd.dg_quantizer.init_calibration()
    _, res = jax.jit(lambda a, b: cfg.fwd(a, b, None, None, DIMS))(x, w)
    fwd = "int8" if mode == "int8" else "e4m3"
    got_x, sx = q.aqt_quantize(_t(x), 1, fwd)
    got_w, sw = q.aqt_quantize(_t(w), 0, fwd)
    for got, scale, side in ((got_x, sx, res.lhs), (got_w, sw, res.rhs)):
        np.testing.assert_array_equal(_bits(got), _bits(_t(side.mt.qx.qvalue)))
        np.testing.assert_array_equal(_bits(scale), _bits(_t(side.mt.qx.scale[0])))
    if mode == "fp8":
        dcfg = copy.deepcopy(_aqt_cfg("fp8"))
        dcfg.dlhs.dg_quantizer.init_calibration()
        dcfg.dlhs.dg_quantizer.lhs.numerics.stochastic_rounding = False
        _, res = jax.jit(lambda a, b: dcfg.dlhs(a, b, None, None, DIMS))(x, w)
        got, scale = q.aqt_quantize(_t(x), 1, "e5m2")
        np.testing.assert_array_equal(_bits(got), _bits(_t(res.lhs.mt.qx.qvalue)))
        np.testing.assert_array_equal(_bits(scale), _bits(_t(res.lhs.mt.qx.scale[0])))


# ------------------------------------------------------------- DenseGeneral


def _dense_pair(mode, dtype, features, in_shape, seed):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    axis = tuple(range(-len(in_shape), 0))
    kernel = (rng.normal(size=in_shape + features) * 0.1).astype(np.float32)
    jm = JaxDense(features=features, axis=axis, quantization=mode, dtype=jdt,
                  weight_dtype=jnp.float32)
    tm = DenseGeneral(in_shape, features, axis=axis, quantization=mode, dtype=tdt)
    with torch.no_grad():
        tm.kernel.copy_(torch.from_numpy(kernel))
    return jm, tm, kernel


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["int8", "int8w", "fp8"])
def test_dense_forward_and_gradients_equal_jax(mode, dtype, monkeypatch):
    """A [B, S, H, D] -> [E] projection (the attention's ``out``) and a
    [B, S, E] -> [H, D] one (``query``): output, input gradient and kernel
    gradient bitwise, JAX's noise fed to the port."""
    jdt, tdt = DTYPES[dtype]
    for features, in_shape, seed in (((24,), (4, 8), 2), ((4, 8), (24,), 3)):
        noise = JaxAqtNoise(monkeypatch)
        jm, tm, kernel = _dense_pair(mode, dtype, features, in_shape, seed)
        rng = np.random.default_rng(seed + 10)
        x = jnp.asarray(rng.normal(size=(3, 5) + in_shape) * 2).astype(jdt)
        ct = jnp.asarray(rng.normal(size=(3, 5) + features)).astype(jnp.float32)

        def loss(params, xx):
            y = jm.apply(params, xx, rngs={"params": jax.random.PRNGKey(seed)})
            return jnp.sum(y.astype(jnp.float32) * ct), y

        (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            {"params": {"kernel": jnp.asarray(kernel)}}, x)
        draws = noise.by_name()
        assert len(draws) == (0 if mode == "int8w" else 1)
        tm.aqt_noise = next(iter(draws.values()), None)
        tm.kernel.requires_grad_(True)
        tx = _t(x).requires_grad_(True)
        got = tm(tx)
        (got.float() * _t(ct)).sum().backward()
        np.testing.assert_array_equal(_bits(got.detach()), _bits(_t(want)))
        np.testing.assert_array_equal(_bits(tx.grad), _bits(_t(gx)))
        np.testing.assert_array_equal(tm.kernel.grad.numpy(), np.asarray(gp["params"]["kernel"]))


def test_int8_and_int8w_forwards_are_equal():
    """AQT's ``int8w`` quantizes the activations too (``config_v4(fwd_bits=8)``):
    its forward is ``int8``'s, bit for bit, in both packages; the two differ
    only in the input gradient (quantized and noised, or plain)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32)).to(torch.bfloat16)
    a, b = q.aqt_dot(x, w, "int8"), q.aqt_dot(x, w, "int8w")
    assert torch.equal(a, b) and not torch.equal(a, x @ w)
    jx, jw = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), \
        jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    outs = [JaxDense(features=16, quantization=m).apply({"params": {"kernel": jw}}, jx,
                                                         rngs={"params": jax.random.PRNGKey(0)})
            for m in ("int8", "int8w")]
    np.testing.assert_array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
    np.testing.assert_array_equal(_bits(a), _bits(_t(outs[0])))


def test_aqt_dot_refuses_what_aqt_does_not_take():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="unknown AQT"):
        q.aqt_dot(x, torch.zeros(8, 4), "int4")
    with pytest.raises(TypeError, match="one dtype"):
        q.aqt_dot(x, torch.zeros(8, 4, dtype=torch.bfloat16), "int8")


@pytest.mark.parametrize("codes,dtype", [("int8", torch.float32), ("e5m2", torch.bfloat16),
                                         ("e5m2", torch.float32)])
def test_drawn_noise_has_aqts_range(codes, dtype):
    g = torch.Generator().manual_seed(0)
    n = q.draw_noise(codes, (64, 64), dtype, "cpu", g)
    if codes == "int8":
        assert n.dtype == torch.float32 and -0.5 <= float(n.min()) and float(n.max()) < 0.5
    else:  # the mantissa bits e5m2 drops: 5 of bfloat16's 7, 21 of float32's 23
        drop = 5 if dtype == torch.bfloat16 else 21
        assert n.dtype == torch.int32 and int(n.min()) >= 0 and int(n.max()) < 1 << drop
        assert int(n.max()) >= 1 << (drop - 1)


# ---------------------------------------------------------------- training

TRAIN = ["max_target_length=32", "learning_rate=1e-3", "warmup_steps_fraction=0.2",
         "steps=5", "dataset_type=synthetic", "remat_policy=full", "attention=dot_product",
         "opt_type=sgd"]
ROWS, STEPS = 8, 3


@pytest.mark.parametrize("mode", ["int8", "int8w", "fp8"])
def test_quantized_train_steps_match_jax(mode, monkeypatch):
    cfg, jcfg = configs(TRAIN + [f"quantization={mode}"], slots=ROWS)
    weights = numpy_weights(cfg, seed=7)
    batch = {k: np.array(v) for k, v in synthetic.make_batch(cfg, 0, ROWS).items()}

    noise = JaxAqtNoise(monkeypatch)
    model = JaxTransformer(cfg=jcfg)
    tx = joptim.get_optimizer(jcfg, joptim.create_learning_rate_schedule(jcfg))
    jstate = jtrain.TrainState.create(apply_fn=model.apply, params=jax_tree(weights), tx=tx)
    step = jax.jit(functools.partial(jtrain.train_step, model, jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jhist = []
    for _ in range(STEPS):  # one key every step: JAX draws the same noise each time
        jstate, m = step(jstate, jbatch, jax.random.PRNGKey(0))
        jhist.append({k: float(v) for k, v in m.items()})
    draws = noise.by_name()
    quantized = [n for n, m in ttrain.Transformer(cfg, device="cpu").named_modules()
                 if isinstance(m, DenseGeneral) and m.quantization]
    assert sorted(draws) == ([] if mode == "int8w" else sorted(quantized))

    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    aqt_noise = q.AqtNoise(tensors=draws)
    thist = [{k: float(v) for k, v in ttrain.train_step(cfg, state, tbatch,
                                                         aqt_noise=aqt_noise).items()}
             for _ in range(STEPS)]
    for i, (got, want) in enumerate(zip(thist, jhist)):
        np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-4, rtol=0,
                                   err_msg=f"loss, step {i}")
        for key in ("grad_norm", "param_norm"):
            np.testing.assert_allclose(got[key], want[key], rtol=2e-4, err_msg=f"{key} {i}")
    assert thist[2]["loss"] < thist[1]["loss"]
    got = params_to_jax({k: v.detach() for k, v in state.params.items()})
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                       jstate.params)):
        node = got
        for p in path:
            node = node[p.key]
        diff = np.abs(node - leaf)
        what = "/".join(p.key for p in path)
        assert diff.max() <= 1e-4, (what, diff.max())
        assert (diff > 2e-6).mean() <= 5e-3, (what, int((diff > 2e-6).sum()))


def test_default_noise_is_seeded_by_step():
    """Without given noise a step draws from a generator seeded with ``seed``
    and the step: the same run twice gives the same losses, another seed
    others; int8w draws none."""
    cfg, _ = configs(TRAIN + ["quantization=int8"], slots=4)
    weights = {k: torch.from_numpy(v) for k, v in numpy_weights(cfg, seed=3).items()}
    batch = {k: torch.from_numpy(np.array(v)) for k, v in synthetic.make_batch(cfg, 0, 4).items()}

    def run(c):
        state = ttrain.setup_train_state(c, device="cpu", params=weights)
        return [float(ttrain.train_step(c, state, batch)["grad_norm"]) for _ in range(2)]

    first = run(cfg)
    assert run(cfg) == first
    assert run(dataclasses.replace(cfg, seed=cfg.seed + 1)) != first
    assert ttrain.step_aqt_noise(dataclasses.replace(cfg, quantization="int8w"), 0, "cpu") is None


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_mfu_counts_the_same_flops_whatever_the_quantization(mode):
    cfg, jcfg = configs(TRAIN, slots=4)
    qcfg, qjcfg = configs(TRAIN + [f"quantization={mode}"], slots=4)
    assert flops.training_tflops_per_step(qcfg) == flops.training_tflops_per_step(cfg)
    np.testing.assert_allclose(flops.training_tflops_per_step(qcfg),
                               jflops.training_tflops_per_step(qjcfg), rtol=1e-12)
