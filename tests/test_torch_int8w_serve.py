"""``int8w_serve``: int8 serving weights against the JAX package.

- ``quantize_params_for_serving``: the int8 codes and float32 scales of a
  whole model equal the JAX package's bitwise.
- ``int8w_matmul``'s plain version (the function the CUDA kernel computes)
  against the JAX ``DenseGeneral._serve_quantized`` (jitted, as the engine
  runs it) on the same int8 kernel, scales, bias and input: float32 within
  1e-6 relative of the output's largest entry (the frameworks sum in other
  orders); bfloat16 within one bfloat16 step (2**-8 relative) of the
  largest entry, since both round one float32 sum to bfloat16.
- The engine: prefill logits within 1e-5 and greedy streams token for token
  against the JAX engine holding the same quantized weights (float32
  model); ``checkpoint_is_quantized`` reads the port's offline quantizer's
  checkpoint back to the same weights and streams; ``serve_params_dtype``
  keeps the scales in float32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_helpers import TINY_TTS, JaxEngine, configs, jax_tree, numpy_weights, prompt

from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.models.layers import DenseGeneral as JaxDense
from maxtext_indextts2_tpu.ops.quantization import (
    quantize_params_for_serving as jax_quantize_params,
)
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.models import Transformer
from maxtext_indextts2_tpu_torch.models.layers import DenseGeneral
from maxtext_indextts2_tpu_torch.ops import int8w_matmul as iw
from maxtext_indextts2_tpu_torch.ops.quantization import quantize_params_for_serving
from maxtext_indextts2_tpu_torch.tools import quantize_checkpoint
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_from_jax

SERVE = ["decode_attention=ragged", "quantization=int8w_serve"]


def _jax_quantized(jcfg, weights):
    """The JAX engine's int8w_serve tree from float weights, as its
    ``load_params`` makes it."""
    model = JaxTransformer(cfg=dataclasses.replace(jcfg, scan_layers=False))
    dummy = jnp.zeros((1, 4), jnp.int32)
    abstract = jax.eval_shape(lambda r: model.init(r, dummy, dummy, dummy)["params"],
                              jax.random.PRNGKey(0))
    import flax.linen as nn

    return jax_quantize_params(jax_tree(weights), nn.meta.unbox(abstract))


def test_quantize_params_for_serving_equals_jax_bitwise():
    cfg, jcfg = configs(SERVE)
    float_cfg = dataclasses.replace(cfg, quantization="")
    weights = numpy_weights(float_cfg, seed=2)
    want = params_from_jax(jax.tree.map(np.asarray, _jax_quantized(jcfg, weights)))
    got = quantize_params_for_serving({k: torch.from_numpy(v) for k, v in weights.items()},
                                      Transformer(cfg, device="cpu").state_dict())
    assert sorted(got) == sorted(want)
    kernels = [k for k in got if got[k].dtype == torch.int8]
    assert kernels and all(f"{k}_scale" in got for k in kernels)
    for name in got:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(), err_msg=name)
    assert all(int(got[k].abs().max()) <= 127 for k in kernels)


def _serve_pair(dtype, in_shape, features, bias, seed):
    rng = np.random.default_rng(seed)
    axis = tuple(range(-len(in_shape), 0))
    kernel = rng.integers(-127, 128, size=in_shape + features).astype(np.int8)
    scale = (rng.uniform(0.5, 2, size=(1,) * len(in_shape) + features) / 127).astype(np.float32)
    params = {"kernel": kernel, "kernel_scale": scale}
    if bias:
        params["bias"] = rng.normal(size=features).astype(np.float32)
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    jm = JaxDense(features=features, axis=axis, quantization="int8w_serve", dtype=jdt,
                  use_bias=bias)
    tm = DenseGeneral(in_shape, features, axis=axis, quantization="int8w_serve", dtype=tdt,
                      use_bias=bias)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    x = rng.normal(size=(3, 5) + in_shape).astype(np.float32)
    return jm, tm, params, x, jdt, tdt


@pytest.mark.parametrize("bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("in_shape,features", [((48,), (4, 8)), ((4, 8), (40,)),
                                               ((64,), (37,))],
                         ids=["query", "out", "odd_n"])
def test_int8w_plain_matches_serve_quantized(in_shape, features, dtype, bias):
    jm, tm, params, x, jdt, tdt = _serve_pair(dtype, in_shape, features, bias, seed=5)
    want = jax.jit(jm.apply)({"params": {k: jnp.asarray(v) for k, v in params.items()}},
                             jnp.asarray(x).astype(jdt))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(tdt))
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, size=(16, 9)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.02, size=(1, 9)).astype(np.float32))
    before = iw.launch_count
    assert torch.equal(iw.int8w_matmul(x, q, s), iw.int8w_matmul_plain(x, q, s))
    assert iw.launch_count == before  # no kernel on the CPU
    want = x @ (q.float() * s)
    assert torch.equal(iw.int8w_matmul(x, q, s, impl="plain"), want)
    with pytest.raises(ValueError, match="impl"):
        iw.int8w_matmul(x, q, s, impl="triton")
    with pytest.raises(TypeError, match="int8"):
        iw.int8w_matmul(x, q.float(), s)
    with pytest.raises(ValueError, match="scale has"):
        iw.int8w_matmul(x, q, s[:, :4])
    with pytest.raises(ValueError, match="one CUDA device"):
        iw.int8w_matmul(x, q, s, impl="cuda")
    assert iw.KERNEL_MAX_ROWS >= 32 * 5  # the slots and the speculative verify span


@pytest.fixture(scope="module")
def int8_pair():
    cfg, jcfg = configs(SERVE, slots=4)
    weights = numpy_weights(dataclasses.replace(cfg, quantization=""), seed=0)
    eng = Engine(cfg, device="cpu")
    eng.set_params({k: torch.from_numpy(v) for k, v in weights.items()})  # quantized here
    jeng = JaxEngine(dataclasses.replace(jcfg, scan_layers=False),
                     params=_jax_quantized(jcfg, weights))
    return eng, jeng


def test_engine_logits_and_streams_match_jax(int8_pair):
    eng, jeng = int8_pair
    assert eng.params["decoder.layers_0.mlp_0.wo.kernel"].dtype == torch.int8
    p = prompt(1, 7)
    prefix, _ = eng.prefill(p, len(p))
    jprefix, _ = jeng.prefill(p, len(p))
    np.testing.assert_allclose(prefix["logits"][0].numpy(),
                               np.asarray(jprefix["logits"]).reshape(-1), atol=1e-5, rtol=0)
    for seed, n in ((1, 7), (2, 11), (3, 4)):
        want = jeng.generate_stream(prompt(seed, n), 10)
        assert eng.generate_stream(prompt(seed, n), 10) == want
    assert len(set(want)) > 2


def test_quantized_checkpoint_round_trip(tmp_path, int8_pair):
    """The offline quantizer writes the quantized seeded weights; an engine
    with ``checkpoint_is_quantized=true`` reads them as they are: the same
    tensors, bitwise, and the same streams as converting at load."""
    args = TINY_TTS + SERVE + ["per_device_batch_size=4"]
    out = quantize_checkpoint.run(args + [f"save_path={tmp_path}"], device="cpu")
    assert out["value"] > 0.5 and out["detail"]["total_params"] > 0
    converted = Engine(load_config(args), device="cpu")
    converted.load_params()
    read = Engine(load_config(args + ["checkpoint_is_quantized=true",
                                      f"load_parameters_path={tmp_path}"]), device="cpu")
    read.load_params()
    for name, t in converted.params.items():
        assert torch.equal(read.params[name], t), name
    assert read.generate_stream(prompt(4, 6), 8) == converted.generate_stream(prompt(4, 6), 8)
    # a quantized checkpoint read as a float one, and the reverse, are refused
    with pytest.raises(ValueError, match="checkpoint_is_quantized"):
        Engine(load_config(args + [f"load_parameters_path={tmp_path}"]),
               device="cpu").load_params()
    float_dir = os.path.join(tmp_path, "float")
    from maxtext_indextts2_tpu_torch.train.checkpointing import save_params_only

    float_eng = Engine(load_config(TINY_TTS + ["per_device_batch_size=4"]), device="cpu")
    save_params_only(float_dir, float_eng.load_params())
    with pytest.raises(ValueError, match="checkpoint_is_quantized"):
        Engine(load_config(args + ["checkpoint_is_quantized=true",
                                   f"load_parameters_path={float_dir}"]),
               device="cpu").load_params()
    # and the float checkpoint converts at load to the same weights
    from_float = Engine(load_config(args + [f"load_parameters_path={float_dir}"]), device="cpu")
    from_float.load_params()
    for name, t in converted.params.items():
        assert torch.equal(from_float.params[name], t), name


def test_serve_params_dtype_keeps_quantization_scales_float32():
    """``serve_params_dtype=bfloat16``: int8 kernels untouched, every
    ``scale`` (quantization and norm) float32, the rest bfloat16."""
    eng = Engine(load_config(TINY_TTS + SERVE + ["serve_params_dtype=bfloat16",
                                                 "per_device_batch_size=2"]), device="cpu")
    eng.load_params()
    dtypes = {name: t.dtype for name, t in eng.params.items()}
    assert any(d == torch.int8 for d in dtypes.values())
    for name, d in dtypes.items():
        if name.endswith("kernel_scale") or name.endswith(".scale"):
            assert d == torch.float32, name
        elif d != torch.int8:
            assert d == torch.bfloat16, name
    assert len(eng.generate_stream(prompt(1, 5), 4)) == 4


def test_int8w_serve_halves_the_weight_bytes():
    cfg = load_config(TINY_TTS + SERVE + ["serve_params_dtype=bfloat16"])
    fcfg = load_config(TINY_TTS + ["serve_params_dtype=bfloat16"])
    q, f = Engine(cfg, device="cpu"), Engine(fcfg, device="cpu")
    q.load_params()
    f.load_params()

    def nbytes(eng, kernels_only):  # kernels_only: the decoder's kernels
        return sum(t.numel() * t.element_size() for n, t in eng.params.items()
                   if not kernels_only or (n.startswith("decoder") and n.endswith(".kernel")))

    assert nbytes(q, True) < 0.52 * nbytes(f, True)
    assert nbytes(q, False) < nbytes(f, False)
