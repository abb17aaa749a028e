"""The PyTorch package's ``RoutedMoE`` (``models/moe.py``) and its grouped
products (``ops/grouped_matmul.py``, plain versions on the CPU) against the
JAX package's, in the cases of the JAX package's ``tests/test_moe.py``.

One numpy-seeded set of weights goes into both packages (the port's state
dict names are the JAX tree's, ``utils/param_bridge.params_to_jax``). The
CPU takes the dense einsum route in both; the sparse route (sort by expert,
grouped products, scatter back) is held against the JAX package's
``RoutedMoE._sparse_experts`` called unbound (its ``ragged_dot`` runs on the
CPU), and the plain grouped products against ``jax.lax.ragged_dot`` with empty
groups.

Tolerances: float32 outputs and the load-balance loss within 2e-5 (the same
arithmetic summed in another order; the JAX package's own dense-vs-sparse
case holds 2e-5). bfloat16 outputs of the sparse route within 2**-7 of
max(1, max |y|): each product's float32 sum is rounded to bfloat16 on both
sides, summed in another order, so a value may sit one bfloat16 step apart.
int8 sums (``ragged_dot`` with int32 results) exactly equal; the int8 sparse
route's codes, which only a rounding boundary could move, within 2**-7 too.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.models.moe import RoutedMoE as JaxRoutedMoE
from maxtext_indextts2_tpu.ops.quantization import (
    quantize_params_for_serving as jax_quantize_params_for_serving,
)
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.models import moe as moe_lib
from maxtext_indextts2_tpu_torch.models.moe import RoutedMoE
from maxtext_indextts2_tpu_torch.ops import grouped_matmul as gm
from maxtext_indextts2_tpu_torch.ops.quantization import quantize_params_for_serving
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax, tree_to_state_dict

torch.set_num_threads(1)

TOL = 2e-5
TOL_BF16 = 2.0 ** -7
BASE = ["base_emb_dim=64", "base_mlp_dim=128", "moe_mlp_dim=128", "num_experts=4",
        "num_experts_per_tok=2", "vocab_size=256"]


def _weights(module: RoutedMoE, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for name, p in module.state_dict().items():
        shape = tuple(p.shape)
        if name in ("wi_0", "wi_1", "wo"):
            w = rng.normal(size=shape) / np.sqrt(shape[1])
        elif name.endswith("kernel"):
            w = rng.normal(size=shape) / np.sqrt(shape[0])
        elif name == "gate_bias":
            w = 0.1 * rng.normal(size=shape)
        else:
            w = rng.normal(size=shape)
        out[name] = w.astype(np.float32)
    return out


def _pair(args, seed=0):
    """(port RoutedMoE with numpy weights, JAX RoutedMoE, its variables, weights)."""
    cfg, jcfg = load_config(BASE + args), jax_load_config(BASE + args)
    port = RoutedMoE(cfg, device="cpu")
    weights = _weights(port, seed)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    variables = {"params": jax.tree.map(jnp.asarray, params_to_jax(weights))}
    return port, JaxRoutedMoE(cfg=jcfg), variables, weights


def _x(seed=1, shape=(2, 8, 64)):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _forward_both(args, seed=0):
    port, jmoe, variables, _ = _pair(args, seed)
    x = _x()
    with torch.no_grad():
        out, lb = port(torch.from_numpy(x))
    (jout, jlb), _ = jmoe.apply(variables, jnp.asarray(x), mutable=[])
    return out.numpy(), float(lb), np.asarray(jout), float(jlb), variables


def test_moe_forward_shape_and_loss():
    out, lb, jout, jlb, _ = _forward_both(["dtype=float32"])
    assert out.shape == (2, 8, 64) and np.isfinite(out).all()
    np.testing.assert_allclose(out, jout, atol=TOL)
    assert abs(lb - jlb) <= TOL and 0.5 < lb < 4.0


def _fixed_routing():
    top_idx = np.array([[[0, 1]] * 8, [[2, 3]] * 8], np.int64)
    return top_idx, np.full((2, 8, 2), 0.5, np.float32)


def test_dense_vs_sparse_parity():
    """The port's dense route, its sparse route (plain grouped products) and
    the JAX package's sparse route agree; one expert holds no row here."""
    port, jmoe, _, w = _pair(["dtype=float32"])
    x = _x()
    top_idx, top_w = _fixed_routing()
    experts = [torch.from_numpy(w[n]) for n in ("wi_0", "wi_1", "wo")]
    args = (torch.from_numpy(x), torch.from_numpy(top_idx), torch.from_numpy(top_w))
    dense = port.dense_experts(*args, *experts).numpy()
    sparse = port.sparse_experts(*args, *experts).numpy()
    want = np.asarray(jmoe._sparse_experts(
        jnp.asarray(x), jnp.asarray(top_idx.astype(np.int32)), jnp.asarray(top_w),
        *(jnp.asarray(w[n]) for n in ("wi_0", "wi_1", "wo")), jnp.float32))
    np.testing.assert_allclose(dense, want, atol=TOL)
    np.testing.assert_allclose(sparse, want, atol=TOL)


@pytest.mark.parametrize("on_input", [False, True], ids=["weight_on_output", "weight_on_input"])
def test_sparse_route_bf16_against_the_jax_sparse_route(on_input):
    """bfloat16 operands, uneven routing with empty experts and an expert
    holding most rows: the port's sparse route against the JAX package's."""
    args = ["dtype=bfloat16", "num_experts=8", "num_experts_per_tok=2",
            f"moe_weight_on_input={str(on_input).lower()}"]
    port, jmoe, _, w = _pair(args, seed=3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 64)).astype(ml_dtypes.bfloat16)
    top_idx = np.stack([rng.choice([0, 2, 5, 6], size=2, replace=False,
                                   p=[0.7, 0.1, 0.1, 0.1]) for _ in range(21)]).reshape(3, 7, 2)
    top_w = rng.uniform(0.1, 1.0, size=(3, 7, 2)).astype(ml_dtypes.bfloat16)
    experts = {n: w[n].astype(ml_dtypes.bfloat16) for n in ("wi_0", "wi_1", "wo")}
    t = tree_to_state_dict
    got = port.sparse_experts(
        t({"x": x})["x"], torch.from_numpy(top_idx), t({"w": top_w})["w"],
        *(t({n: v})[n] for n, v in experts.items())).float().numpy()
    want = np.asarray(jmoe._sparse_experts(
        jnp.asarray(x), jnp.asarray(top_idx.astype(np.int32)), jnp.asarray(top_w),
        *(jnp.asarray(v) for v in experts.values()), jnp.bfloat16)).astype(np.float32)
    assert np.abs(got - want).max() <= TOL_BF16 * max(1.0, np.abs(want).max())


def test_int8_expert_serving_path():
    """int8w_serve: quantize_params_for_serving fills the same int8 experts
    and per-(expert, channel) scales in both packages; the module's forward
    (the dense route of dequantized experts on the CPU) and the int8 sparse
    route (int8 grouped products, the activations row-quantized) equal the
    JAX package's."""
    port_f32, _, _, w = _pair(["dtype=float32"])
    cfg_q, jcfg_q = (load_config(BASE + ["dtype=float32", "quantization=int8w_serve"]),
                     jax_load_config(BASE + ["dtype=float32", "quantization=int8w_serve"]))
    port_q = RoutedMoE(cfg_q, device="cpu")
    qp = quantize_params_for_serving({k: torch.from_numpy(v) for k, v in w.items()},
                                     port_q.state_dict())
    port_q.load_state_dict(qp)
    jmoe_q = JaxRoutedMoE(cfg=jcfg_q)
    x = _x()
    abstract = jax.eval_shape(lambda: jmoe_q.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    import flax

    jqp = jax_quantize_params_for_serving(jax.tree.map(jnp.asarray, params_to_jax(w)),
                                          flax.linen.meta.unbox(abstract["params"]))
    assert qp["wi_0"].dtype == torch.int8 and tuple(qp["wi_0_scale"].shape) == (4, 1, 128)
    for name in ("wi_0", "wi_1", "wo"):
        np.testing.assert_array_equal(qp[name].numpy(), np.asarray(jqp[name]))
        np.testing.assert_array_equal(qp[f"{name}_scale"].numpy(),
                                      np.asarray(jqp[f"{name}_scale"]))
    with torch.no_grad():
        out_q, _ = port_q(torch.from_numpy(x))
        out_f32, _ = port_f32(torch.from_numpy(x))
    (jout_q, _), _ = jmoe_q.apply({"params": jqp}, jnp.asarray(x), mutable=[])
    np.testing.assert_allclose(out_q.numpy(), np.asarray(jout_q), atol=TOL)
    assert np.abs(out_q.numpy() - out_f32.numpy()).max() < 0.05 * np.abs(out_f32.numpy()).max()

    top_idx, top_w = _fixed_routing()
    scales = tuple(qp[f"{n}_scale"] for n in ("wi_0", "wi_1", "wo"))
    got = port_q.sparse_experts(torch.from_numpy(x), torch.from_numpy(top_idx),
                                torch.from_numpy(top_w), qp["wi_0"], qp["wi_1"], qp["wo"],
                                scales).numpy()
    want = np.asarray(jmoe_q._sparse_experts(
        jnp.asarray(x), jnp.asarray(top_idx.astype(np.int32)), jnp.asarray(top_w),
        jqp["wi_0"], jqp["wi_1"], jqp["wo"], jnp.float32,
        scales=(jqp["wi_0_scale"], jqp["wi_1_scale"], jqp["wo_scale"])))
    np.testing.assert_allclose(got, want, atol=TOL_BF16 * max(1.0, np.abs(want).max()))


def test_int8_activation_codes_equal_the_jax_q_rows():
    """The sparse int8 route's activation codes and scales, bit for bit,
    zero rows and tiny rows included (K6 ``row_quantize_int8`` floors the
    scale elsewhere: ``max(amax / 127, 1e-9)`` in the division, 0 for a zero
    row, so the route keeps its own pass)."""
    rng = np.random.default_rng(7)
    v = rng.normal(size=(6, 40)).astype(np.float32)
    v[1] = 0.0
    v[2] *= 1e-8
    codes, scales = moe_lib.q_rows(torch.from_numpy(v))
    amax = jnp.max(jnp.abs(jnp.asarray(v)), axis=-1, keepdims=True)
    sc = jnp.maximum(amax, 1e-9) / 127.0
    want = jnp.round(jnp.asarray(v) / sc).astype(jnp.int8)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(sc))


def test_sigmoid_scores_and_bias():
    out, lb, jout, jlb, variables = _forward_both(
        ["routed_score_func=sigmoid", "routed_bias=true", "dtype=float32"])
    assert "gate_bias" in variables["params"]
    np.testing.assert_allclose(out, jout, atol=TOL)
    assert abs(lb - jlb) <= TOL


def test_group_limited_routing():
    out, _, jout, _, _ = _forward_both(
        ["n_routing_groups=2", "topk_routing_group=1", "dtype=float32"])
    np.testing.assert_allclose(out, jout, atol=TOL)


def test_shared_experts():
    out, _, jout, _, variables = _forward_both(["shared_experts=1", "dtype=float32"])
    assert "shared_experts" in variables["params"]
    np.testing.assert_allclose(out, jout, atol=TOL)


def test_moe_weight_on_input_llama4():
    out, _, jout, _, _ = _forward_both(
        ["moe_weight_on_input=true", "routed_score_func=sigmoid", "num_experts_per_tok=1",
         "shared_experts=1", "dtype=float32"])
    np.testing.assert_allclose(out, jout, atol=TOL)


def test_the_cpu_takes_the_dense_route(monkeypatch):
    """The route follows the tensor's device, as the JAX package follows its
    backend: the CPU computes the experts densely even with sparse_matmul."""
    port, *_ = _pair(["dtype=float32", "sparse_matmul=true"])

    def no_sparse(*a, **k):
        raise AssertionError("the sparse route on the CPU")

    monkeypatch.setattr(port, "sparse_experts", no_sparse)
    with torch.no_grad():
        out, _ = port(torch.from_numpy(_x()))
    assert np.isfinite(out.numpy()).all()


def _tiny_lm(block, extra):
    return [f"decoder_block={block}", "base_num_query_heads=2", "base_num_kv_heads=2",
            "head_dim=32", "max_target_length=32", "dtype=float32"] + BASE + extra


def _logits_both(args, scan_layers):
    """Train-mode logits of one port Transformer and the JAX one, from the
    same numpy weights (the JAX tree scan-stacked or not)."""
    from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
    from maxtext_indextts2_tpu_torch.models import MODE_TRAIN, Transformer
    from torch_port_helpers import jax_tree, numpy_weights

    cfg = load_config(args)
    jcfg = jax_load_config(args + [f"scan_layers={str(scan_layers).lower()}"])
    weights = numpy_weights(cfg, seed=5)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, 256, size=(2, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    segs = np.ones_like(tokens)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(pos), torch.from_numpy(segs),
                    mode=MODE_TRAIN).numpy()
    want = JaxTransformer(cfg=jcfg).apply(
        {"params": jax_tree(weights, scan_layers=scan_layers)}, jnp.asarray(tokens),
        jnp.asarray(pos), jnp.asarray(segs))
    return got, np.asarray(want)


def test_moe_in_transformer_train():
    """A mixtral-style decoder: the training forward's logits equal the JAX
    package's (scan-stacked tree); MoE training itself is ported since item
    6's training part (the load-balance loss in the objective:
    tests/test_torch_moe_train.py), so the training config is taken."""
    from maxtext_indextts2_tpu_torch.train import train as ttrain

    args = _tiny_lm("mixtral", ["base_num_decoder_layers=2"])
    got, want = _logits_both(args, scan_layers=True)
    np.testing.assert_allclose(got, want, atol=TOL)
    ttrain.check_training_config(load_config(args))


def test_deepseek_dense_then_moe_layers():
    """deepseek's two regions (``dense_layers`` then ``moe_layers``), with
    MLA, scan-stacked in the JAX tree: the same logits."""
    from maxtext_indextts2_tpu_torch.models import Transformer

    args = _tiny_lm("deepseek", ["base_num_decoder_layers=4", "first_num_dense_layers=2",
                                 "kv_lora_rank=16", "qk_nope_head_dim=16",
                                 "qk_rope_head_dim=8", "v_head_dim=16"])
    names = Transformer(load_config(args), device="meta").state_dict()
    assert {n.split(".")[1] for n in names if n.startswith("decoder.")} == {
        "dense_layers_0", "dense_layers_1", "moe_layers_0", "moe_layers_1"}
    got, want = _logits_both(args, scan_layers=True)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("sizes", [[0, 10, 0, 27, 0], [37, 0, 0, 0, 0], [0, 0, 0, 0, 37],
                                   [5, 6, 7, 8, 11]],
                         ids=["empty_groups", "first_holds_all", "last_holds_all", "all_full"])
def test_plain_grouped_matmul_equals_ragged_dot(sizes):
    rng = np.random.default_rng(sum(sizes) + len(sizes))
    x = rng.normal(size=(37, 24)).astype(np.float32)
    w = rng.normal(size=(5, 24, 16)).astype(np.float32)
    sizes = np.asarray(sizes, np.int32)
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]), dtype=torch.int32)
    want = jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sizes),
                              preferred_element_type=jnp.float32)
    got = gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), offsets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    xq = rng.integers(-127, 128, size=(37, 24)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(5, 24, 16)).astype(np.int8)
    want_q = jax.lax.ragged_dot(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sizes),
                                preferred_element_type=jnp.int32)
    got_q = gm.grouped_matmul_int8(torch.from_numpy(xq), torch.from_numpy(wq), offsets)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))


def test_grouped_matmul_wrappers_check_their_operands():
    x, w = torch.ones((4, 8)), torch.ones((2, 8, 8))
    with pytest.raises(TypeError, match="int32"):
        gm.grouped_matmul(x, w, torch.tensor([0, 2, 4]))
    with pytest.raises(ValueError, match=r"\[G \+ 1\]"):
        gm.grouped_matmul(x, w, torch.tensor([0, 4], dtype=torch.int32))
    with pytest.raises(ValueError, match="go together"):
        gm.grouped_matmul_int8(x.to(torch.int8), w.to(torch.int8),
                               torch.tensor([0, 2, 4], dtype=torch.int32), torch.ones(4))
    assert gm.tile_rows(64, 128) == 16 and gm.tile_rows(2048 * 8, 128) == 64
