"""Supervised fine-tuning in the PyTorch package against the JAX package, on
the CPU: prompt-masked rows (the JAX package's ``tests/test_posttrain.py``
cases), the SFT iterator's batches, one SFT batch's loss and gradients on the
same weights, ``train_sft`` through the trainer, and the vision-SFT row
(tokens, mask, weights, pixels).

Rows and batches are compared exactly; the loss and gradients in float32
within 2e-5 relative to the largest |value| (other summation orders), as the
other training tests; preprocessed pixels within 1e-5 (the resize's float32
sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu.models import Transformer as JaxTransformer
from maxtext_indextts2_tpu.train import sft as jsft
from maxtext_indextts2_tpu.train import train as jtrain
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.train import sft
from maxtext_indextts2_tpu_torch.train import train as ttrain
from maxtext_indextts2_tpu_torch.utils.param_bridge import params_to_jax
from torch_port_helpers import JAX_DEVICES, jax_tree, numpy_weights

TOL = 2e-5
ROWS = 8
# tests/test_posttrain.py's SMALL, unrolled
SMALL = ["base_emb_dim=64", "base_mlp_dim=128", "base_num_decoder_layers=2",
         "base_num_query_heads=2", "base_num_kv_heads=2", "head_dim=32", "vocab_size=256",
         "max_target_length=64", "dtype=float32", "steps=3", "warmup_steps_fraction=0",
         "learning_rate=1e-3", "scan_layers=false"]


def _configs(extra=()):
    args = SMALL + list(extra)
    cfg = load_config(args + [f"per_device_batch_size={ROWS}"])
    jcfg = jax_load_config(args + [f"per_device_batch_size={ROWS / JAX_DEVICES}"])
    return cfg, dataclasses.replace(jcfg, scan_layers=False)


@pytest.mark.parametrize("prompt,completion,max_len", [
    ([1, 2, 3, 4], [10, 11, 12], 16), ([7], [8, 9], 8), ([], [5, 6, 7], 8),
    (list(range(3, 20)), [30, 31], 16),  # the prompt fills the row
], ids=["posttrain_case", "one_token_prompt", "no_prompt", "truncated"])
def test_sft_rows_equal_the_jax_package(prompt, completion, max_len):
    row = sft.sft_example_to_row(prompt, completion, max_len)
    want = jsft.sft_example_to_row(prompt, completion, max_len)
    assert set(row) == set(want)
    for k in row:
        np.testing.assert_array_equal(row[k], np.asarray(want[k]), err_msg=k)
    if prompt == [1, 2, 3, 4]:  # tests/test_posttrain.py's own checks
        assert (row["targets_segmentation"][:3] == 0).all()
        assert (row["targets_segmentation"][3:6] != 0).all()
        np.testing.assert_array_equal(row["inputs"][:6], [1, 2, 3, 4, 10, 11])


def test_sft_iterator_batches_equal_the_jax_package():
    cfg, jcfg = _configs(["data_shuffle_seed=3"])
    ours, theirs = sft.SFTDataIterator(cfg), jsft.SFTDataIterator(jcfg)
    for i in range(3):
        a, b = next(ours), next(theirs)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"batch {i} {k}")


def test_sft_batch_loss_and_gradients_match_jax():
    """The prompt's targets weigh nothing: the loss over an SFT batch and
    every gradient equal the JAX package's on the same weights."""
    cfg, jcfg = _configs()
    weights = numpy_weights(cfg, seed=41)
    batch = {k: np.asarray(v) for k, v in next(sft.SFTDataIterator(cfg)).items()}
    assert (batch["targets_segmentation"] == 0).any()
    model = JaxTransformer(cfg=jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jtrain.loss_fn(model, jcfg, p, jbatch, jax.random.PRNGKey(0)),
        has_aux=True)(jax_tree(weights))
    state = ttrain.setup_train_state(
        cfg, device="cpu", params={k: torch.from_numpy(v) for k, v in weights.items()})
    loss, _ = ttrain.loss_fn(state.model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(state.params, ttrain._grads(loss, list(state.params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0, atol=TOL)
    got = params_to_jax({k: v.detach() for k, v in grads.items()})
    for path, leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        node = got
        for p in path:
            node = node[p.key]
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(node, leaf, rtol=0,
                                   atol=TOL * max(float(np.abs(leaf).max()), 1e-6))


def test_train_sft_runs_through_the_trainer_and_learns(monkeypatch):
    """A dataset of one example (the HF source stands in): the loss falls."""
    cfg, _ = _configs(["steps=6", "per_device_batch_size=4", "dataset_path=one_example"])
    monkeypatch.setattr(sft, "hf_sft_source",
                        lambda c: iter([([3, 4, 5, 6], [7, 8, 9, 10, 11])] * 1000))
    out = sft.train_sft(cfg, device="cpu", quiet=True)
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_vision_sft_row_equals_the_jax_package():
    args = ["base_emb_dim=64", "base_mlp_dim=128", "base_num_decoder_layers=2",
            "base_num_query_heads=4", "base_num_kv_heads=4", "head_dim=16", "vocab_size=256",
            "max_target_length=16", "per_device_batch_size=1", "image_token_id=250"]
    cfg, jcfg = load_config(args), jax_load_config(args)
    img = (np.arange(32 * 32 * 3).reshape(32, 32, 3) % 255).astype(np.uint8)
    row, pixels = sft.vision_sft_example_to_row(cfg, img, prompt_ids=[5, 6],
                                                answer_ids=[7, 8, 9], tokens_per_image=3,
                                                image_size=16)
    jrow, jpixels = jsft.vision_sft_example_to_row(jcfg, img, prompt_ids=[5, 6],
                                                   answer_ids=[7, 8, 9], tokens_per_image=3,
                                                   image_size=16)
    assert set(row) == set(jrow)
    for k in row:
        np.testing.assert_array_equal(row[k], np.asarray(jrow[k]), err_msg=k)
    assert row["inputs"][:8].tolist() == [5, 6, 250, 250, 250, 7, 8, 9]
    assert row["targets_segmentation"].tolist().count(1) == 3
    assert row["targets"][4:7].tolist() == [7, 8, 9]
    assert pixels.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(pixels, np.asarray(jpixels), rtol=0, atol=1e-5)
