"""What the PyTorch/CUDA package may and may not depend on.

It imports ``torch`` and never ``jax``, ``flax`` or the JAX package (proved
by walking every source with ``ast``); its yaml files are copies of the JAX
package's and cannot drift; its config loader needs no PyYAML and agrees
with the JAX package's; its entry points refuse to run without a GPU unless
the caller names the CPU; every kernel source carries its note and every
wrapper its plain version and launch count.
"""

import ast
import dataclasses
import importlib
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import maxtext_indextts2_tpu_torch as port
from maxtext_indextts2_tpu.config import load_config as jax_load_config
from maxtext_indextts2_tpu_torch import config as port_config
from maxtext_indextts2_tpu_torch.config import load_config
from maxtext_indextts2_tpu_torch.infer.engine import Engine
from maxtext_indextts2_tpu_torch.models import registry

# tiny shapes: one thread is enough, and the cores stay free for the other test workers
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "maxtext_indextts2_tpu_torch")
JAX_DIR = os.path.join(REPO, "maxtext_indextts2_tpu")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "maxtext_indextts2_tpu")
YAMLS = ["tiny.yml", "tiny_tts.yml", os.path.join("models", "tts-1b.yml")]


def _python_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT_DIR):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(
                node.func, "attr", "")) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", _python_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_nothing_of_jax(path):
    bad = [(name, line) for name, line in _imported_roots(path) if name in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
    roots = {name for name, _ in _imported_roots(path)}
    assert "yaml" not in roots, "the config files are read without PyYAML"


def test_sources_found_and_all_modules_import_without_a_gpu():
    assert len(_python_sources()) > 20
    names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
    assert {"maxtext_indextts2_tpu_torch.ops._build", "maxtext_indextts2_tpu_torch.ops.smoke",
            "maxtext_indextts2_tpu_torch.infer.server"} <= set(names)
    for name in names:  # no triton, no nvcc, no card is touched at import time
        importlib.import_module(name)


def test_package_imports_in_a_process_without_jax():
    code = (
        "import sys\n"
        "import maxtext_indextts2_tpu_torch.infer.server, maxtext_indextts2_tpu_torch.infer.decode\n"
        "import maxtext_indextts2_tpu_torch.ops.smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'yaml', 'maxtext_indextts2_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_copies_equal_the_originals(name):
    with open(os.path.join(PORT_DIR, "configs", name), "rb") as a, \
            open(os.path.join(JAX_DIR, "configs", name), "rb") as b:
        assert a.read() == b.read(), f"configs/{name} drifted from the JAX package's file"


def test_registry_copy_equals_the_original():
    from maxtext_indextts2_tpu.models import registry as jax_registry

    assert set(registry.BLOCK_STYLES) == set(jax_registry.BLOCK_STYLES)
    for name, style in registry.BLOCK_STYLES.items():
        assert dataclasses.asdict(style) == dataclasses.asdict(jax_registry.BLOCK_STYLES[name])
    assert registry.FAMILY_CONFIG_DEFAULTS == jax_registry.FAMILY_CONFIG_DEFAULTS
    assert registry.get_block_style("tts").use_qk_norm


@pytest.mark.parametrize("name", YAMLS)
def test_config_loader_agrees_with_the_jax_package(name):
    overrides = ["decode_attention=ragged", "serve_params_dtype=bfloat16",
                 "per_device_batch_size=8", "ici_fsdp_parallelism=1",
                 "ici_data_parallelism=8", "mlp_activations=silu,linear"]
    want = dataclasses.asdict(jax_load_config([os.path.join(JAX_DIR, "configs", name)] + overrides))
    got = dataclasses.asdict(load_config(
        [os.path.join(PORT_DIR, "configs", name), "decode_attention=ragged",
         "serve_params_dtype=bfloat16", "per_device_batch_size=8",
         "mlp_activations=silu,linear"]))
    assert set(got) == set(want), "the field sets are the same"
    # one device and no mesh here; everything else must agree
    device_bound = {"num_devices", "ici_fsdp_parallelism", "ici_data_parallelism",
                    "dcn_data_parallelism", "global_batch_size_to_load",
                    "global_batch_size_to_train_on", "global_batch_size_to_eval_on",
                    "micro_batch_size_to_train_on"}
    diff = {k: (got[k], want[k]) for k in got if k not in device_bound and got[k] != want[k]}
    assert not diff, diff
    assert got["num_devices"] == 1


def test_tts_1b_is_loaded_at_its_published_width():
    cfg = load_config([os.path.join(PORT_DIR, "configs", "models", "tts-1b.yml")])
    assert (cfg.emb_dim, cfg.num_query_heads, cfg.num_kv_heads, cfg.head_dim, cfg.mlp_dim,
            cfg.num_decoder_layers, cfg.vocab_size, cfg.max_target_length,
            cfg.decoder_block) == (2048, 16, 8, 128, 8192, 20, 8704, 2048, "tts")


def test_flat_yaml_parser():
    text = ('# comment\nbase_config: "tiny.yml"\nname: \'a b\'  # trailing\nn: 12\nx: 1.5e-3\n'
            "flag: true\nlist: [1, 2]\nurl: a#b\n\n")
    assert port_config.parse_flat_yaml(text) == {
        "base_config": "tiny.yml", "name": "a b", "n": 12, "x": 1.5e-3, "flag": True,
        "list": "[1, 2]", "url": "a#b"}
    with pytest.raises(ValueError):
        port_config.parse_flat_yaml("a:\n  nested: 1\n")
    with pytest.raises(ValueError, match="unknown config key"):
        load_config(["no_such_key=1"])
    with pytest.raises(ValueError, match="1 device"):
        load_config(["ici_tensor_parallelism=2"])


def test_entry_points_refuse_to_run_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config([os.path.join(PORT_DIR, "configs", "tiny_tts.yml")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg)
    from maxtext_indextts2_tpu_torch.infer import decode, server

    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode.main([os.path.join(PORT_DIR, "configs", "tiny_tts.yml")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server.make_server(cfg, port=0)
    assert Engine(cfg, device="cpu").device.type == "cpu"  # only when asked


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the script is expected to pass here")
    run = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=120)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout and '"kernels"' not in run.stdout


@pytest.mark.parametrize("source,replaced", [
    ("ragged_decode_attention.cuh", "ragged_decode_attention_v2"),
    ("inplace_update.cu", "inplace_row_update"),
])
def test_kernel_sources_carry_their_note(source, replaced):
    with open(os.path.join(PORT_DIR, "csrc", source)) as fh:
        text = fh.read()
    assert "Replaces the TPU kernel" in text and replaced in text
    assert "What bounds it on this card" in text and "What the design does about it" in text
    assert "torch/extension.h" not in text


@pytest.mark.parametrize("module,plain", [
    ("ragged_decode_attention", "ragged_decode_attention_plain"),
    ("inplace_update", "inplace_row_update_plain"),
])
def test_wrappers_have_plain_version_and_launch_count_and_no_library_call(module, plain):
    mod = importlib.import_module(f"maxtext_indextts2_tpu_torch.ops.{module}")
    assert callable(getattr(mod, plain)) and isinstance(mod.launch_count, int)
    with open(mod.__file__) as fh:
        tree = ast.parse(fh.read())
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not called & {"scaled_dot_product_attention", "compile", "index_put_", "scatter_",
                         "index_copy_"}
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), "no try that falls back"


def test_build_module_targets_sm_90a_into_an_ignored_directory():
    from maxtext_indextts2_tpu_torch.ops import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = fh.read().split()
    assert os.path.relpath(_build.BUILD_DIR, REPO) + "/" in ignored
    assert {os.path.basename(s) for s in _build._sources()} >= {
        "inplace_update.cu", "ragged_decode_attention_bf16.cu"}
    for name, argtypes in _build.SIGNATURES.items():
        assert argtypes[0] is _build._P and argtypes[-1] is _build._P, name
