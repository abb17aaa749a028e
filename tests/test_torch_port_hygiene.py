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
import inspect
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
# every preset of the JAX package, each a byte copy
YAMLS = ["tiny.yml", "tiny_tts.yml"] + sorted(
    os.path.join("models", n) for n in os.listdir(os.path.join(JAX_DIR, "configs", "models"))
    if n.endswith(".yml"))


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


def test_rank_helpers_import_nothing_of_jax():
    """The bodies of the multi-rank tests run in spawned ranks, which must
    not load JAX: their module imports torch, numpy and the port only."""
    path = os.path.join(REPO, "tests", "torch_dist_helpers.py")
    bad = [(name, line) for name, line in _imported_roots(path) if name in FORBIDDEN]
    assert not bad, bad
    assert {name for name, _ in _imported_roots(path)} <= {
        "__future__", "os", "numpy", "torch", "maxtext_indextts2_tpu_torch"}


def test_logical_axis_rules_equal_the_jax_copy():
    from maxtext_indextts2_tpu.parallel.sharding import LOGICAL_AXIS_RULES as jax_rules
    from maxtext_indextts2_tpu_torch.parallel.sharding import LOGICAL_AXIS_RULES

    assert LOGICAL_AXIS_RULES == jax_rules


GATED = ("transformers", "tiktoken", "sentencepiece", "safetensors", "scipy", "grain",
         "pyarrow", "array_record", "datasets", "tensorflow", "tensorflow_datasets",
         "grpc", "tensorstore")


@pytest.mark.parametrize("path", _python_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_optional_packages_are_imported_inside_the_functions_that_use_them(path):
    """``transformers``, ``tiktoken``, ``sentencepiece``, ``safetensors``,
    ``scipy`` and the data packages (``grain``, ``pyarrow``, ``array_record``,
    ``datasets``, ``tensorflow``, ``tensorflow_datasets``) are not on every
    machine the package runs on: no module imports them at its top level."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in top if isinstance(n, ast.ImportFrom) and n.module}
    assert not names & set(GATED), f"{os.path.relpath(path, REPO)} imports {names & set(GATED)}"


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
        "import maxtext_indextts2_tpu_torch.ops.smoke, maxtext_indextts2_tpu_torch.train.train\n"
        "import maxtext_indextts2_tpu_torch.tools.profile_train\n"
        "import maxtext_indextts2_tpu_torch.tools.moe_route_noise\n"
        "import maxtext_indextts2_tpu_torch.infer.page_manager\n"
        "import maxtext_indextts2_tpu_torch.infer.paged_attention\n"
        "import maxtext_indextts2_tpu_torch.infer.speculative\n"
        "import maxtext_indextts2_tpu_torch.infer.prefix_cache\n"
        "import maxtext_indextts2_tpu_torch.infer.cuda_graphs\n"
        "import maxtext_indextts2_tpu_torch.ops.launch_counts\n"
        "import maxtext_indextts2_tpu_torch.audio.cli, maxtext_indextts2_tpu_torch.audio.torch_ckpt\n"
        "import maxtext_indextts2_tpu_torch.utils.ckpt_conversion\n"
        "import maxtext_indextts2_tpu_torch.train.checkpointing\n"
        "import maxtext_indextts2_tpu_torch.tools.reference_state_dicts\n"
        "import maxtext_indextts2_tpu_torch.train.s2a_train, maxtext_indextts2_tpu_torch.audio.masking\n"
        "import maxtext_indextts2_tpu_torch.train.codec_train\n"
        "import maxtext_indextts2_tpu_torch.audio.quantize_extended\n"
        "import maxtext_indextts2_tpu_torch.ops.int8w_matmul, maxtext_indextts2_tpu_torch.ops.quantization\n"
        "import maxtext_indextts2_tpu_torch.tools.quantize_checkpoint\n"
        "import maxtext_indextts2_tpu_torch.infer.loadgen, maxtext_indextts2_tpu_torch.infer.uniserver\n"
        "import maxtext_indextts2_tpu_torch.infer.offline_engine\n"
        "import maxtext_indextts2_tpu_torch.infer.microbenchmark\n"
        "import maxtext_indextts2_tpu_torch.infer.grpc_server\n"
        "import maxtext_indextts2_tpu_torch.models.moe, maxtext_indextts2_tpu_torch.models.mla\n"
        "import maxtext_indextts2_tpu_torch.ops.grouped_matmul\n"
        "from maxtext_indextts2_tpu_torch.train.data import packing, audio_iterator, grain_pipeline\n"
        "from maxtext_indextts2_tpu_torch.train.data import mlperf_pipeline, tfds_pipeline, hf_pipeline\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'yaml', 'aqt', 'maxtext_indextts2_tpu')]\n"
        "assert not bad, bad\n"
        "gated = [m for m in sys.modules if m.split('.')[0] in ('grain', 'pyarrow', "
        "'array_record', 'datasets', 'tensorflow', 'tensorflow_datasets')]\n"
        "assert not gated, gated\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_copies_equal_the_originals(name):
    with open(os.path.join(PORT_DIR, "configs", name), "rb") as a, \
            open(os.path.join(JAX_DIR, "configs", name), "rb") as b:
        assert a.read() == b.read(), f"configs/{name} drifted from the JAX package's file"


PROTO_FILES = ["__init__.py", "orchestrator.proto", "orchestrator_pb2.py"]


@pytest.mark.parametrize("name", PROTO_FILES)
def test_proto_copies_equal_the_originals(name):
    """The gRPC messages (``infer/proto``) are the JAX package's files, byte
    for byte: nothing here can regenerate them (no ``protoc``)."""
    with open(os.path.join(PORT_DIR, "infer", "proto", name), "rb") as a, \
            open(os.path.join(JAX_DIR, "infer", "proto", name), "rb") as b:
        assert a.read() == b.read(), f"infer/proto/{name} drifted from the JAX package's file"


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
    from maxtext_indextts2_tpu_torch.train import train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([os.path.join(PORT_DIR, "configs", "tiny_tts.yml"), "dataset_type=synthetic",
                    "steps=1"])
    from maxtext_indextts2_tpu_torch.train import codec_train

    for target in ("acoustic", "repcodec"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            codec_train.main([f"codec_target={target}", "steps=1"])
    from maxtext_indextts2_tpu_torch.tools import quantize_checkpoint

    from maxtext_indextts2_tpu_torch.train import sft

    with pytest.raises(RuntimeError, match="no CUDA device"):
        sft.main([os.path.join(PORT_DIR, "configs", "tiny_tts.yml"), "steps=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_checkpoint.run([os.path.join(PORT_DIR, "configs", "tiny_tts.yml"),
                                 "save_path=/nonexistent"])
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
    ("paged_decode_attention.cuh", "paged_decode_attention_v2"),
    ("inplace_update.cu", "inplace_row_update"),
    ("row_kernels.cuh", "ada_rmsnorm"),
    ("row_kernels.cuh", "row_quantize_int8"),
    ("row_kernels.cuh", "ada_rmsnorm_quantize"),
    ("row_kernels.cuh", "silu_mul_quantize"),
    ("s2a_attention.cu", "s2a_attention"),
    ("flash_attention.cuh", "_flash_fwd"),
    ("flash_attention.cuh", "_bwd_dq_kernel"),
    ("flash_attention.cuh", "_bwd_dkv_kernel"),
])
def test_kernel_sources_carry_their_note(source, replaced):
    with open(os.path.join(PORT_DIR, "csrc", source)) as fh:
        text = fh.read()
    assert "Replaces the TPU kernel" in text and replaced in text
    assert "What bounds it on this card" in text and "What the design does about it" in text
    assert "torch/extension.h" not in text


def test_grouped_matmul_kernel_source_carries_its_note():
    """The grouped products replace no Pallas kernel (XLA lowers
    ``ragged_dot``): the note names what they are the counterpart of."""
    with open(os.path.join(PORT_DIR, "csrc", "grouped_matmul.cu")) as fh:
        text = fh.read()
    assert "Replaces no Pallas kernel" in text and "ragged_dot" in text
    assert "_sparse_experts" in text
    assert "What bounds it on this card" in text and "What the design does about it" in text
    assert "torch/extension.h" not in text


def test_grouped_matmul_backward_kernel_source_carries_its_note():
    """dgrad and wgrad replace no Pallas kernel either: they are the
    transpose of ``ragged_dot`` that XLA derives for training."""
    with open(os.path.join(PORT_DIR, "csrc", "grouped_matmul_bwd.cu")) as fh:
        text = fh.read()
    assert "Replaces no Pallas kernel" in text and "ragged_dot" in text
    assert "_sparse_experts" in text and "jax.value_and_grad" in text
    assert "What bounds them on this card" in text and "What the designs do about it" in text
    assert "torch/extension.h" not in text
    from maxtext_indextts2_tpu_torch.ops import _build

    assert "grouped_matmul_bwd.cu" in {os.path.basename(s) for s in _build._sources()}
    assert {"grouped_matmul_dgrad", "grouped_matmul_wgrad"} <= set(_build.SIGNATURES)


def test_int8w_kernel_source_carries_its_note():
    """The int8-weight product replaces no Pallas kernel: its note says what
    it is the counterpart of instead."""
    with open(os.path.join(PORT_DIR, "csrc", "int8w_matmul.cu")) as fh:
        text = fh.read()
    assert "Replaces no Pallas kernel" in text and "_serve_quantized" in text
    assert "What bounds it on this card" in text and "What the design does about it" in text
    assert "torch/extension.h" not in text


@pytest.mark.parametrize("module,plain", [
    ("grouped_matmul", "grouped_matmul_plain"),
    ("grouped_matmul", "grouped_matmul_int8_plain"),
    ("grouped_matmul", "grouped_matmul_dgrad_plain"),
    ("grouped_matmul", "grouped_matmul_wgrad_plain"),
    ("int8w_matmul", "int8w_matmul_plain"),
    ("ragged_decode_attention", "ragged_decode_attention_plain"),
    ("ragged_decode_attention", "paged_decode_attention_v2_plain"),
    ("inplace_update", "inplace_row_update_plain"),
    ("ada_rmsnorm", "ada_rmsnorm_plain"),
    ("quant_kernels", "row_quantize_int8_plain"),
    ("quant_kernels", "ada_rmsnorm_quantize_plain"),
    ("quant_kernels", "silu_mul_quantize_plain"),
    ("s2a_attention", "s2a_attention_plain"),
    ("flash_attention", "flash_fwd_plain"),
    ("flash_attention", "flash_bwd_dq_plain"),
    ("flash_attention", "flash_bwd_dkv_plain"),
])
def test_wrappers_have_plain_version_and_launch_count_and_no_library_call(module, plain):
    mod = importlib.import_module(f"maxtext_indextts2_tpu_torch.ops.{module}")
    assert callable(getattr(mod, plain))
    if hasattr(mod, "launch_counts"):  # several kernels, one count each
        assert plain[: -len("_plain")] in mod.launch_counts
        assert all(isinstance(n, int) for n in mod.launch_counts.values())
    elif plain.startswith("paged_"):  # K4 beside K1 in one module
        assert isinstance(mod.paged_launch_count, int)
    else:
        assert isinstance(mod.launch_count, int)
    with open(mod.__file__) as fh:
        tree = ast.parse(fh.read())
    called = {n.func.attr for n in ast.walk(tree)
              if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not called & {"scaled_dot_product_attention", "compile", "index_put_", "scatter_",
                         "index_copy_", "rms_norm", "quantize_per_tensor", "silu"}
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), "no try that falls back"


def test_build_module_targets_sm_90a_into_an_ignored_directory():
    from maxtext_indextts2_tpu_torch.ops import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    with open(os.path.join(REPO, ".gitignore")) as fh:
        ignored = fh.read().split()
    assert os.path.relpath(_build.BUILD_DIR, REPO) + "/" in ignored
    assert {os.path.basename(s) for s in _build._sources()} >= {
        "inplace_update.cu", "ragged_decode_attention_bf16.cu", "ada_rmsnorm.cu",
        "row_quantize.cu", "ada_rmsnorm_quantize.cu", "silu_mul_quantize.cu",
        "s2a_attention.cu", "flash_attention_bf16.cu", "flash_attention_f32.cu",
        "paged_decode_attention_bf16.cu", "paged_decode_attention_f32.cu",
        "grouped_matmul.cu"}
    assert {"ada_rmsnorm", "row_quantize_int8", "ada_rmsnorm_quantize",
            "silu_mul_quantize", "s2a_attention", "flash_fwd_bf16", "flash_fwd_f32",
            "flash_bwd_dq_bf16", "flash_bwd_dq_f32", "flash_bwd_dkv_bf16",
            "flash_bwd_dkv_f32", "paged_decode_attention_bf16",
            "paged_decode_attention_f32", "grouped_matmul_bf16",
            "grouped_matmul_int8"} <= set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert argtypes[0] is _build._P and argtypes[-1] is _build._P, name


def _tiny_backend():
    from maxtext_indextts2_tpu_torch.audio import acoustic, pipeline, quantize, s2a

    cfg = load_config([os.path.join(PORT_DIR, "configs", "tiny_tts.yml"), "s2a_hidden_size=64",
                       "s2a_num_layers=1", "s2a_num_heads=2", "s2a_num_quantizers=2",
                       "s2a_codebook_size=16", "s2a_cond_codebook_size=16"])
    pipe = pipeline.build_tiny_pipeline(cfg, device="cpu")
    return pipe, acoustic, quantize, s2a


# the TTS back end's methods: what waits for a later item of the port queue
# (the call raises naming it), and what queue items 3 and 4b.5 ported (None: the
# method is no longer the stub; its behaviour is held against the JAX package in
# test_torch_frontend.py, test_torch_tts_pipeline.py and test_torch_codec_train.py)
NOT_PORTED = {
    "s2a.compute_loss": (lambda p: p.s2a.compute_loss, None),
    "s2a.__call__": (lambda p: p.s2a.forward, None),
    "vq.encode_latents": (lambda p: p.codec.decoder.quantizer.vq_0.encode_latents, None),
    "vq.latent2dist": (lambda p: p.codec.decoder.quantizer.vq_0.latent2dist, None),
    "vq.__call__": (lambda p: p.codec.decoder.quantizer.vq_0.forward, None),
    "rvq.quantize": (lambda p: p.codec.decoder.quantizer.quantize, None),
    "rvq.latent2dist": (lambda p: p.codec.decoder.quantizer.latent2dist, None),
    "rvq.__call__": (lambda p: p.codec.decoder.quantizer.forward, None),
    "decoder.quantize": (lambda p: p.codec.decoder.quantize, None),
    "decoder.latent2dist": (lambda p: p.codec.decoder.latent2dist, None),
    "decoder.__call__": (lambda p: p.codec.decoder.forward, None),
    "codec.tokenize": (lambda p: p.codec.tokenize, None),
    "codec.__call__": (lambda p: p.codec.forward, None),
    "pipeline.synthesize": (lambda p: p.synthesize, None),
    "pipeline.synthesize_batch": (lambda p: p.synthesize_batch, None),
    "pipeline.frontend_batch": (lambda p: p.frontend_batch, None),
    "pipeline.map_semantic": (lambda p: p.map_semantic, None),
    "pipeline.text_and_prompt_to_lm_prompt": (lambda p: p.text_and_prompt_to_lm_prompt, None),
    "pipeline.load_torch_audio_weights": (lambda p: p.load_torch_audio_weights, None),
}


@pytest.mark.parametrize("name", list(NOT_PORTED))
def test_unported_back_end_methods_name_their_queue_item(name):
    call, item = NOT_PORTED[name]
    pipe, *_ = _tiny_backend()
    if item is None:
        method = call(pipe)
        assert "_unsupported" not in inspect.getsource(method), f"{name} is still a stub"
        return
    with pytest.raises(NotImplementedError, match=rf"port queue: {item}"):
        call(pipe)


def test_port_reads_no_kernel_switch_from_the_environment():
    """The JAX package picks its S2A kernels by environment variables; the
    port picks by where the tensor lies and reads none of them. The one
    variable it reads is the JAX package's opt-in ROUTE of the masked S2A
    attention, ``MTT_S2A_SEQ_FLASH`` (the same condition, a CUDA tensor for a
    TPU), and only in ``audio/s2a.py``; the card's scripts may set it."""
    for path in _python_sources():
        with open(path) as fh:
            text = fh.read()
        rel = os.path.relpath(path, REPO)
        for var in ("MTT_FUSED_QUANT", "MTT_FUSED_ADALN", "MTT_S2A_FLASH"):
            assert var not in text, (rel, var)
        reads = "environ.get(\"MTT_S2A_SEQ_FLASH\"" in text or "getenv(" in text
        if rel != os.path.join("maxtext_indextts2_tpu_torch", "audio", "s2a.py"):
            assert not reads, rel
    with open(os.path.join(PORT_DIR, "audio", "s2a.py")) as fh:
        assert 'os.environ.get("MTT_S2A_SEQ_FLASH", "0") == "1"' in fh.read()


@pytest.mark.parametrize("kernel", ["ada_rmsnorm", "row_quantize_int8", "ada_rmsnorm_quantize",
                                    "silu_mul_quantize"])
def test_row_kernel_wrappers_raise_rather_than_take_the_plain_version(kernel, monkeypatch):
    """``impl="cuda"`` on a machine without CUDA raises; so does a CUDA-routed
    call whose library cannot be built. Nothing quietly runs the plain version."""
    from maxtext_indextts2_tpu_torch.ops import _build, ada_rmsnorm, quant_kernels

    x, w = torch.ones((1, 2, 8)), torch.ones((1, 8))
    calls = {
        "ada_rmsnorm": lambda **kw: ada_rmsnorm.ada_rmsnorm(x, w, **kw),
        "row_quantize_int8": lambda **kw: quant_kernels.row_quantize_int8(x, **kw),
        "ada_rmsnorm_quantize": lambda **kw: quant_kernels.ada_rmsnorm_quantize(x, w, **kw),
        "silu_mul_quantize": lambda **kw: quant_kernels.silu_mul_quantize(x, x, **kw),
    }
    with pytest.raises(ValueError, match="CUDA device"):
        calls[kernel](impl="cuda")

    # a tensor that claims to lie on the GPU reaches the build, which fails here
    monkeypatch.setattr(ada_rmsnorm, "route", lambda *a, **k: "cuda")
    monkeypatch.setattr(quant_kernels, "route", lambda *a, **k: "cuda")

    def no_build(*a, **k):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load_library", no_build)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        calls[kernel]()


@pytest.mark.parametrize("quantize_out", [False, True], ids=["float_out", "quantize_out"])
@pytest.mark.parametrize("x_shape,cond_shape", [
    ((2, 5, 8), (2, 8)), ((2, 8), (2, 8)), ((2, 5, 8), (2, 5, 8)),
], ids=["rows_3d", "rows_2d", "per_position_cond"])
def test_adaptive_rmsnorm_goes_through_the_wrappers_for_every_shape(x_shape, cond_shape,
                                                                    quantize_out):
    """The module has no arithmetic of its own: whatever the shapes, a call
    asked to use the kernel reaches the wrapper's routing (and raises here,
    without CUDA), and the CPU call agrees with the wrapper on [N,1,D] rows."""
    from maxtext_indextts2_tpu_torch.audio.s2a import AdaptiveRMSNorm
    from maxtext_indextts2_tpu_torch.ops import ada_rmsnorm, quant_kernels

    gen = torch.Generator().manual_seed(0)
    norm = AdaptiveRMSNorm(8, device="cpu")
    norm.to_weight.kernel.data.normal_(0.0, 0.3, generator=gen)
    x = torch.randn(x_shape, generator=gen)
    cond = torch.randn(cond_shape, generator=gen)
    with pytest.raises(ValueError, match="CUDA device"):
        norm(x, cond, quantize_out, impl="cuda")

    got = norm(x, cond, quantize_out)
    w = norm.to_weight(cond)
    if len(cond_shape) == len(x_shape):
        rows, w = x.reshape(-1, 1, 8), w.reshape(-1, 8)
    else:
        rows = x
    if quantize_out:
        q, s = quant_kernels.ada_rmsnorm_quantize(rows, w)
        assert got[0].shape == x_shape and got[1].shape == x_shape[:-1]
        assert torch.equal(got[0], q.reshape(x_shape))
        assert torch.equal(got[1], s.reshape(x_shape[:-1]))
    else:
        assert torch.equal(got, ada_rmsnorm.ada_rmsnorm(rows, w).reshape(x_shape))


@pytest.mark.parametrize("quantize_out", [False, True], ids=["float_out", "quantize_out"])
def test_adaptive_rmsnorm_refuses_a_pairing_the_kernels_do_not_take(quantize_out):
    from maxtext_indextts2_tpu_torch.audio.s2a import AdaptiveRMSNorm

    norm = AdaptiveRMSNorm(8, device="cpu")
    with pytest.raises(ValueError, match=r"need x \[B,S,D\] and w \[B,D\]"):
        norm(torch.ones((2, 5, 8)), torch.ones((1, 8)), quantize_out)
    with pytest.raises(ValueError, match=r"need x \[B,S,D\] and w \[B,D\]"):
        norm(torch.ones((2, 3, 5, 8)), torch.ones((2, 8)), quantize_out)


# copies of framework-free modules of the JAX package that must not drift
COPIES = [
    ("maxtext_indextts2_tpu_torch.vocab.mapping", "maxtext_indextts2_tpu.vocab.mapping",
     ["AudioVocabMapping", "build_mapping"]),
    ("maxtext_indextts2_tpu_torch.audio.mel", "maxtext_indextts2_tpu.audio.mel",
     ["hz_to_mel", "mel_to_hz", "mel_filterbank"]),
    ("maxtext_indextts2_tpu_torch.train.data.tokenizer",
     "maxtext_indextts2_tpu.train.data.tokenizer", ["ByteTokenizer"]),
    ("maxtext_indextts2_tpu_torch.train.data.synthetic",
     "maxtext_indextts2_tpu.train.data.synthetic", ["make_batch"]),
    ("maxtext_indextts2_tpu_torch.infer.prefix_cache",
     "maxtext_indextts2_tpu.infer.prefix_cache", ["PrefixCache"]),
    ("maxtext_indextts2_tpu_torch.infer.loadgen", "maxtext_indextts2_tpu.infer.loadgen",
     ["QuerySample", "TestSettings", "QuerySampleLibrary", "LoadgenResult", "_Context",
      "run_test", "OfflineEngineSUT", "OrchestratorSUT"]),
    ("maxtext_indextts2_tpu_torch.utils.dispatch_lock",
     "maxtext_indextts2_tpu.utils.dispatch_lock", ["_FairRLock", "device_dispatch"]),
]


@pytest.mark.parametrize("port_mod,jax_mod,names", COPIES, ids=lambda v: str(v).split(".")[-1])
def test_copied_modules_equal_their_originals(port_mod, jax_mod, names):
    """The mapping, the mel filterbank and the byte tokenizer are copies (the
    port imports nothing of the JAX package): their source is the original's."""
    a, b = importlib.import_module(port_mod), importlib.import_module(jax_mod)
    for name in names:
        assert inspect.getsource(getattr(a, name)) == inspect.getsource(getattr(b, name)), name


def test_s2a_attention_refuses_cuda_tensors_it_cannot_take(monkeypatch):
    """Routed to the kernel, the wrapper checks head dim and strides and
    raises; it never hands such a tensor to the plain version."""
    from maxtext_indextts2_tpu_torch.ops import _build, s2a_attention as k12

    def no_build(*a, **k):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(k12, "route", lambda *a, **k: "cuda")
    monkeypatch.setattr(_build, "load_library", no_build)
    k12.launch_count = 0
    odd = torch.ones((1, 4, 2, 48))
    with pytest.raises(ValueError, match="head dim 48"):
        k12.s2a_attention(odd, odd, odd)
    strided = torch.ones((1, 4, 2, 128))[..., ::2]
    with pytest.raises(ValueError, match="last axis"):
        k12.s2a_attention(strided, strided, strided)
    ok = torch.ones((1, 4, 2, 64))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k12.s2a_attention(ok, ok, ok)
    assert k12.launch_count == 0


def test_frontend_entry_points_refuse_to_run_without_a_gpu(monkeypatch):
    from maxtext_indextts2_tpu_torch.audio import pipeline
    from maxtext_indextts2_tpu_torch.audio.conformer import ConformerConfig
    from maxtext_indextts2_tpu_torch.audio.semantic_tokenizer import SemanticTokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = ConformerConfig(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SemanticTokenizer(tiny)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.build_pipeline(layers=1)
    assert SemanticTokenizer(tiny, {"codebook_size": 8, "vocos_dim": 8,
                                    "vocos_intermediate_dim": 8, "vocos_num_layers": 1},
                             device="cpu").device.type == "cpu"


def test_a_cuda_device_runs_float32_without_tf32(monkeypatch):
    """TF32 is decided in one place: a CUDA device from ``resolve_device``
    runs float32 products and convolutions in full float32."""
    from maxtext_indextts2_tpu_torch.infer.engine import resolve_device

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cpu").type == "cpu" and torch.backends.cudnn.allow_tf32
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
