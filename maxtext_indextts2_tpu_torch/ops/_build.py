"""Builds the CUDA kernels under ``csrc/`` with ``nvcc`` and loads them.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` into an object file, all at
once (one ``nvcc`` process per source), and the objects are linked into ONE
shared library with a plain C interface that ``ctypes`` loads. The sources
include no PyTorch header, so the build takes seconds. It happens at first
use, from the sources in this package and nothing else, into ``_build/``
beside the package's modules (git-ignored); the library's name carries a
hash of the sources, so an edited kernel is rebuilt and a finished build is
reused.

Each C entry point launches on the stream it is given, does not
synchronise, allocates nothing and returns ``cudaGetLastError()``; the
Python wrappers in ``ops/`` pass ``torch.cuda.current_stream().cuda_stream``
and raise on a non-zero return.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# name -> argtypes. Every pointer and the stream are c_void_p: without
# argtypes ctypes would pass them as 32-bit ints and cut the address.
_RAGGED_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
SIGNATURES = {
    "ragged_decode_attention_f32": _RAGGED_ARGS,
    "ragged_decode_attention_bf16": _RAGGED_ARGS,
    "ragged_decode_attention_int8": _RAGGED_ARGS,
    # (q, k_pages, v_pages, page_map, lengths, out, B, num_pages, tpp, max_pages,
    #  nkv, group, head_dim, scale, q_is_bf16, out_is_bf16, stream)
    "paged_decode_attention_f32": [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P],
    "paged_decode_attention_bf16": [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P],
    "inplace_row_update_bytes": [_P, _P, _P, _I, _I, _I, _LL, _P],
    "inplace_row_update_convert": [_P, _P, _P, _I, _I, _I, _LL, _I, _P],
    # (x, w, out, rows, s_len, d, dtype, w_is_f32, stream)
    "ada_rmsnorm": [_P, _P, _P, _LL, _I, _I, _I, _I, _P],
    # (x, q, scales, rows, d, dtype, stream)
    "row_quantize_int8": [_P, _P, _P, _LL, _I, _I, _P],
    # (x, w, q, scales, rows, s_len, d, dtype, w_is_f32, stream)
    "ada_rmsnorm_quantize": [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P],
    # (g, u, q, scales, rows, d, dtype, stream)
    "silu_mul_quantize": [_P, _P, _P, _P, _LL, _I, _I, _P],
    # (q, k, v, out, B, S, N, D, q strides b/s/n, k strides, v strides, dtype,
    #  query rows of a block, stream)
    "s2a_attention": [_P, _P, _P, _P, _I, _I, _I, _I] + [_LL] * 9 + [_I, _I, _P],
}
# flash attention K9-K11, one entry per element type: (tensors, lse / delta,
# q_pos, kv_pos, q_seg, kv_seg, B, H, Hkv, Sq, Skv, D, (batch, seq, head) strides
# of every [B,S,N,D] tensor, causal, window, chunk, soft_cap, scale, stream)
_FLASH_TAIL = [_I, _I, _I, _F, _F, _P]
for _dt in ("f32", "bf16"):
    SIGNATURES[f"flash_fwd_{_dt}"] = [_P] * 9 + [_I] * 6 + [_LL] * 12 + _FLASH_TAIL
    SIGNATURES[f"flash_bwd_dq_{_dt}"] = [_P] * 11 + [_I] * 6 + [_LL] * 15 + _FLASH_TAIL
    SIGNATURES[f"flash_bwd_dkv_{_dt}"] = [_P] * 12 + [_I] * 6 + [_LL] * 18 + _FLASH_TAIL

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process did (None: reused)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME, $PATH and /usr/local/cuda): the CUDA "
        "kernels of this package are compiled on the machine that has the GPU"
    )


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC_DIR)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(CSRC_DIR, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def _build(lib_path: str, verbose: bool) -> None:
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    procs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)[:-3]}.{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", CSRC_DIR, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed, objs = [], [], []
    for src, obj, proc in procs:  # all compilers run at once; wait for each
        out, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)} (exit {proc.returncode})\n{out}")
        objs.append(obj)
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as fh:
        fh.write("\n".join(log))
    if verbose or failed:
        print("\n".join(log), flush=True)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}; see the output above")
    tmp = f"{lib_path}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *objs], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: a concurrent process sees all or nothing
    for obj in objs:
        os.remove(obj)


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The kernel library, built first if this checkout has not built it."""
    global _lib, build_seconds
    if _lib is not None:  # fast path: no lock on the per-launch route
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = os.path.join(BUILD_DIR, f"libmtt_kernels_{_source_hash()}.so")
        if not os.path.exists(lib_path):
            t0 = time.perf_counter()
            _build(lib_path, verbose)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(lib_path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check_launch(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what}: kernel launch failed with CUDA error code {code} "
            "(1 = invalid value: a shape or type no kernel instantiation takes)"
        )
