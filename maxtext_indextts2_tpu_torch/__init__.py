"""PyTorch/CUDA package of the TTS framework (NVIDIA Hopper, one device).

Mirrors the layout of the JAX package (``config.py``, ``models/``, ``ops/``,
``infer/``) so each module has its counterpart. It imports ``torch`` and
never the JAX package; kernels are hand-written CUDA C++ under ``csrc/``,
built with ``nvcc`` at first use (``ops/_build.py``).
"""
