"""Device ops: hand-written CUDA kernels, each beside its plain PyTorch
version (``inplace_update``, ``ragged_decode_attention``), and KV-cache
quantization helpers."""
