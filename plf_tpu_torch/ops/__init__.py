"""Device ops: layouts, the plain PyTorch PLF, and the CUDA kernels with
their plain versions."""
