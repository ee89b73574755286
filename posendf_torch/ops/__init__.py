"""Hand-written CUDA kernels of the distance field and of its training, each
beside its plain PyTorch version (sources in ``csrc/``)."""
