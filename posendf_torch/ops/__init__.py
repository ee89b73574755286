"""Hand-written CUDA kernels of the distance field, each beside its plain
PyTorch version (see ``csrc/field_kernels.cu``)."""
