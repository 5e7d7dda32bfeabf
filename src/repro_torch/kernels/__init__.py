"""Hand-written CUDA kernels, their wrappers and plain PyTorch versions
(port of ``repro/kernels``)."""
