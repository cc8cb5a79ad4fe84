"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper given a CUDA tensor launches its kernel (or raises);
given a CPU tensor it runs the plain version."""
