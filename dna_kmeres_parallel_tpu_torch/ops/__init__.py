"""Device compute: the split-word encode, counts matrices and (min,+)
products, their hand-written CUDA kernels' wrappers beside their plain
PyTorch versions, and the kernel build."""
