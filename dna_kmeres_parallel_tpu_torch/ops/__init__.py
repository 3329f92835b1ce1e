"""Device compute: the split-word encode, its hand-written CUDA kernel and
the kernel build."""
