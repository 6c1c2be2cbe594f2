"""The port's fused ops: plain PyTorch versions and hand-written CUDA
kernels for Hopper behind one dispatcher each."""
