"""PyTorch / CUDA port of the DASO repository's serving path (Hopper kernels)."""
