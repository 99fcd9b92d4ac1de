"""Paged attention ops: Hopper kernels and their plain PyTorch versions."""
