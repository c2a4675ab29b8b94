"""Pair kernels, bonded terms and constraints (plain PyTorch)."""
