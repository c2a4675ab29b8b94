"""Pair kernels, bonded terms, constraints and PME (plain PyTorch)."""
