"""Twins of the paper's figure drivers (``benchmarks/fig*.py``), in PyTorch."""
