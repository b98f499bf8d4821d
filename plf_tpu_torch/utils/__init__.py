"""Utilities of the PyTorch/CUDA port (numpy only)."""
