"""Alignment input (NumPy only)."""
