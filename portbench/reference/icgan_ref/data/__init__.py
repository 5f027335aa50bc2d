"""Frozen plain copy; see the package docstring."""
