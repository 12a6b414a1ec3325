"""Attention engines of the port (dense, blockwise, flash)."""
