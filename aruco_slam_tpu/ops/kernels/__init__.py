"""Pallas kernels (Triton route) for the batched replay frame step."""
