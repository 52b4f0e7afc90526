"""Scoring ops and hand-written CUDA kernels of the port."""
