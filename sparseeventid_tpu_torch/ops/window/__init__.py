"""Sorted-window sparse convolution: query helpers, the CUDA kernels' wrappers
with their plain versions, and the plan/forward engine."""
