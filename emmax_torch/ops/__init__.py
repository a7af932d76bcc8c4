"""Ops on tensors: norms, RoPE, attention (plain path + flash kernel), the
int4 matmul kernel, image preprocessing, and the kernels' build."""
