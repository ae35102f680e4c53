"""Attention and loss ops (port of :mod:`apex_tpu.ops`): flash attention
with its CUDA kernels, the fused softmax cross entropy, and the attention
mask enum."""
