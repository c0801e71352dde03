"""Tensor ops: norms, rotary embeddings, attention and its CUDA kernels."""
