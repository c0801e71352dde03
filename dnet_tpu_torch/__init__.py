"""PyTorch/CUDA port of dnet-tpu for NVIDIA Hopper (H100): OpenAI-compatible
serving through hand-written CUDA attention kernels.  Imports torch, never
jax, and nothing of dnet_tpu."""
