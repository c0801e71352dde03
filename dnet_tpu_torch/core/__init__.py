"""Engine, KV cache, sampler and shared types."""
