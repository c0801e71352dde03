"""Shard node: compute, runtime, ring adapter and control plane."""
