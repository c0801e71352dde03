"""Checkpoints, tokenizers, logging, devices and synthetic weights."""
