"""Batched multi-stream serving."""
