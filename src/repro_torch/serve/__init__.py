"""Serving: the single-batch ``ServeEngine.generate`` path (the continuous
batching scheduler and the paged KV cache come with the next slice)."""
from .engine import ServeEngine
