"""Parallel configuration (port of the part of ``repro.distributed`` that
training reads; the sharding rules come with the sharding slice)."""
from .sharding import ParallelConfig

__all__ = ["ParallelConfig"]
