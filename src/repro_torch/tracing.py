"""The program's spans and counters, for ``torch.profiler``.

``span(name)`` opens a ``repro_torch.<name>`` range
(``torch.profiler.record_function``) while tracing is on; while it is off
it returns one shared ``nullcontext``, so a span costs a global read. Such
ranges lie on the profiler's clock beside the device's operations, which
the profiler joins to their launches: each stretch of the device's time,
busy or idle, can be put down to the span the host was in.

Tracing is off until a caller turns it on with ``enable(True)``, under a
``torch.profiler.profile`` of its own. While it is on, ``moe_apply`` hands
each call's router counts (the routing's own (groups, experts) tensor, on
the device, not copied) to ``record_route``, which appends them to
``routes``; turning tracing on empties that list.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["PREFIX", "enable", "is_enabled", "span", "record_route", "routes"]

PREFIX = "repro_torch."

_OFF = contextlib.nullcontext()
_on = False
routes: list = []  # the router's counts of each MoE call while tracing is on


def enable(on: bool) -> None:
    """Turn the spans and counters on or off (on: ``routes`` emptied)."""
    global _on
    if on:
        routes.clear()
    _on = bool(on)


def is_enabled() -> bool:
    return _on


def span(name: str):
    """A ``repro_torch.<name>`` range while tracing is on, else a no-op."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def record_route(counts: torch.Tensor) -> None:
    """Keep one MoE call's router counts while tracing is on."""
    if _on:
        routes.append(counts)
