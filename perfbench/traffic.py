"""Requests from a mix file's parameters and the seed.

A length is given as ``{"dist": "loguniform" | "uniform", "lo": a, "hi": b}``
or ``{"dist": "fixed", "value": n}``. Lengths are stratified: each block of
``block`` requests takes the distribution's ``block`` quantiles at the
midpoints of equal steps, in an order shuffled by the seed. So every seed
serves the same set of sizes, in another order, and a window of a few
hundred requests sees nearly the same mix whatever the seed. Prompt ids
are uniform over the configuration's vocabulary.
"""
from __future__ import annotations

import numpy as np


def quantiles(spec: dict, n: int) -> np.ndarray:
    """The distribution's quantiles at (i + 0.5) / n, as whole lengths."""
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]))
    lo, hi = spec["lo"], spec["hi"]
    if spec["dist"] == "loguniform":
        x = lo * (hi / lo) ** u
    elif spec["dist"] == "uniform":
        x = lo + (hi - lo) * u
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.round(x), lo, hi).astype(np.int64)


def longest(spec: dict) -> int:
    return int(spec["value"] if spec["dist"] == "fixed" else spec["hi"])


def shortest(spec: dict) -> int:
    return int(spec["value"] if spec["dist"] == "fixed" else spec["lo"])


def requests(mix: dict, vocab: int, seed: int):
    """An endless stream of (prompt ids (P,) int32, new tokens)."""
    rng = np.random.default_rng([seed, 1])
    block = mix["block"]
    p_q, n_q = quantiles(mix["prompt"], block), quantiles(mix["new_tokens"], block)
    while True:
        for p, n in zip(rng.permutation(p_q), rng.permutation(n_q)):
            yield rng.integers(0, vocab, size=int(p), dtype=np.int64).astype(np.int32), int(n)
