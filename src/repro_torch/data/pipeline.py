"""Data pipeline: deterministic, resumable, host-sharded, prefetched (a
copy of ``repro.data.pipeline``, which is numpy: the same batches, bit for
bit; the train step moves each batch to the device).

Fault-tolerance contract: an iterator's full state is ``{"step": int}`` —
batches are a pure function of (seed, step, host_shard), so restoring a
checkpoint and re-seeking the iterator reproduces the exact token stream
(no data loss or duplication across preemptions, and the stream is stable
under elastic re-sharding because sharding is applied at batch granularity).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["SyntheticDataset", "FileDataset", "Prefetcher", "make_dataset"]


class SyntheticDataset:
    """Deterministic synthetic LM batches (counting + noise structure so a
    model can actually fit it in the e2e example)."""

    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        batch: int,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        frontend_dim: int = 0,
        src_len: int = 0,
    ):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch = batch  # per-host batch
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.frontend_dim = frontend_dim
        self.src_len = src_len
        self.step = 0

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])

    def _batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id])
        )
        # structured stream: ramps with random stride => learnable
        start = rng.integers(0, self.vocab_size, size=(self.batch, 1))
        stride = rng.integers(1, 7, size=(self.batch, 1))
        pos = np.arange(self.seq_len + 1)[None, :]
        toks = (start + stride * pos) % self.vocab_size
        out = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if self.frontend_dim:
            out["src_embeds"] = rng.standard_normal(
                (self.batch, self.src_len, self.frontend_dim)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self._batch_at(self.step)
            self.step += 1
            yield b


class FileDataset:
    """Memory-mapped binary token file (uint16/uint32), host-sharded,
    step-indexed windows => random access and exact resume."""

    def __init__(
        self,
        path: str,
        seq_len: int,
        batch: int,
        dtype=np.uint16,
        host_id: int = 0,
        num_hosts: int = 1,
        seed: int = 0,
    ):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.batch = batch
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.seed = seed
        self.step = 0
        self.n_windows = (len(self.tokens) - 1) // seq_len

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])

    def _batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        perm = rng.integers(0, self.n_windows, size=(self.num_hosts, self.batch))
        idx = perm[self.host_id]
        toks = np.stack(
            [self.tokens[i * self.seq_len : i * self.seq_len + self.seq_len + 1]
             for i in idx]
        ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            b = self._batch_at(self.step)
            self.step += 1
            yield b


class Prefetcher:
    """Background-thread prefetch (depth-bounded queue)."""

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


def make_dataset(cfg, shape, seed=0, host_id=0, num_hosts=1, path: Optional[str] = None):
    """Dataset for (model cfg, input shape)."""
    per_host = max(shape.global_batch // num_hosts, 1)
    if path:
        return FileDataset(path, shape.seq_len, per_host, host_id=host_id,
                           num_hosts=num_hosts, seed=seed)
    kw = {}
    if cfg.is_encdec:
        from ..configs.shapes import src_len

        kw = {"frontend_dim": cfg.frontend_dim, "src_len": src_len(cfg, shape)}
    return SyntheticDataset(
        cfg.vocab_size, shape.seq_len, per_host, seed=seed, host_id=host_id,
        num_hosts=num_hosts, **kw,
    )
