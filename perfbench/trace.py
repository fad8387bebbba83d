"""Spans and the device trace of a traced run.

The harness opens spans with ``torch.profiler.record_function`` around the
calls into each layer, named ``bench.<layer>``. ``Profile`` runs the
profiler over a stretch of the measured window and reduces its events to
two tables: the device operations (name, start, end, and the host time of
their launch) and the host spans. A device operation lies under a span
when its launch does, so time on the device is charged to the layer that
asked for it even where the device runs it later.
"""
from __future__ import annotations

import contextlib
import warnings

import numpy as np

SPAN_PREFIX = "bench."


def span(name: str, enabled: bool):
    """A ``bench.<name>`` range for the profiler, or nothing when off."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


class Trace:
    """Device operations and host spans, times in seconds on one clock.

    ``ops``: names, and arrays ``start``, ``end``, ``launch``; ``spans``:
    name -> (starts, ends) sorted by start; ``window``: (t0, t1)."""

    def __init__(self, ops, spans: dict, window: tuple):
        names, start, end, launch = zip(*ops) if ops else ((), (), (), ())
        self.names = list(names)
        self.start = np.asarray(start, dtype=np.float64)
        self.end = np.asarray(end, dtype=np.float64)
        self.launch = np.asarray(launch, dtype=np.float64)
        self.spans = {}
        for name, ivs in spans.items():
            ivs = sorted(ivs)
            self.spans[name] = (np.asarray([a for a, _ in ivs]), np.asarray([b for _, b in ivs]))
        self.window = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def count(self, name: str) -> int:
        return len(self.spans.get(name, ((), ()))[0])

    def under(self, *names: str) -> np.ndarray:
        """Mask of the operations launched inside a span of every one of
        ``names``."""
        t = self.launch
        mask = np.ones(t.shape, dtype=bool)
        for name in names:
            s, e = self.spans.get(name, (np.zeros(0), np.zeros(0)))
            if not len(s):
                return np.zeros(t.shape, dtype=bool)
            i = np.searchsorted(s, t, side="right") - 1
            ok = i >= 0
            mask &= ok & (t < e[np.maximum(i, 0)])
        return mask

    def matching(self, *patterns: str) -> np.ndarray:
        """Mask of the operations whose name contains any of ``patterns``."""
        return np.asarray([any(p in n for p in patterns) for n in self.names], dtype=bool)

    def seconds(self, mask=None) -> float:
        """Summed device time of the operations in ``mask``."""
        d = self.end - self.start
        return float(np.sum(d if mask is None else d[mask]))

    def share(self, bound_s: float, kernels: tuple, *spans: str):
        """100 x ``bound_s`` over the device time of the operations named
        by any of ``kernels`` and launched under every one of ``spans``;
        None where there are none."""
        mask = self.matching(*kernels) & self.under(*spans)
        return 100 * bound_s / self.seconds(mask) if mask.any() else None

    def ms_per(self, mask: np.ndarray, span: str):
        """Device time of the operations in ``mask``, in ms per ``span``;
        None where there is no such span or operation."""
        n = self.count(span)
        return self.seconds(mask) / n * 1e3 if n and mask.any() else None

    def idle_share(self):
        """Share of the window in which no operation ran on the device, in
        %; None where the trace holds none."""
        if self.window_s <= 0 or not len(self.names):
            return None
        return 100 * (1 - self.busy_s() / self.window_s)

    def busy_s(self) -> float:
        """Union of the device operations' spans inside the window."""
        return float(np.sum(self._merged()[1] - self._merged()[0]))

    def _merged(self):
        if not len(self.start):
            return np.zeros(0), np.zeros(0)
        s = np.clip(self.start, *self.window)
        e = np.clip(self.end, *self.window)
        o = np.argsort(s, kind="stable")
        s, e = s[o], e[o]
        cm = np.maximum.accumulate(e)
        new = np.ones(len(s), dtype=bool)
        new[1:] = s[1:] > cm[:-1]
        idx = np.flatnonzero(new)
        return s[idx], np.maximum.reduceat(e, idx)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost span open at each gap's start."""
        by_name: dict = {}
        for n, d in zip(self.names, self.end - self.start):
            by_name[n] = by_name.get(n, 0.0) + float(d)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gs, ge = self._merged()
        starts = np.concatenate([[self.window[0]], ge])
        ends = np.concatenate([gs, [self.window[1]]])
        gaps: dict = {}
        for a, b in zip(starts, ends):
            if b <= a:
                continue
            label, best = "no span", -np.inf
            for name, (s, e) in self.spans.items():
                i = np.searchsorted(s, a, side="right") - 1
                if i >= 0 and a < e[i] and s[i] > best:
                    label, best = name, s[i]
            gaps[label] = gaps.get(label, 0.0) + float(b - a)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


class Profile:
    """``torch.profiler`` over a stretch of the window: ``start()`` and
    ``stop()`` bracket it; ``trace`` holds the reduced ``Trace``."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self._prof = None
        self.trace = None
        self._window = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self._prof.__enter__()
        self._window = record_function(SPAN_PREFIX + "window")
        self._window.__enter__()

    @property
    def active(self) -> bool:
        return self._prof is not None and self.trace is None

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            self._prof.__exit__(None, None, None)
        self.trace = reduce_events(self._prof.profiler.kineto_results.events())
        self._prof = None


def reduce_events(events) -> Trace:
    """Device operations (with the host time of their launch, joined by
    correlation id to the runtime call that launched them) and ``bench.``
    spans from the profiler's raw events."""
    from torch.autograd import DeviceType

    dev, runtime, spans = [], {}, {}
    base = None
    for ev in events:
        name = ev.name()
        if base is None:
            base = ev.start_ns()  # times relative to it keep their nanoseconds
        t0, t1 = (ev.start_ns() - base) * 1e-9, (ev.end_ns() - base) * 1e-9
        if ev.device_type() == DeviceType.CPU:
            if name.startswith(SPAN_PREFIX):
                spans.setdefault(name[len(SPAN_PREFIX):], []).append((t0, t1))
            elif name.startswith("cu"):  # cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync...
                runtime[ev.correlation_id()] = t0
        elif ev.device_type() == DeviceType.CUDA and not name.startswith(SPAN_PREFIX):
            if t1 > t0:
                dev.append((name, t0, t1, ev.correlation_id()))
    window = spans.pop("window", [(0.0, 0.0)])[0]
    ops = [(n, s, e, runtime.get(c, s)) for n, s, e, c in dev]
    return Trace(ops, spans, window)
