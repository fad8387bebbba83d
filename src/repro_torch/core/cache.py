"""Persistent structure cache: tuning plans + VBR structure on disk (PyTorch
port of ``repro.core.cache``: the same layout and plan schema, under device
keys of its own).

SABLE's contract is compile-once / run-many (paper Section III): everything
derived from the sparsity *pattern* — the staged program, the backend
choice, the tile shapes — is reusable by any process that stages a matrix
with the same ``structure_hash`` (vbr.py).  The in-memory executable cache
in ``staging.py`` only lives for one process; this module is the on-disk
half, so a *second* process (or a restarted server) skips the autotune
search and goes straight to staging with the known-best plan.

Layout (under ``$REPRO_CACHE_DIR`` or ``~/.cache/repro-sable``)::

    plans/<key>.json        winning StagingOptions + measured timings
    structures/<hash>.npz   the VBR indirection arrays (never ``val``)
    models/<key>.json       fitted cost models (core/cost_model.py), keyed
                            by (kind, device, model version)

Plan JSON schema (version 1)::

    {
      "version": 1,
      "kind": "spmv" | "spmm" | "linear",
      "structure_hash": "<16-hex>",
      "n_cols": null | int,
      "device": "cuda" | "torchcpu",      # plans are device-specific
      "options": {<StagingOptions fields>},
      "timings": {"<candidate label>": seconds, ...},
      "num_workers": int,                   # best partition_block_rows split
      "meta": {"shape": [m, k], "num_blocks": int, "stored_nnz": int, ...},
      "source": "measured" | "heuristic" | "predicted" | "inherited",
      "reblock": {<ReblockSpec fields>}      # OPTIONAL — omitted when absent
    }

``reblock`` (core/reblock.py) is present only when the winning candidate
re-partitions the structure first: it pins the reblocked row/column
partitions and the REBLOCKED structure hash, so a warm restart applies
the recorded partitions directly (pure numpy gather build) — no DP, no
cost evaluation, zero benchmarks.  The reblocked structure itself is
stored in ``structures/`` under its own hash like any other.

``source`` provenance: ``measured`` plans carry micro-benchmark timings
and are the cost-model training corpus; ``predicted`` plans carry the
cost model's runtime *estimates* (never trained on — no feedback loop);
``heuristic``/``inherited`` plans carry no timings worth learning from.

Values are NEVER cached — only structure, exactly the paper's split of
staging-time structure vs runtime data.

Both packages default to the same root. The reference writes the device
segment ``jax.default_backend()`` (``cpu``, ``tpu``, ``gpu``); the port
writes ``cuda`` on the card and ``torchcpu`` on the CPU (``device_key``),
so a plan of one package never loads in the other: a reference plan may
name ``pallas``, and a port plan ``cuda`` and torch dtypes. The port's
options carry no ``interpret`` (written as null, to keep the schema's
keys) and write ``dtype`` by torch's name (``"float32"``,
``"bfloat16"``). Structures (``structures/*.npz``) are the same arrays
under the same hash in both, so either package may read them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from . import vbr as vbrlib
from .staging import StagingOptions

__all__ = [
    "PlanCache",
    "TuningPlan",
    "default_cache",
    "set_default_cache",
    "options_to_dict",
    "options_from_dict",
    "plan_key",
    "device_key",
]

PLAN_VERSION = 1

_STRUCTURE_FIELDS = ("rpntr", "cpntr", "bindx", "bpntrb", "bpntre", "indx")

# the port's device segments: none of them is a jax.default_backend() name
CPU_KEY = "torchcpu"


def device_key(device: torch.device) -> str:
    """The plan key's device segment for a torch device."""
    return "cuda" if torch.device(device).type == "cuda" else CPU_KEY


@dataclasses.dataclass
class TuningPlan:
    """The inspection-time decision record for one (kind, structure) pair.

    ``options`` always carries a *concrete* backend (never 'auto' or
    'autotune') so staging from a plan is deterministic.
    """

    kind: str
    structure_hash: str
    options: StagingOptions
    n_cols: Optional[int] = None
    device: str = CPU_KEY
    timings: dict = dataclasses.field(default_factory=dict)
    num_workers: int = 1
    meta: dict = dataclasses.field(default_factory=dict)
    source: str = "measured"
    # ReblockSpec dict (core/reblock.py) when the winner re-partitions the
    # structure first; None (and omitted from JSON) otherwise
    reblock: Optional[dict] = None

    @property
    def best_time(self) -> Optional[float]:
        return min(self.timings.values()) if self.timings else None

    def to_dict(self) -> dict:
        d = {
            "version": PLAN_VERSION,
            "kind": self.kind,
            "structure_hash": self.structure_hash,
            "n_cols": self.n_cols,
            "device": self.device,
            "options": options_to_dict(self.options),
            "timings": dict(self.timings),
            "num_workers": self.num_workers,
            "meta": dict(self.meta),
            "source": self.source,
        }
        if self.reblock is not None:
            d["reblock"] = dict(self.reblock)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TuningPlan":
        if d.get("version") != PLAN_VERSION:
            raise ValueError(f"unsupported plan version {d.get('version')}")
        return cls(
            kind=d["kind"],
            structure_hash=d["structure_hash"],
            options=options_from_dict(d["options"]),
            n_cols=d["n_cols"],
            device=d.get("device", CPU_KEY),
            timings=d.get("timings", {}),
            num_workers=d.get("num_workers", 1),
            meta=d.get("meta", {}),
            source=d.get("source", "measured"),
            reblock=d.get("reblock"),
        )


def options_to_dict(opts: StagingOptions) -> dict:
    return {
        "backend": opts.backend,
        "density_threshold": opts.density_threshold,
        "tile": list(opts.tile),
        "spmm_bn": opts.spmm_bn,
        "interpret": None,  # the reference's Pallas option; the port has none
        "prepack": opts.prepack,
        "dtype": None if opts.dtype is None else str(opts.dtype).removeprefix("torch."),
    }


def options_from_dict(d: dict) -> StagingOptions:
    dtype = d.get("dtype")
    if dtype is not None and not isinstance(getattr(torch, dtype, None), torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return StagingOptions(
        backend=d["backend"],
        density_threshold=d.get("density_threshold", 0.0),
        tile=tuple(d.get("tile", StagingOptions.tile)),
        spmm_bn=d.get("spmm_bn", 128),
        prepack=d.get("prepack", False),
        dtype=None if dtype is None else getattr(torch, dtype),
    )


def plan_key(
    kind: str,
    structure_hash: str,
    device: str,
    n_cols=None,
    shard_id=None,
    num_shards=None,
    model_cols=None,
    reblock: bool = False,
) -> str:
    """Filename-safe cache key.  Plans are per-device: the measured-best
    backend on the card (cuda) is not the best on the CPU (grouped).
    ``device`` is a ``device_key`` segment.

    Sharded staging keys per-shard plans by the PARENT structure hash plus
    ``(shard_id, num_shards)`` — ``...-s3of8`` — so a shard's tuned plan is
    found from the parent pattern without re-deriving the sub-structure
    hash.  ``num_shards`` alone (``...-x8``) keys whole-partition records.
    On a 2-D (shards x model) mesh the SpMM RHS is column-partitioned, so
    each shard stages for its LOCAL column count; ``model_cols`` —
    ``...-mc4`` — keys those plans apart from the full-width ones and a
    warm restart of the same mesh factorization re-benchmarks nothing.
    ``reblock=True`` appends ``-rb``: the plan was tuned with the EXTENDED
    candidate space (reblocking proposals + structure-detected backends,
    core/reblock.py / core/inspect.py).  A winner chosen from a larger
    candidate set must never alias — or be shadowed by — a plan tuned
    without those candidates, so the key segment separates the two worlds
    the same way ``device`` does.
    """
    parts = [kind, structure_hash, device]
    if n_cols is not None:
        parts.append(f"n{int(n_cols)}")
    if shard_id is not None:
        parts.append(f"s{int(shard_id)}of{int(num_shards or 0)}")
    elif num_shards is not None:
        parts.append(f"x{int(num_shards)}")
    if model_cols is not None:
        parts.append(f"mc{int(model_cols)}")
    if reblock:
        parts.append("rb")
    return "-".join(parts)


class PlanCache:
    """On-disk plan + structure store.  Safe for concurrent writers: files
    are written to a temp name and atomically renamed into place."""

    def __init__(self, root: Optional[str] = None):
        self.root = str(
            root
            or os.environ.get("REPRO_CACHE_DIR")
            or os.path.join(os.path.expanduser("~"), ".cache", "repro-sable")
        )

    # ------------------------------------------------------------------ #
    def _plan_path(self, key: str) -> str:
        return os.path.join(self.root, "plans", f"{key}.json")

    def _structure_path(self, structure_hash: str) -> str:
        return os.path.join(self.root, "structures", f"{structure_hash}.npz")

    @staticmethod
    def _atomic_write(path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # ------------------------------------------------------------------ #
    # plans
    # ------------------------------------------------------------------ #
    def load_plan(self, key: str) -> Optional[TuningPlan]:
        path = self._plan_path(key)
        try:
            with open(path, "rb") as f:
                return TuningPlan.from_dict(json.load(f))
        except FileNotFoundError:
            return None
        except (ValueError, KeyError, json.JSONDecodeError):
            # stale/corrupt entry: treat as a miss, let the writer replace it
            return None

    def store_plan(self, key: str, plan: TuningPlan) -> str:
        path = self._plan_path(key)
        self._atomic_write(
            path, json.dumps(plan.to_dict(), indent=1, sort_keys=True).encode()
        )
        return path

    def has_plan(self, key: str) -> bool:
        return os.path.exists(self._plan_path(key))

    def iter_plans(self, device: Optional[str] = None, kind: Optional[str] = None):
        """Yield every parseable cached plan, optionally filtered by
        device and kind — the cost-model training corpus walks this."""
        d = os.path.join(self.root, "plans")
        if not os.path.isdir(d):
            return
        for name in sorted(os.listdir(d)):
            if not name.endswith(".json"):
                continue
            plan = self.load_plan(name[: -len(".json")])
            if plan is None:
                continue
            if device is not None and plan.device != device:
                continue
            if kind is not None and plan.kind != kind:
                continue
            yield plan

    # ------------------------------------------------------------------ #
    # fitted cost models (core/cost_model.py)
    # ------------------------------------------------------------------ #
    def _model_path(self, key: str) -> str:
        return os.path.join(self.root, "models", f"{key}.json")

    def store_model(self, key: str, doc: dict) -> str:
        path = self._model_path(key)
        self._atomic_write(path, json.dumps(doc, sort_keys=True).encode())
        return path

    def load_model(self, key: str) -> Optional[dict]:
        try:
            with open(self._model_path(key), "rb") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except (ValueError, json.JSONDecodeError):
            return None  # corrupt entry: treat as a miss, refit replaces it

    # ------------------------------------------------------------------ #
    # structures (indirection arrays only — never val)
    # ------------------------------------------------------------------ #
    def store_structure(self, vbr: vbrlib.VBR) -> str:
        h = vbrlib.structure_hash(vbr)
        path = self._structure_path(h)
        if os.path.exists(path):
            return path
        import io

        buf = io.BytesIO()
        np.savez_compressed(
            buf,
            shape=np.asarray(vbr.shape, dtype=np.int64),
            **{f: getattr(vbr, f) for f in _STRUCTURE_FIELDS},
        )
        self._atomic_write(path, buf.getvalue())
        return path

    def load_structure(
        self, structure_hash: str, val: Optional[np.ndarray] = None
    ) -> Optional[vbrlib.VBR]:
        """Rebuild a VBR skeleton from the cache.  ``val`` (the runtime
        data) is supplied by the caller; defaults to zeros of the right
        length so the structure is immediately stageable."""
        path = self._structure_path(structure_hash)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            fields = {f: z[f] for f in _STRUCTURE_FIELDS}
            shape = tuple(int(s) for s in z["shape"])
        nnz = int(fields["indx"][-1]) if len(fields["indx"]) else 0
        if val is None:
            val = np.zeros((nnz,), dtype=np.float32)
        v = vbrlib.VBR(shape=shape, val=np.asarray(val), **fields)
        if vbrlib.structure_hash(v) != structure_hash:
            return None  # corrupt entry
        return v

    # ------------------------------------------------------------------ #
    def clear(self) -> int:
        """Remove every cached plan/structure; returns #files removed."""
        n = 0
        for sub in ("plans", "structures", "models"):
            d = os.path.join(self.root, sub)
            if not os.path.isdir(d):
                continue
            for name in os.listdir(d):
                if name.endswith((".json", ".npz")):
                    os.unlink(os.path.join(d, name))
                    n += 1
        return n

    def stats(self) -> dict:
        out = {"root": self.root, "plans": 0, "structures": 0, "models": 0}
        for sub, ext in (
            ("plans", ".json"),
            ("structures", ".npz"),
            ("models", ".json"),
        ):
            d = os.path.join(self.root, sub)
            if os.path.isdir(d):
                out[sub] = sum(1 for f in os.listdir(d) if f.endswith(ext))
        return out


# ---------------------------------------------------------------------- #
# process-wide default (tests point it at a tmpdir via REPRO_CACHE_DIR
# or set_default_cache)
# ---------------------------------------------------------------------- #
_DEFAULT: Optional[PlanCache] = None
_DEFAULT_EXPLICIT = False


def default_cache() -> PlanCache:
    """The process default.  An explicit ``set_default_cache`` wins over
    the environment; otherwise the root tracks ``$REPRO_CACHE_DIR``
    (including it being unset again)."""
    global _DEFAULT
    if not _DEFAULT_EXPLICIT:
        resolved = os.environ.get("REPRO_CACHE_DIR") or os.path.join(
            os.path.expanduser("~"), ".cache", "repro-sable"
        )
        if _DEFAULT is None or _DEFAULT.root != resolved:
            _DEFAULT = PlanCache()
    return _DEFAULT


def set_default_cache(cache: Optional[PlanCache]) -> None:
    """Pin the process default (wins over ``$REPRO_CACHE_DIR``); pass
    ``None`` to return to environment-driven resolution."""
    global _DEFAULT, _DEFAULT_EXPLICIT
    _DEFAULT = cache
    _DEFAULT_EXPLICIT = cache is not None
