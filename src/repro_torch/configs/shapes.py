"""Input shapes (seq_len x global_batch) and applicability rules (a copy of
``repro.configs.shapes``).

  train_4k     seq=4096    batch=256  -> train_step
  prefill_32k  seq=32768   batch=32   -> serve prefill
  decode_32k   seq=32768   batch=128  -> serve decode (1 token, KV @ 32k)
  long_500k    seq=524288  batch=1    -> long-context decode; ONLY for
               sub-quadratic archs (ssm / hybrid) — skipped (with a
               note) for pure full-attention models.

Enc-dec models: the source (speech-frame) length is seq_len // 4
(4x frontend downsampling, stubbed); target length is the shape's seq_len.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg, shape: Shape) -> tuple[bool, str]:
    """(applicable, reason-if-not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per assignment)"
        )
    return True, ""


def src_len(cfg, shape: Shape) -> int:
    """Encoder source length for enc-dec models."""
    return max(shape.seq_len // 4, 8)
