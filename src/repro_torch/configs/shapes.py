"""The four assigned input shapes + per-arch applicability rules.

  train_4k     seq 4,096   global_batch 256   lowers ``train_step``
  prefill_32k  seq 32,768  global_batch 32    lowers ``prefill_step``
  decode_32k   seq 32,768  global_batch 128   lowers ``serve_step`` (1 tok)
  long_500k    seq 524,288 global_batch 1     lowers ``serve_step`` (1 tok)

``long_500k`` requires sub-quadratic attention: it runs only for the
SSM/hybrid archs (zamba2-1.2b, xlstm-350m); pure full-attention archs
skip it (recorded in the roofline table). No encoder-only archs are
assigned, so decode shapes never skip.

The port's copy of ``src/repro/configs/shapes.py`` (lines 1-49), numpy
and plain Python as there, so that its float operations run in the same
order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}


def input_shape(name: str) -> Shape:
    return SHAPES[name]


def cells_for(cfg) -> List[Tuple[str, str]]:
    """All applicable (arch, shape) cells for a ModelConfig, plus the
    skip list [(shape, reason)] for the roofline table."""
    cells, skips = [], []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic:
            skips.append((s.name, "full attention is O(S^2)/O(S) per "
                                  "token at 500k — skipped per assignment"))
            continue
        cells.append((cfg.name, s.name))
    return cells, skips
