"""Input-shape cells: per-arch (shape -> step kind) and dry-run specs.

The port's copy of the JAX package's ``configs/shapes.py``.  The four
assigned LM shapes (seq_len x global_batch):
    train_4k     4,096 x 256   -> train_step
    prefill_32k  32,768 x 32   -> prefill_step
    decode_32k   32,768 x 128  -> decode_step (1 token, 32k cache)
    long_500k    524,288 x 1   -> decode_step (1 token, 500k cache/state)

``long_500k`` requires sub-quadratic attention: runnable for rwkv6
(O(1) state), recurrentgemma (RG-LRU + local window) and llama4-scout
(chunked-local iRoPE); skipped for the pure full-attention archs.
Whisper's shapes drive the *decoder* against the fixed 1500-frame
encoder stub.

``input_specs(cfg, shape)`` returns :class:`TensorSpec` stand-ins
(shape, dtype) in place of the reference's ``ShapeDtypeStruct``;
:func:`meta_inputs` turns them into meta tensors, which allocate
nothing.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.common import ModelConfig

I32 = torch.int32


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic decode)
LONG_OK = {"rwkv6_7b", "recurrentgemma_9b", "llama4_scout_17b_a16e"}


def runnable_cells():
    """All (arch, shape) cells with principled skips applied."""
    from . import ARCH_IDS
    cells = []
    for a in ARCH_IDS:
        for s in SHAPES:
            if s == "long_500k" and a not in LONG_OK:
                continue
            cells.append((a, s))
    return cells


def skip_reason(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch not in LONG_OK:
        return "pure full attention: 500k decode cache is quadratic-history"
    return None


def input_specs(cfg: ModelConfig, shape: str, *, reduced: bool = False,
                batch_override: int | None = None) -> dict:
    """:class:`TensorSpec` stand-ins for every model input of this cell."""
    cell = SHAPES[shape]
    b = batch_override or cell.global_batch
    t = cell.seq_len if not reduced else min(cell.seq_len, 64)

    specs: dict = {}
    if cell.kind in ("train", "prefill"):
        text_t = t - (cfg.frontend_len if cfg.frontend == "patch" else 0)
        specs["tokens"] = TensorSpec((b, text_t), I32)
        if cell.kind == "train":
            specs["labels"] = TensorSpec((b, text_t), I32)
        if cfg.frontend == "patch":
            specs["patches"] = TensorSpec((b, cfg.frontend_len,
                                           cfg.d_model), cfg.dtype)
        if cfg.frontend == "audio":
            specs["features"] = TensorSpec((b, cfg.enc_len, cfg.d_model),
                                           cfg.dtype)
    else:  # decode: one new token against a seq_len cache
        specs["tokens"] = TensorSpec((b, 1), I32)
    return specs


def meta_inputs(specs: dict) -> dict:
    """:func:`input_specs`' stand-ins as meta tensors (no storage)."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in specs.items()}


def cache_len(shape: str, reduced: bool = False) -> int:
    cell = SHAPES[shape]
    return cell.seq_len if not reduced else min(cell.seq_len, 64)
