"""Architecture registry + shape cells of the LM stack.

The port of the JAX package's ``configs/registry.py``: every architecture
registers an :class:`ArchSpec` with its full-size
:class:`~repro_torch.models.transformer.ModelConfig` from the public config,
a reduced smoke config of the same family, and per-shape-cell metadata.
All ten architectures of the reference are ported (``PORTED``): the
``dense`` family (qwen2.5-3b, granite-8b, codeqwen1.5-7b, command-r-35b,
musicgen-medium, internvl2-26b with its vision prefix), ``moe``
(olmoe-1b-7b, deepseek-v2-236b with MLA), ``ssm`` (mamba2-1.3b) and
``hybrid`` (zamba2-7b).  :func:`get_arch` would raise
``NotImplementedError`` for an id registered but not in ``PORTED``.

Shape cells (fixed by the reference):

    train_4k      seq 4,096   × global batch 256
    prefill_32k   seq 32,768  × global batch 32
    decode_32k    seq 32,768  × global batch 128 (1 new token per sequence)
    long_500k     seq 524,288 × global batch 1 (ssm/hybrid only)
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.transformer import ModelConfig

__all__ = ["ArchSpec", "ShapeCell", "SHAPES", "ARCH_IDS", "PORTED",
           "get_arch", "cells_for", "default_skips"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str               # train | prefill | decode
    seq_len: int
    global_batch: int
    long_context: bool = False


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524_288, 1, long_context=True),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    source: str                      # public provenance ([arXiv/hf; tier])
    model: ModelConfig
    smoke: ModelConfig
    train_microbatches: int = 8      # gradient-accumulation steps for train_4k
    long_ctx_window: int = 4096      # sliding window used at long_500k (hybrid)
    skip_cells: dict[str, str] = dataclasses.field(default_factory=dict)

    def cell_config(self, cell: ShapeCell) -> ModelConfig:
        """ModelConfig specialized for one shape cell."""
        cfg = self.model
        if cell.long_context and cfg.family == "hybrid":
            cfg = dataclasses.replace(cfg, attn_window=self.long_ctx_window)
        if cell.kind != "train":
            # inference: bf16 weights, no remat (fp32 masters are train-only)
            cfg = dataclasses.replace(cfg, remat=False, param_dtype="bfloat16")
        elif cell.seq_len <= 4096:
            # at <= 4k the reference runs attention in a single kv chunk
            cfg = dataclasses.replace(cfg, kv_chunk=max(cfg.kv_chunk,
                                                        cell.seq_len))
        return cfg


_FULL_ATTN_SKIP = (
    "long_500k needs sub-quadratic attention history; this arch is pure "
    "full-attention (O(S) KV history per layer) — skipped per the shape "
    "rule, recorded in DESIGN.md §Arch-applicability"
)

ARCH_IDS: list[str] = [
    "olmoe-1b-7b",
    "deepseek-v2-236b",
    "musicgen-medium",
    "internvl2-26b",
    "granite-8b",
    "command-r-35b",
    "codeqwen1.5-7b",
    "qwen2.5-3b",
    "zamba2-7b",
    "mamba2-1.3b",
]
PORTED: tuple[str, ...] = ("qwen2.5-3b", "granite-8b", "codeqwen1.5-7b",
                           "olmoe-1b-7b", "deepseek-v2-236b", "mamba2-1.3b",
                           "zamba2-7b", "musicgen-medium", "command-r-35b",
                           "internvl2-26b")

_CACHE: dict[str, ArchSpec] = {}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md, Queue A item 8); "
            f"ported: {list(PORTED)}")
    if arch_id not in _CACHE:
        mod = importlib.import_module(
            "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
        _CACHE[arch_id] = mod.SPEC
    return _CACHE[arch_id]


def cells_for(spec: ArchSpec) -> list[ShapeCell]:
    """The runnable shape cells for an arch (skips excluded)."""
    return [c for n, c in SHAPES.items() if n not in spec.skip_cells]


def default_skips(family: str) -> dict[str, str]:
    if family in ("ssm", "hybrid"):
        return {}
    return {"long_500k": _FULL_ATTN_SKIP}
