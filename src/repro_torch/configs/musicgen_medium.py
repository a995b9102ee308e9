"""MusicGen-medium — 48L d_model=1536 24H (kv=24, plain MHA) d_ff=6144,
vocab 2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Modality stub (per assignment): the EnCodec audio frontend is NOT
implemented; the backbone consumes precomputed EnCodec *token* streams
(vocab 2048).  The real model sums 4 codebook embeddings per frame — the
stub treats the stream as a single token sequence, which preserves every
backbone shape.  RoPE replaces MusicGen's sinusoidal embedding (uniform
backbone; noted in DESIGN.md §hardware-adaptation).
"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab_size=2048,
    modality="audio_tokens",
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    modality="audio_tokens",
    act_dtype="float32",
    kv_chunk=32,
)

SPEC = ArchSpec(
    arch_id="musicgen-medium",
    source="[arXiv:2306.05284; hf]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=4,
    skip_cells=default_skips("dense"),
)
