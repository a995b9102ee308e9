"""Qwen2.5-3B — 36L d_model=2048 16H (kv=2) d_ff=11008, vocab 151936 —
GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_head=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    act_dtype="float32",
    kv_chunk=32,
)

SPEC = ArchSpec(
    arch_id="qwen2.5-3b",
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=4,
    skip_cells=default_skips("dense"),
)
