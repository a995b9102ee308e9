"""Granite-8B-Code — 36L d_model=4096 32H (kv=8) d_ff=14336, vocab 49152 —
llama-arch, code.  [arXiv:2405.04324; hf]"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=49152,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=128,
    vocab_size=256,
    act_dtype="float32",
    kv_chunk=32,
)

SPEC = ArchSpec(
    arch_id="granite-8b",
    source="[arXiv:2405.04324; hf]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=8,
    skip_cells=default_skips("dense"),
)
