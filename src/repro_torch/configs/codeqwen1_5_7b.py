"""CodeQwen1.5-7B — 32L d_model=4096 32H (kv=32, MHA) d_ff=13440,
vocab 92416 — qwen1.5-arch (QKV bias).  [hf:Qwen/CodeQwen1.5-7B; hf]"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_head=128,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="codeqwen-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab_size=256,
    qkv_bias=True,
    act_dtype="float32",
    kv_chunk=32,
)

SPEC = ArchSpec(
    arch_id="codeqwen1.5-7b",
    source="[hf:Qwen/CodeQwen1.5-7B; hf]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=8,
    skip_cells=default_skips("dense"),
)
