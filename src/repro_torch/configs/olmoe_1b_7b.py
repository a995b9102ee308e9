"""OLMoE-1B-7B — 16L d_model=2048 16H (kv=16) expert d_ff=1024, vocab 50304,
MoE 64 experts top-8.  [arXiv:2409.02060; hf]"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=0,
    vocab_size=50304,
    n_experts=64,
    experts_per_token=8,
    d_ff_expert=1024,
)

SMOKE = ModelConfig(
    name="olmoe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=0,
    vocab_size=256,
    n_experts=8,
    experts_per_token=2,
    d_ff_expert=32,
    act_dtype="float32",
    kv_chunk=32,
)

SPEC = ArchSpec(
    arch_id="olmoe-1b-7b",
    source="[arXiv:2409.02060; hf]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=8,
    skip_cells=default_skips("moe"),
)
