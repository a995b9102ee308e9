"""DeepSeek-V2-236B — 60L d_model=5120 128H, MLA kv_lora=512 q_lora=1536
(qk-nope 128 + decoupled rope 64 per head), vocab 102400, MoE 2 shared + 160
routed top-6, expert d_ff=1536.  [arXiv:2405.04434; hf]

Simplification recorded in DESIGN.md: the real model's first layer uses a
dense FFN; here all 60 layers are uniform MoE so the layer stack scans — the
parameter count difference is <0.5%.
"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,               # qk-nope / value dims per head
    d_ff=0,
    vocab_size=102400,
    n_experts=160,
    experts_per_token=6,
    n_shared_experts=2,
    d_ff_expert=1536,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    d_rope=64,
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
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
    n_shared_experts=2,
    d_ff_expert=32,
    use_mla=True,
    kv_lora_rank=32,
    q_lora_rank=24,
    d_rope=8,
    act_dtype="float32",
    kv_chunk=32,
)

SPEC = ArchSpec(
    arch_id="deepseek-v2-236b",
    source="[arXiv:2405.04434; hf]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=16,
    skip_cells=default_skips("moe"),
)
