"""Zamba2-7B — 81L d_model=3584 (Mamba2 backbone, ssm_state=64) with a
*shared* attention block (32H, kv=32) + MLP (d_ff=14336) applied every 6th
layer at 2×d_model over concat(hidden, initial embedding), vocab 32000.
[arXiv:2411.15242; unverified]

Structure simplification (DESIGN.md §Arch-applicability): real Zamba2-7B
alternates two shared blocks with per-application LoRA deltas; here a single
shared block (weights literally shared across its 13 applications) is
applied every ``hybrid_attn_every=6`` layers — 68 Mamba2 layers + 13 shared
applications = 81 block applications.  At long_500k the shared attention
uses a 4096-token sliding-window ring cache (SSM state is O(1)).
"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_head=224,               # shared block runs at 2·d_model / 32 heads
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=7,
    d_model=32,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=64,
    vocab_size=256,
    ssm_state=8,
    ssm_head_dim=8,
    ssm_chunk=8,
    hybrid_attn_every=3,
    act_dtype="float32",
    kv_chunk=32,
)

SPEC = ArchSpec(
    arch_id="zamba2-7b",
    source="[arXiv:2411.15242; unverified]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=8,
    long_ctx_window=4096,
    skip_cells=default_skips("hybrid"),
)
