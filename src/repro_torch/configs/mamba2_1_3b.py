"""Mamba2-1.3B — 48L d_model=2048, attention-free SSD (state-space duality),
ssm_state=128, vocab 50280 (padded to 50304 for even vocab sharding).
[arXiv:2405.21060; unverified]

MAFIA applicability note (DESIGN.md §Arch-applicability): the paper's
*attention-sharding* aspects are inapplicable (no KV); per-node PF
assignment applies to the SSD block matmuls and projections, which is what
the sharding planner optimizes here.
"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=32,
    vocab_size=256,
    ssm_state=8,
    ssm_head_dim=8,
    ssm_chunk=8,
    act_dtype="float32",
)

SPEC = ArchSpec(
    arch_id="mamba2-1.3b",
    source="[arXiv:2405.21060; unverified]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=4,
    skip_cells=default_skips("ssm"),
)
