"""Command-R-35B — 40L d_model=8192 64H (kv=8) d_ff=22528, vocab 256000 —
GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01; unverified]

The 256k-vocab lm_head/embedding is the worked example of MAFIA-style
criticality-driven sharding: the planner's DFG optimizer assigns the logits
node the maximum PF (vocab fully sharded over the model axis).
"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=22528,
    vocab_size=256000,
)

SMOKE = ModelConfig(
    name="command-r-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=128,
    vocab_size=512,
    act_dtype="float32",
    kv_chunk=32,
)

SPEC = ArchSpec(
    arch_id="command-r-35b",
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=16,
    skip_cells=default_skips("dense"),
)
