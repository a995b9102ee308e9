"""InternVL2-26B — LM backbone (InternLM2-20B): 48L d_model=6144 48H (kv=8)
d_ff=16384, vocab 92553.  [arXiv:2404.16821; hf]

Modality stub (per assignment): the InternViT-6B vision tower is NOT
implemented; ``input_specs()`` supplies precomputed patch embeddings
(B, vision_prefix_len, d_model) that are prepended to the token embeddings.
The loss masks the vision prefix.
"""

from repro_torch.configs.registry import ArchSpec, default_skips
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=92553,
    modality="vision_prefix",
    vision_prefix_len=1024,          # ~4 tiles × 256 patch tokens
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_head=8,
    d_ff=128,
    vocab_size=256,
    modality="vision_prefix",
    vision_prefix_len=8,
    act_dtype="float32",
    kv_chunk=32,
)

SPEC = ArchSpec(
    arch_id="internvl2-26b",
    source="[arXiv:2404.16821; hf]",
    model=CONFIG,
    smoke=SMOKE,
    train_microbatches=16,
    skip_cells=default_skips("dense"),
)
