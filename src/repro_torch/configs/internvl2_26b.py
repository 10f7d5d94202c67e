"""internvl2-26b — InternViT frontend (stub) + InternLM2 backbone
[arXiv:2404.16821].

48L, d_model=6144, 48H (GQA kv=8), d_ff=16384, vocab=92553 (padded to 92672
for 16-way TP; logical vocab preserved, padded logits masked in the loss).
The ViT is a STUB per the brief: input_specs() provides precomputed patch
embeddings for the first 256 positions.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    num_prefix_tokens=256,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=256, num_prefix_tokens=8,
)
