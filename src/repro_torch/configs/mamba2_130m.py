"""mamba2-130m — SSD (state-space duality) [arXiv:2405.21060].

24L, d_model=768, attention-free, vocab=50280, ssm_state=128.
Screening applicability: backbone is not an L1-penalized linear model; the
paper's rule attaches as a sparse-probe head only (DESIGN.md §4).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,          # SSD heads = d_inner / ssm_head_dim
    num_kv_heads=24,       # unused (attention-free)
    d_ff=0,                # no separate FFN in mamba2 blocks
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, vocab_size=256,
    ssm_state=16, ssm_head_dim=32, ssm_chunk=32,
)
