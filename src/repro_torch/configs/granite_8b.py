"""granite-8b — llama-arch code model [arXiv:2405.04324].

36L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=49152.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)
