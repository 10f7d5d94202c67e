"""whisper-base — enc-dec audio model [arXiv:2212.04356].

6L encoder + 6L decoder, d_model=512, 8H, d_ff=2048, vocab=51865.
The conv frame frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, 1500, d_model). Adaptations (DESIGN.md §7): RMSNorm instead
of LayerNorm, RoPE decoder positions instead of learned embeddings — the
backbone compute/communication shape is preserved.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    gated_mlp=False,       # whisper uses plain GELU MLPs
    enc_layers=6,
    enc_seq=1500,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, enc_layers=2, enc_seq=32,
)
