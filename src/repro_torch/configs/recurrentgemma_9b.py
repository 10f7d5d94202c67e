"""recurrentgemma-9b — RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427 (Griffin)].

38L (12 x (rec, rec, attn) + (rec, rec)), d_model=4096, 16H (MQA kv=1),
d_ff=12288, vocab=256000, local window 2048. Sub-quadratic state => eligible
for the long_500k decode cell.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    hybrid_pattern=("rec", "rec", "attn"),
    attn_window=2048,
    rnn_width=4096,
    gated_mlp=True,
)

SMOKE = CONFIG.replace(
    num_layers=5,  # exercises both segments: 1 full unit + (rec, rec) rest
    d_model=64, num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
    vocab_size=256, attn_window=16, rnn_width=64,
)
