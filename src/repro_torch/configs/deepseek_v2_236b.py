"""deepseek-v2-236b — MLA (kv_lora=512) + MoE 160e top-6, 2 shared experts
[arXiv:2405.04434].

60L, d_model=5120, 128H, per-expert d_ff=1536, vocab=102400.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,      # MLA: per-head K/V from the shared latent
    head_dim=128,
    d_ff=0,
    vocab_size=102400,
    moe_num_experts=160,
    moe_top_k=6,
    moe_d_ff=1536,
    moe_num_shared=2,
    mla_kv_lora=512,
    mla_rope_dim=64,
    moe_group_size=1024,   # §Perf iter 3: dispatch GEMM flops/token ∝ group
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    vocab_size=256, moe_num_experts=8, moe_top_k=2, moe_d_ff=32,
    moe_num_shared=1, mla_kv_lora=32, mla_rope_dim=16, moe_group_size=64,
)
