"""arctic-480b — 128-expert top-2 MoE + parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base].

35L, d_model=7168, 56H (GQA kv=8), d_ff=4864, vocab=32000.
Note: 56 heads are not divisible by the 16-way model axis; activation head
sharding is relaxed per DESIGN.md §4 (params still shard on the fused dim).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=32000,
    moe_num_experts=128,
    moe_top_k=2,
    moe_d_ff=4864,
    moe_dense_ff=4864,     # dense residual path
    moe_group_size=1024,   # §Perf iter 3: dispatch GEMM flops/token ∝ group
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    vocab_size=256, moe_num_experts=8, moe_top_k=2, moe_d_ff=32,
    moe_dense_ff=32, moe_group_size=64,
)
