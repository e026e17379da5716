"""arctic-480b — 128-expert top-2 MoE with a parallel dense-residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]

Adafactor optimizer: 480B params × fp32 Adam does not fit 16 GB/chip on a
single pod; factored second moment + bf16 momentum does (DESIGN.md §6).
"""
from .base import ArchConfig, register

ARCTIC_480B = register(ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    moe=True, n_experts=128, top_k=2,
    dense_residual=True, dense_residual_ff=4864,
    optimizer="adafactor",
    source="hf:Snowflake/snowflake-arctic-base",
))
