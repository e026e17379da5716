"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from .base import ArchConfig, register

PHI35_MOE = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab=32064,
    moe=True, n_experts=16, top_k=2,
    rope_theta=10000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
))
