"""hymba-1.5b — hybrid: every layer runs attention and mamba(SSD) heads in
parallel and fuses their outputs; sliding-window attention except 3 global
layers; 128 learned meta tokens prepended. [arXiv:2411.13676; hf]

Sub-quadratic (SWA + SSM) ⇒ runs the long_500k cell.
"""
from .base import ArchConfig, register

HYMBA_1_5B = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    hybrid_ssm=True, ssm_state=16, ssm_heads=25, ssm_expand=2,
    swa_window=1024, global_attn_layers=(0, 16, 31),
    meta_tokens=128,
    source="arXiv:2411.13676",
))
