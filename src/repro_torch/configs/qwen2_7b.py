"""qwen2-7b — dense GQA (kv=4) with QKV bias. [arXiv:2407.10671; hf]"""
from .base import ArchConfig, register

QWEN2_7B = register(ArchConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671",
))
