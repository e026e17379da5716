"""minicpm3-4b — dense with Multi-head Latent Attention (MLA).
[hf:openbmb/MiniCPM3-4B; hf]

MLA ranks follow the model card: q_lora_rank=768, kv_lora_rank=256,
qk_rope_head_dim=32, qk_nope_head_dim=64, v_head_dim=64 (40 heads).
"""
from .base import ArchConfig, register

MINICPM3_4B = register(ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448,
    mla=True, q_rank=768, kv_rank=256,
    rope_head_dim=32, nope_head_dim=64, v_head_dim=64,
    source="hf:openbmb/MiniCPM3-4B",
))
