"""stablelm-3b — dense MHA. [hf:stabilityai/stablelm-2-1_6b; unverified]"""
from .base import ArchConfig, register

STABLELM_3B = register(ArchConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304,
    source="hf:stabilityai/stablelm-2-1_6b",
))
