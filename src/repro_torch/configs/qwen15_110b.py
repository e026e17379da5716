"""qwen1.5-110b — largest dense arch; GQA kv=8, QKV bias.
[hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ArchConfig, register

QWEN15_110B = register(ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064,
    qkv_bias=True, rope_theta=1e6,
    optimizer="adafactor",
    source="hf:Qwen/Qwen1.5-0.5B",
))
