"""llava-next-34b — VLM: decoder-LM backbone; anyres vision tiling is a
STUB: input_specs() provides 576 precomputed patch embeddings that are
prepended to the token embeddings. [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]"""
from .base import ArchConfig, register

LLAVA_NEXT_34B = register(ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    vision_prefix=576,
    rope_theta=5e6,
    optimizer="adafactor",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
