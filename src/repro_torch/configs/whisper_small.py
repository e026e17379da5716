"""whisper-small — enc-dec backbone; conv audio frontend is a STUB: the
encoder consumes precomputed frame embeddings from input_specs()
(DESIGN.md §5). [arXiv:2212.04356; unverified]

Full attention everywhere ⇒ long_500k skipped. Decode runs (it has a
decoder with self- and cross-attention caches).
"""
from .base import ArchConfig, register

WHISPER_SMALL = register(ArchConfig(
    name="whisper-small",
    family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865,
    encdec=True, enc_layers=12,
    act="gelu",
    source="arXiv:2212.04356",
))
