"""xlstm-350m — attention-free: mLSTM blocks with one sLSTM block per group
of 6 (20 mLSTM + 4 sLSTM over 24 layers); d_ff=0 — gating/up-projections
live inside the blocks. O(1) recurrent decode state ⇒ runs long_500k.
[arXiv:2405.04517; unverified]"""
from .base import ArchConfig, register

XLSTM_350M = register(ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    xlstm=True, slstm_group=6,
    source="arXiv:2405.04517",
))
