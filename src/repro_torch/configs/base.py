"""Architecture config system: one frozen dataclass describes every assigned
architecture; a registry maps ``--arch <id>`` to its exact config and a
smoke-reduced variant for CPU tests. The port's own copy of
``repro.configs.base`` (plain data, equal to it field for field).

Input-shape cells (assigned set): train_4k / prefill_32k / decode_32k /
long_500k. ``decode_*``/``long_*`` lower ``serve_step`` (1 new token against
a KV/recurrent cache of ``seq_len``); the others lower ``train_step`` /
``prefill``. long_500k is defined only for sub-quadratic archs
(DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default: d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    act: str = "silu"                       # mlp activation
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False            # arctic: dense FFN in parallel
    dense_residual_ff: int = 0              # width of the parallel dense FFN
    moe_group_tokens: int = 4096            # dispatch group size
    moe_expert_sharding: str = "tp"         # tp (baseline) | ep (§Perf)
    # --- MLA (minicpm3) ---
    mla: bool = False
    q_rank: int = 768
    kv_rank: int = 256
    rope_head_dim: int = 32
    nope_head_dim: int = 64
    v_head_dim: int = 64
    # --- hybrid (hymba): parallel attention + mamba heads ---
    hybrid_ssm: bool = False
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128                    # GLA/SSD chunk length (§Perf)
    swa_window: int = 0                     # 0 = full attention
    global_attn_layers: Tuple[int, ...] = ()  # layers with full attn
    meta_tokens: int = 0
    # --- xLSTM ---
    xlstm: bool = False
    slstm_group: int = 0                    # 1 sLSTM per `slstm_group` blocks
    # --- enc-dec (whisper) ---
    encdec: bool = False
    enc_layers: int = 0
    # --- vlm (llava) ---
    vision_prefix: int = 0                  # precomputed patch embeds (stub)
    # --- execution knobs (perf-tunable, see EXPERIMENTS.md §Perf) ---
    remat: str = "full"                     # nothing | dots | full
    loss_chunk: int = 2048                  # vocab-xent sequence chunking
    attn_q_block: int = 1024
    attn_kv_block: int = 1024
    flash_custom_vjp: bool = False    # hand-written flash backward (§Perf)
    row_parallel_out: bool = False    # Megatron row-parallel wo/w_out (§Perf)
    pad_vocab: bool = False           # pad V to 128 for vocab-TP (§Perf)
    swa_window_decode: bool = False   # SWA decode reads window only (§Perf)
    optimizer: str = "adam"                 # adam | adafactor (huge archs)
    param_dtype: str = "bfloat16"
    # provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.xlstm

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell."""
        return self.xlstm or (self.hybrid_ssm and self.swa_window > 0)

    def supports(self, shape: str) -> bool:
        cell = SHAPES[shape]
        if cell.name == "long_500k":
            return self.subquadratic
        return True

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers // 16 or 2)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads >= 4 else self.n_kv_heads,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            head_dim=32,
            q_rank=64, kv_rank=32, rope_head_dim=8, nope_head_dim=16,
            v_head_dim=16,
            n_experts=min(self.n_experts, 4) if self.moe else 0,
            dense_residual_ff=128 if self.dense_residual else 0,
            moe_group_tokens=64,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 4) if self.ssm_heads else 0,
            swa_window=min(self.swa_window, 32) if self.swa_window else 0,
            global_attn_layers=(0,) if self.global_attn_layers else (),
            meta_tokens=min(self.meta_tokens, 8),
            enc_layers=2 if self.encdec else 0,
            slstm_group=min(self.slstm_group, 2) if self.slstm_group else 0,
            vision_prefix=16 if self.vision_prefix else 0,
            loss_chunk=64, attn_q_block=64, attn_kv_block=64,
            param_dtype="float32",
        )


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # Import all config modules exactly once (they call register()).
    from . import (arctic_480b, hymba_1_5b, llava_next_34b,  # noqa: F401
                   minicpm3_4b, phi35_moe, qwen15_110b, qwen2_7b,
                   stablelm_3b, whisper_small, xlstm_350m)
