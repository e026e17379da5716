"""Piecewise roofline accounting, the port of ``repro.roofline.piecewise``:
FLOP, byte, collective and memory totals of one step, built from one
instance of each distinct piece of the model times its trips:

    total = Σ_piece  trip_count(piece) × cost(piece)  +  top-level pieces

Pieces per arch: one per distinct layer kind (dense/moe/hybrid-swa/
hybrid-global/mlstm/slstm/enc/dec), the head (final norm, unembedding and
chunked cross-entropy), the embedding, the optimizer for training, and for
decode the per-layer cache-update step and the decode top. Training
pieces run forward and backward under the config's remat policy
(``transformer._remat``), so the recompute of non-reentrant checkpointing
is counted. sLSTM's sequential time loop is run at a 64-step window and
scaled linearly, and every other piece linear in S is run at most at
``LIN_CAP`` positions and scaled (per-position cost is constant in S).

The reference lowers each piece because XLA's ``cost_analysis`` counts a
scan body once. The port counts the eager ops of each piece once, on the
meta device, under ``analysis.CostCounter`` (kept entered around
``backward()``, so the grads and the recompute are counted): an eager
trace of every layer of a step takes minutes at the larger shapes, one
layer of each kind a second or less. Counting on meta takes the routes the
eager port takes off the card: the GLA engine of the hybrid (SSD) and
mLSTM pieces is the plain chunked ``ssm.gla_chunked``
(``ssm._engine`` launches the CUDA kernel only for tensors on the card),
so their counted work is the plain chunked GLA's.

Memory. Each piece also records its peak live bytes (``peak``), the bytes
its forward holds for its backward (``saved``, its input activations
included: in a step those are the previous piece's outputs) and the
parameter grads it leaves (``grads``). A step's temporary memory is estimated as

    mem_temp = Σ trips × max(saved, grads) + max over pieces of
               (peak − max(saved, grads))

the activations every layer keeps for backward (or, later in backward,
the grads that replace them), plus the largest transient of one piece.
Memory is traced at the config's own attention tiles, where those differ
from ``_analysis_cfg``'s (whose tiles only set how the causal mask is
counted, as the reference counts it).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..configs.base import SHAPES, ArchConfig
from ..models import zoo
from ..optim.optimizers import tree_leaves, tree_unflatten
from . import analysis as ra


@dataclasses.dataclass
class PieceCost:
    name: str
    trips: float
    flops: float            # per trip, per device
    bytes_: float
    coll_bytes: float
    coll_count: int
    transc: float = 0.0
    mm_flops: float = 0.0   # the matmuls' share of flops
    peak: float = 0.0       # peak live bytes of one trip
    saved: float = 0.0      # bytes the forward holds for the backward
    grads: float = 0.0      # parameter grads one trip leaves


def combine(pieces: List[PieceCost]) -> Dict[str, Any]:
    hold = [max(p.saved, p.grads) for p in pieces]
    return {
        "flops_dev": sum(p.flops * p.trips for p in pieces),
        "bytes_dev": sum(p.bytes_ * p.trips for p in pieces),
        "coll_bytes_dev": sum(p.coll_bytes * p.trips for p in pieces),
        "coll_count": int(sum(p.coll_count * p.trips for p in pieces)),
        "transc_dev": sum(p.transc * p.trips for p in pieces),
        "mem_temp_dev": sum(h * p.trips for h, p in zip(hold, pieces))
        + max((p.peak - h for h, p in zip(hold, pieces)), default=0.0),
        "pieces": {p.name: {"trips": p.trips, "flops": p.flops,
                            "bytes": p.bytes_, "coll": p.coll_bytes,
                            "transc": p.transc, "mm_flops": p.mm_flops,
                            "peak": p.peak,
                            "saved": p.saved, "grads": p.grads}
                   for p in pieces},
    }


# ---------------------------------------------------------------------------
# Running a piece: a forward and the tensors to differentiate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PieceRun:
    """One piece ready to run: ``forward()`` returns the loss (or the
    outputs, when ``inputs`` is None: no backward); the grads are taken of
    ``inputs``, whose first ``n_params`` are parameters."""

    forward: Callable[[], Any]
    inputs: Optional[Sequence[torch.Tensor]] = None
    n_params: int = 0


def execute(run: PieceRun,
            after_forward: Optional[Callable[[], None]] = None):
    """Run the piece once, backward included: the forward's result, or
    the grads (``after_forward()`` is called between the two)."""
    if run.inputs is None:
        with torch.no_grad():
            return run.forward()
    with torch.enable_grad():
        loss = run.forward()
        if after_forward is not None:
            after_forward()
        return torch.autograd.grad(loss, list(run.inputs), allow_unused=True,
                                   materialize_grads=True)


def measure_run(run: PieceRun) -> Dict[str, float]:
    """``CostCounter``'s totals of one run of the piece, with ``saved``
    (the bytes live between forward and backward, its input activations
    included: in a step those come from the piece before it, and its
    backward holds them too) and ``grads`` (its parameters' grads)."""
    counter = ra.CostCounter()
    live = []
    with counter:
        out = execute(run, lambda: live.append(counter.live))
        grads = 0 if run.inputs is None else sum(
            ra._nbytes(g) for g in out[:run.n_params])
        del out
    totals = counter.totals()
    saved = 0 if run.inputs is None else live[0] + sum(
        ra._nbytes(t) for t in run.inputs[run.n_params:])
    totals.update(saved=float(saved), grads=float(grads))
    return totals


def _piece(name: str, trips: float, counted: Dict[str, float],
           memory: Optional[Dict[str, float]] = None,
           scale: float = 1.0) -> PieceCost:
    mem = counted if memory is None else memory
    return PieceCost(name=name, trips=trips,
                     flops=counted["flops"] * scale,
                     bytes_=counted["bytes"] * scale,
                     coll_bytes=counted["coll_bytes"] * scale,
                     coll_count=int(counted["coll_count"]),
                     transc=counted["transcendentals"] * scale,
                     mm_flops=counted["mm_flops"] * scale,
                     peak=mem["peak_bytes"] * scale,
                     saved=mem["saved"] * scale, grads=mem["grads"])


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _x(cfg: ArchConfig, b: int, s: int, device, gen, grad: bool):
    if device == "meta" or gen is None:
        x = torch.empty((b, s, cfg.d_model), dtype=_dtype(cfg),
                        device=device)
    else:
        x = torch.randn((b, s, cfg.d_model), generator=gen,
                        device=device).to(_dtype(cfg))
    return x.requires_grad_(grad)


def _live(params) -> List[torch.Tensor]:
    return [p.detach().requires_grad_() for p in tree_leaves(params)]


def _check_mesh(mesh) -> None:
    if mesh is not None and mesh.size != 1:
        raise ValueError(f"the port's roofline prices one card; the mesh "
                         f"{mesh.name} holds {mesh.size} devices")


# ---------------------------------------------------------------------------
# Piece construction
# ---------------------------------------------------------------------------

def layer_plan_pieces(cfg: ArchConfig, s_total: int):
    """[(name, kind, window, trips, s_piece, scale)] — scale multiplies the
    measured cost (linear-in-S pieces run at a shorter window)."""
    LIN_CAP = 4352                        # run linear pieces at <= this S
    out = []
    if cfg.xlstm:
        g = cfg.slstm_group
        ng = cfg.n_layers // g
        sp = min(s_total, 2048)
        out.append(("mlstm", "mlstm", 0, ng * (g - 1), sp, s_total / sp))
        sp_s = min(s_total, 64)
        out.append(("slstm", "slstm", 0, ng, sp_s, s_total / sp_s))
        return out
    if cfg.hybrid_ssm:
        n_glob = len(cfg.global_attn_layers)
        sp = min(s_total, LIN_CAP)
        out.append(("hybrid_swa", "hybrid", cfg.swa_window,
                    cfg.n_layers - n_glob, sp, s_total / sp))
        out.append(("hybrid_global", "hybrid", 0, n_glob, s_total, 1.0))
        return out
    kind = "moe" if cfg.moe else "dense"
    out.append((kind, kind, 0, cfg.n_layers, s_total, 1.0))
    return out


ANALYSIS_BLOCK = 4096   # attention tiling of the counted pieces: only the
                        # causal-mask granularity depends on it, and the
                        # reference counts at this tiling.


def _analysis_cfg(cfg: ArchConfig) -> ArchConfig:
    # SWA archs: tiles must not exceed the window, or the blockwise loop
    # loses its ability to skip out-of-window KV blocks and the analysis
    # over-counts FLOPs that the real kernel never does.
    blk = ANALYSIS_BLOCK
    if cfg.swa_window:
        blk = min(1024, max(cfg.swa_window, 128))
    return dataclasses.replace(cfg, attn_q_block=blk, attn_kv_block=blk)


def _counted(make: Callable[[ArchConfig], PieceRun], cfg: ArchConfig):
    """(counts at ``_analysis_cfg``, memory at the config's own tiles or
    None where the two are the same)."""
    acfg = _analysis_cfg(cfg)
    counted = measure_run(make(acfg))
    same = (acfg.attn_q_block, acfg.attn_kv_block) == (
        cfg.attn_q_block, cfg.attn_kv_block)
    return counted, None if same else measure_run(make(cfg))


def train_layer_run(cfg: ArchConfig, kind: str, window: int, b: int, s: int,
                    fwd_only: bool = False, device="meta",
                    gen: Optional[torch.Generator] = None) -> PieceRun:
    """One layer of ``kind`` on [b, s, d]: forward (the sum of its output
    and aux loss), and with ``fwd_only`` False the grads of its parameters
    and input, under the config's remat policy. ``device`` "meta" counts;
    on the card the weights and input are drawn with ``gen``."""
    from ..models.transformer import _apply_layer, _init_layer, _remat
    lp = _init_layer(cfg, gen, kind, (), device)
    x = _x(cfg, b, s, device, gen, not fwd_only)
    positions = torch.arange(s, device=device)[None].expand(b, s)

    def body(lp_, xx):
        return _apply_layer(cfg, lp_, xx, positions, kind, window)

    if fwd_only:
        def fwd():
            y, aux = body(lp, x)
            return torch.sum(y).float() + aux
        return PieceRun(fwd)
    live = _live(lp)
    rb = _remat(body, cfg.remat)

    def fwd():
        y, aux = rb(tree_unflatten(lp, live), x)
        return torch.sum(y).float() + aux
    return PieceRun(fwd, live + [x], len(live))


def _train_layer_piece(cfg: ArchConfig, kind: str, window: int,
                       b: int, s: int, name: str, trips: float,
                       scale: float, fwd_only: bool = False) -> PieceCost:
    counted, memory = _counted(
        lambda c: train_layer_run(c, kind, window, b, s, fwd_only), cfg)
    return _piece(name, trips, counted, memory, scale)


def encdec_layer_run(cfg: ArchConfig, which: str, b: int, s: int,
                     fwd_only: bool, device="meta",
                     gen: Optional[torch.Generator] = None) -> PieceRun:
    """One encoder (``which`` "enc") or decoder layer of whisper's
    backbone on [b, s, d] (a decoder layer against an encoder output of
    the same shape), as ``train_layer_run``."""
    from ..models import encdec as ed
    from ..models.transformer import _remat
    init = ed._init_enc_layer if which == "enc" else ed._init_dec_layer
    lp = init(cfg, gen, (), device)
    positions = torch.arange(s, device=device)[None].expand(b, s)
    xs = [_x(cfg, b, s, device, gen, not fwd_only)
          for _ in range(1 if which == "enc" else 2)]
    if which == "enc":
        def body(lp_, xx):
            return ed._enc_layer(cfg, lp_, xx, positions)
    else:
        def body(lp_, xx, enc):
            return ed._dec_layer(cfg, lp_, xx, positions, enc)

    if fwd_only:
        return PieceRun(lambda: torch.sum(body(lp, *xs)).float())
    live = _live(lp)
    rb = _remat(lambda lp_, *a: torch.sum(body(lp_, *a)).float(), cfg.remat)
    return PieceRun(lambda: rb(tree_unflatten(lp, live), *xs), live + xs,
                    len(live))


def _encdec_layer_piece(cfg: ArchConfig, which: str, b: int, s: int,
                        trips: float, fwd_only: bool) -> PieceCost:
    counted, memory = _counted(
        lambda c: encdec_layer_run(c, which, b, s, fwd_only), cfg)
    return _piece(f"{which}_layer", trips, counted, memory)


def head_run(cfg: ArchConfig, b: int, s_text: int, fwd_only: bool,
             device="meta") -> PieceRun:
    """Final norm + unembed + chunked xent (+ grads)."""
    from ..models.layers import chunked_xent, rmsnorm
    dt = _dtype(cfg)
    norm = torch.empty((cfg.d_model,), dtype=dt, device=device)
    w = torch.empty((cfg.d_model, cfg.vocab), dtype=dt, device=device)
    x = _x(cfg, b, s_text, device, None, not fwd_only)
    labels = torch.empty((b, s_text), dtype=torch.int32, device=device)

    def fn(norm_w, w_un, xx):
        h = rmsnorm(norm_w, xx, cfg.norm_eps)
        return chunked_xent(h, w_un, labels, cfg.loss_chunk,
                            pad_vocab=cfg.pad_vocab)

    if fwd_only:
        return PieceRun(lambda: fn(norm, w, x))
    live = _live([norm, w])
    return PieceRun(lambda: fn(*live, x), live + [x], 2)


def _head_piece(cfg: ArchConfig, b: int, s_text: int,
                fwd_only: bool) -> PieceCost:
    return _piece("head", 1.0, measure_run(head_run(cfg, b, s_text,
                                                     fwd_only)))


def embed_run(cfg: ArchConfig, b: int, s_text: int, fwd_only: bool,
              device="meta") -> PieceRun:
    emb = torch.empty((cfg.vocab, cfg.d_model), dtype=_dtype(cfg),
                      device=device)
    toks = torch.empty((b, s_text), dtype=torch.int64, device=device)
    if fwd_only:
        return PieceRun(lambda: torch.sum(emb[toks].float()))
    live = _live([emb])
    return PieceRun(lambda: torch.sum(live[0][toks].float()), live, 1)


def _embed_piece(cfg: ArchConfig, b: int, s_text: int,
                 fwd_only: bool) -> PieceCost:
    return _piece("embed", 1.0, measure_run(embed_run(cfg, b, s_text,
                                                       fwd_only)))


def optimizer_run(cfg: ArchConfig) -> PieceRun:
    """The optimizer's update of every parameter (``optim.get_optimizer``),
    on the meta device."""
    from ..optim import get_optimizer
    params = zoo.abstract_params(cfg)
    opt_init, opt_update = get_optimizer(cfg.optimizer)
    state = opt_init(params)
    grads = tree_unflatten(params, [torch.empty_like(p)
                                for p in tree_leaves(params)])
    return PieceRun(lambda: opt_update(params, grads, state, 1e-4))


def _optimizer_piece(cfg: ArchConfig) -> PieceCost:
    return _piece("optimizer", 1.0, measure_run(optimizer_run(cfg)))


# ---------------------------------------------------------------------------
# Decode pieces
# ---------------------------------------------------------------------------

def _strip(tree, n_lead: int):
    """One layer's slice of a stacked (meta) cache tree: new tensors
    without the ``n_lead`` leading dims."""
    if isinstance(tree, dict):
        return {k: _strip(v, n_lead) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_strip(v, n_lead) for v in tree)
    return torch.empty(tree.shape[n_lead:], dtype=tree.dtype,
                       device=tree.device)


def decode_layer_run(cfg: ArchConfig, shape_name: str, kind: str,
                     window: int) -> PieceRun:
    """One layer's one-token decode against its full cache slice, on the
    meta device, at cache_len = the cache's last position."""
    from ..models.layers import mlp, rmsnorm
    from ..models.transformer import _decode_layer, _init_layer
    cell = SHAPES[shape_name]
    b = cell.global_batch
    cache_full = zoo.abstract_cache(cfg, shape_name)
    if cfg.encdec:
        from ..models import encdec as ed
        lp = ed._init_dec_layer(cfg, None, (), "meta")
    else:
        lp = _init_layer(cfg, None, kind, (), "meta")
    if cfg.xlstm:
        sub = (_strip(cache_full["m"], 2) if kind == "mlstm"
               else _strip(cache_full["s"], 1))
    elif cfg.hybrid_ssm:
        sub = _strip(cache_full["swa"], 1)
    else:
        sub = _strip(cache_full, 1)
    x = torch.empty((b, 1, cfg.d_model), dtype=_dtype(cfg), device="meta")
    seq = next((t.shape[1] for t in tree_leaves(sub) if t.dim() >= 3
                and not cfg.xlstm), cell.seq_len)
    cache_len = seq - 1

    if cfg.encdec:
        from ..models import attention as at
        from ..models import encdec as ed

        def fn():
            h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
            a, _ = at.gqa_decode(lp["self_attn"], h, sub, cache_len,
                                 **ed._kw(cfg))
            xx = x + a
            hx = rmsnorm(lp["ln_x"], xx, cfg.norm_eps)
            q = (hx @ lp["cross_attn"]["wq"]).reshape(
                b, 1, cfg.n_heads, cfg.resolved_head_dim)
            xa = at.decode_attention(q, sub["xk"], sub["xv"],
                                     sub["xk"].shape[1])
            xx = xx + xa.reshape(b, 1, -1) @ lp["cross_attn"]["wo"]
            h2 = rmsnorm(lp["ln2"], xx, cfg.norm_eps)
            return xx + mlp(lp["mlp"], h2, cfg.act)
    else:
        def fn():
            return _decode_layer(cfg, lp, sub, x, cache_len, kind, window)
    return PieceRun(fn)


def _decode_layer_piece(cfg: ArchConfig, shape_name: str, kind: str,
                        window: int, name: str, trips: float) -> PieceCost:
    return _piece(name, trips, measure_run(
        decode_layer_run(cfg, shape_name, kind, window)))


def decode_top_run(cfg: ArchConfig, b: int) -> PieceRun:
    """Embed gather (1 token) + final norm + unembed matmul."""
    from ..models.layers import rmsnorm
    dt = _dtype(cfg)
    emb = torch.empty((cfg.vocab, cfg.d_model), dtype=dt, device="meta")
    w = torch.empty((cfg.d_model, cfg.vocab), dtype=dt, device="meta")
    norm = torch.empty((cfg.d_model,), dtype=dt, device="meta")
    tok = torch.empty((b, 1), dtype=torch.int64, device="meta")

    def fn():
        x = rmsnorm(norm, emb[tok], cfg.norm_eps)
        return (x[:, 0] @ w).float()
    return PieceRun(fn)


def _decode_top_piece(cfg: ArchConfig, b: int) -> PieceCost:
    return _piece("decode_top", 1.0, measure_run(decode_top_run(cfg, b)))


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def analyze_cell_piecewise(cfg: ArchConfig, shape_name: str, mesh=None, *,
                           batch: Optional[int] = None,
                           seq: Optional[int] = None) -> Dict[str, Any]:
    """The reference's dict (``combine``) for one cell on one card
    (``mesh`` None or of one device); ``batch`` and ``seq`` replace the
    cell's for train and prefill cells (a smaller run of the same
    step)."""
    _check_mesh(mesh)
    cell = SHAPES[shape_name]
    b, s = batch or cell.global_batch, seq or cell.seq_len
    pieces: List[PieceCost] = []
    if cell.kind in ("train", "prefill"):
        fwd = cell.kind == "prefill"
        s_total = s
        s_text = s
        if cfg.vision_prefix:
            s_text = s - cfg.vision_prefix
        if cfg.meta_tokens:
            s_total = s + cfg.meta_tokens
        if cfg.encdec:
            pieces.append(_encdec_layer_piece(cfg, "enc", b, s,
                                              cfg.enc_layers, fwd))
            pieces.append(_encdec_layer_piece(cfg, "dec", b, s,
                                              cfg.n_layers, fwd))
        else:
            for (name, kind, window, trips, sp, scale) in \
                    layer_plan_pieces(cfg, s_total):
                pieces.append(_train_layer_piece(
                    cfg, kind, window, b, sp, name, trips, scale,
                    fwd_only=fwd))
        pieces.append(_head_piece(cfg, b, s_text, fwd))
        pieces.append(_embed_piece(cfg, b, s_text, fwd))
        if cell.kind == "train":
            pieces.append(_optimizer_piece(cfg))
    else:
        if cfg.encdec:
            pieces.append(_decode_layer_piece(
                cfg, shape_name, "dense", 0, "dec_layer",
                cfg.n_layers))
        elif cfg.xlstm:
            g = cfg.slstm_group
            ng = cfg.n_layers // g
            pieces.append(_decode_layer_piece(cfg, shape_name,
                                              "mlstm", 0, "mlstm",
                                              ng * (g - 1)))
            pieces.append(_decode_layer_piece(cfg, shape_name,
                                              "slstm", 0, "slstm", ng))
        elif cfg.hybrid_ssm:
            pieces.append(_decode_layer_piece(
                cfg, shape_name, "hybrid", cfg.swa_window, "hybrid",
                cfg.n_layers))
        else:
            kind = "moe" if cfg.moe else "dense"
            pieces.append(_decode_layer_piece(cfg, shape_name, kind,
                                              0, kind, cfg.n_layers))
        pieces.append(_decode_top_piece(cfg, b))
    return combine(pieces)


def whole_step_run(cfg: ArchConfig, shape_name: str,
                   batch: Optional[int] = None,
                   seq: Optional[int] = None) -> PieceRun:
    """The whole step of a cell on the meta device, through the entry
    points a user calls (``launch.steps``): ``make_train_step``'s step
    (optimizer included), ``make_prefill_step``'s or ``make_serve_step``'s
    one-token decode against the cell's cache."""
    from ..launch import steps
    cell = SHAPES[shape_name]
    b, s = batch or cell.global_batch, seq or cell.seq_len
    params = zoo.abstract_params(cfg)
    if cell.kind == "decode":
        cache = zoo.abstract_cache(cfg, shape_name)
        token = torch.empty((cell.global_batch, 1), dtype=torch.int64,
                            device="meta")
        serve = steps.make_serve_step(cfg)
        return PieceRun(lambda: serve(params, cache, cell.seq_len - 1,
                                      token))
    data = zoo.make_batch(cfg, shape_name, b, s, None, "meta")
    if cell.kind == "prefill":
        prefill = steps.make_prefill_step(cfg)
        return PieceRun(lambda: prefill(params, data))
    train_step, opt_init = steps.make_train_step(cfg)
    state = opt_init(params)
    return PieceRun(lambda: train_step(params, state, data))


def analyze_cell_whole(cfg: ArchConfig, shape_name: str,
                       batch: Optional[int] = None,
                       seq: Optional[int] = None) -> Dict[str, float]:
    """``CostCounter``'s totals of the whole step (``whole_step_run``), at
    the config's own attention tiles: its ``peak_bytes`` is the step's
    temporary memory, traced op by op. An eager trace of every layer:
    seconds to minutes a cell at full size (module docstring)."""
    return measure_run(whole_step_run(cfg, shape_name, batch, seq))
