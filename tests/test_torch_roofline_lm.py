"""The one-card roofline of the LM substrate (``repro_torch.roofline.
analysis``, ``piecewise``, ``report``) against the JAX reference
(``repro.roofline``) on the CPU.

Exact: ``count_params``, ``count_active_params`` and ``model_flops`` of
every arch at full size; ``layer_plan_pieces`` and ``_analysis_cfg``; the
matmul flops of a piece against their closed form (2·M·N·K a product);
the pieces' matmul flops summed by their trips against a whole-step count;
``report``'s text on a fixed JSON. The CLIs:
``tests/test_torch_dryrun_cli.py``.

Within a stated band (measured on the CPU, smoke configs at
B=2 S=256):
- total piece flops against the reference's XLA:CPU
  ``analyze_cell_piecewise`` on a (1, 1) mesh: within 5% for train and
  prefill cells (measured 0.992–1.024: the two count elementwise work
  op by op in slightly different ops), 15% for decode (measured 1.115,
  where a decode step's few flops are mostly elementwise).
  Bytes are reported as a ratio with no gate: the port counts unfused
  eager traffic, XLA the bytes of its fused program (measured 1.6–1.9);
- the pieces summed by their trips against a whole-step count on the meta
  device where every scale is 1 (B=2 S=64): flops within 1% (the step's
  grad norm, lr and loss sum, measured 0.996–1.0006), bytes within 20%
  (measured 0.89–1.01), and the piecewise memory estimate within
  [0.75, 1.5] of the whole trace's peak (measured 0.88–1.28).
"""

import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch.configs import base as t_base
from repro_torch.launch.sharding import flatten_with_path
from repro_torch.models import zoo as t_zoo
from repro_torch.roofline import analysis as t_ra
from repro_torch.roofline import piecewise as t_pw
from repro_torch.roofline import report as t_report

try:
    import jax

    from repro import configs as j_configs
    from repro.configs import base as j_base
    from repro.models import zoo as j_zoo
    from repro.roofline import analysis as j_ra
    from repro.roofline import piecewise as j_pw
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    jax = None

ARCHS = t_configs.list_archs()
#: Small cells of the three kinds, added to both packages' SHAPES.
TINY = {"tiny_train": (256, 2, "train"), "tiny_prefill": (256, 2, "prefill"),
        "tiny_decode": (256, 2, "decode"), "unit_train": (64, 2, "train"),
        "unit_prefill": (64, 2, "prefill"), "unit_decode": (64, 2, "decode")}
XLA_FLOPS_BAND = {"train": 0.05, "prefill": 0.05, "decode": 0.15}


@pytest.fixture(scope="module", autouse=True)
def reference():
    if jax is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


@pytest.fixture
def tiny(monkeypatch):
    for name, (s, b, kind) in TINY.items():
        monkeypatch.setitem(t_base.SHAPES, name,
                            t_base.ShapeCell(name, s, b, kind))
        monkeypatch.setitem(j_base.SHAPES, name,
                            j_base.ShapeCell(name, s, b, kind))


# --- analysis ------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_counts_equal_reference(name):
    cfg, ref = t_configs.get_arch(name), j_configs.get_arch(name)
    tp, jp = t_zoo.abstract_params(cfg), j_zoo.abstract_params(ref)
    assert t_ra.count_params(tp) == j_ra.count_params(jp)
    assert t_ra.count_active_params(cfg, tp) == \
        j_ra.count_active_params(ref, jp)
    for cell in t_configs.SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            tokens = cell.global_batch * (1 if kind == "decode"
                                          else cell.seq_len)
            assert t_ra.model_flops(cfg, tp, kind, tokens) == \
                j_ra.model_flops(ref, jp, kind, tokens)


def test_roofline_terms():
    """The reference's ``Roofline`` at H100 rates: one card's collective
    term is 0, and the terms are the counts over the data sheet's
    ceilings."""
    assert (t_ra.PEAK_FLOPS, t_ra.HBM_BW, t_ra.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    cost = {"flops_dev": 2e15, "bytes_dev": 1e12, "coll_bytes_dev": 0.0,
            "coll_count": 0}
    cfg = t_configs.get_arch("stablelm-3b")
    params = t_zoo.abstract_params(cfg)
    r = t_ra.analyze("stablelm-3b", "train_4k", "1xH100", 1, cost, cfg,
                     params, "train", 4096)
    d = r.to_dict()
    assert d["t_compute"] == 2e15 / 989e12
    assert d["t_memory"] == 1e12 / 3.35e12
    assert d["t_collective"] == 0.0 and d["bottleneck"] == "compute"
    assert d["model_flops"] == t_ra.model_flops(cfg, params, "train", 4096)
    assert d["roofline_fraction"] == pytest.approx(
        d["model_flops"] / 2e15)
    assert set(d) == set(j_ra.Roofline(
        "a", "s", "m", 1, 1.0, 1.0, 0.0, 0, 1.0).to_dict())


def test_counter_counts_bytes_flops_and_memory():
    """On real CPU tensors: a matmul's 2·M·N·K, an elementwise op's
    elements, a transcendental apart, unfused bytes (inputs read, output
    written; a view moves none), no collectives, and the live bytes of
    the storages made under the counter."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    c = t_ra.CostCounter()
    with c:
        y = a @ b                          # 2*8*16*4 flops
        z = torch.exp(y.T)                 # 32 transcendentals, a view
        del y
        w = z * z                          # 32 flops
    t = c.totals()
    assert t["mm_flops"] == 2 * 8 * 16 * 4
    assert t["flops"] == 2 * 8 * 16 * 4 + 32
    assert t["transcendentals"] == 32
    assert t["bytes"] == 4 * ((128 + 64 + 32) + (32 + 32) + (64 + 32))
    assert t["coll_bytes"] == 0 and t["coll_count"] == 0
    assert t["peak_bytes"] == 4 * 32 * 2    # y and z, then z and w
    del z, w
    assert c.live == 0


# --- piecewise -----------------------------------------------------------------

def test_layer_plan_and_analysis_cfg_equal_reference():
    for name in ARCHS:
        cfg, ref = t_configs.get_arch(name), j_configs.get_arch(name)
        for s in (64, 2048, 4096, 4224, 4352, 4353, 32768, 32896, 524288):
            assert t_pw.layer_plan_pieces(cfg, s) == \
                j_pw.layer_plan_pieces(ref, s)
        t_a, j_a = t_pw._analysis_cfg(cfg), j_pw._analysis_cfg(ref)
        assert (t_a.attn_q_block, t_a.attn_kv_block) == \
            (j_a.attn_q_block, j_a.attn_kv_block)
    assert t_pw.ANALYSIS_BLOCK == j_pw.ANALYSIS_BLOCK


def _mm(run):
    return t_pw.measure_run(run)["mm_flops"]


def _layer_matrices(lp, skip=()):
    """Sizes of a layer's 2-D weight matrices (leaves of two dims)."""
    out = []
    for path, leaf in flatten_with_path(lp):
        if leaf.dim() == 2 and not any(k in path for k in skip):
            out.append(leaf.numel())
    return out


@pytest.mark.parametrize("remat,passes", [("full", 4), ("dots", 3),
                                          ("nothing", 3)])
def test_dense_piece_matmul_flops_closed_form(remat, passes):
    """A dense GQA layer: 2·T·|W| for each weight matrix and 2·2·B·H·S²·hd
    for the attention's two products (one tile: the whole causal square),
    forward; a train step adds the backward's two products of each and,
    under remat "full", the forward's recompute, which stops early
    (torch.utils.checkpoint) before the layer's last product, the MLP's
    down projection: nothing of the backward needs its output."""
    import dataclasses
    cfg = dataclasses.replace(t_configs.get_arch("stablelm-3b").smoke(),
                              remat=remat)
    b, s = 2, 64
    lp = t_pw.train_layer_run(cfg, "dense", 0, b, s, True)
    from repro_torch.models.transformer import _init_layer
    layer = _init_layer(cfg, None, "dense", (), "meta")
    fwd = sum(2 * b * s * n for n in _layer_matrices(layer)) + \
        4 * b * cfg.n_heads * s * s * cfg.resolved_head_dim
    assert _mm(lp) == fwd
    last = 2 * b * s * layer["mlp"]["w_out"].numel() if remat == "full" \
        else 0
    assert _mm(t_pw.train_layer_run(cfg, "dense", 0, b, s, False)) == \
        passes * fwd - last


def test_moe_piece_matmul_flops_closed_form():
    """An MoE layer forward: the router 2·T·d·E, each expert matrix
    2·G·C·|W| over its capacity C, attention as a dense layer's."""
    cfg = t_configs.get_arch("phi3.5-moe-42b-a6.6b").smoke()
    from repro_torch.models import moe
    from repro_torch.models.transformer import _init_layer
    b, s = 2, 64
    lp = _init_layer(cfg, None, "moe", (), "meta")
    t = b * s
    g_tok = min(cfg.moe_group_tokens, t)
    cap = moe._capacity(g_tok, cfg.n_experts, cfg.top_k,
                        cfg.capacity_factor)
    want = sum(2 * t * n for n in _layer_matrices(lp, skip=("moe",)))
    want += 2 * t * lp["moe"]["router"].numel()
    want += sum(2 * (t // g_tok) * cap * lp["moe"][w].numel()
                for w in ("w_in", "w_gate", "w_out") if w in lp["moe"])
    want += 4 * b * cfg.n_heads * s * s * cfg.resolved_head_dim
    assert _mm(t_pw.train_layer_run(cfg, "moe", 0, b, s, True)) == want


@pytest.mark.parametrize("name,shape", [
    ("stablelm-3b", "tiny_train"), ("stablelm-3b", "tiny_prefill"),
    ("stablelm-3b", "tiny_decode"), ("phi3.5-moe-42b-a6.6b", "tiny_train"),
    ("hymba-1.5b", "tiny_train")])
def test_piece_flops_against_xla(tiny, name, shape):
    """Total and per-piece flops against the reference's XLA:CPU count on
    a (1, 1) mesh (module docstring's band); bytes reported."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = j_pw.analyze_cell_piecewise(j_configs.get_arch(name).smoke(),
                                       shape, mesh)
    got = t_pw.analyze_cell_piecewise(t_configs.get_arch(name).smoke(),
                                      shape)
    assert list(got["pieces"]) == list(want["pieces"])
    for piece, w in want["pieces"].items():
        assert got["pieces"][piece]["trips"] == w["trips"]
    ratio = got["flops_dev"] / want["flops_dev"]
    band = XLA_FLOPS_BAND[t_configs.SHAPES[shape].kind]
    assert abs(ratio - 1) <= band, ratio
    assert got["coll_bytes_dev"] == 0 == want["coll_bytes_dev"]
    print(f"{name} {shape}: flops {ratio:.4f} of XLA's, bytes "
          f"{got['bytes_dev'] / want['bytes_dev']:.3f} of XLA's; by piece "
          + ", ".join(f"{k} {got['pieces'][k]['flops'] / v['flops']:.4f}"
                      for k, v in want["pieces"].items()))


@pytest.mark.parametrize("shape", ["unit_train", "unit_prefill",
                                   "unit_decode"])
@pytest.mark.parametrize("name", ["stablelm-3b", "hymba-1.5b", "xlstm-350m",
                                  "whisper-small", "phi3.5-moe-42b-a6.6b"])
def test_pieces_sum_to_whole_step(tiny, name, shape):
    """Σ trips × piece against the whole step traced on the meta device
    through ``launch.steps`` (at ``_analysis_cfg``'s tiles), where every
    scale is 1 (module docstring's bands)."""
    cfg = t_configs.get_arch(name).smoke()
    got = t_pw.analyze_cell_piecewise(cfg, shape)
    assert all(v["trips"] >= 1 for v in got["pieces"].values())
    whole = t_pw.analyze_cell_whole(t_pw._analysis_cfg(cfg), shape)
    mm = sum(v["mm_flops"] * v["trips"] for v in got["pieces"].values())
    assert mm == whole["mm_flops"]
    assert got["flops_dev"] == pytest.approx(whole["flops"], rel=0.01)
    assert got["bytes_dev"] == pytest.approx(whole["bytes"], rel=0.2)
    mem = got["mem_temp_dev"] / whole["peak_bytes"]
    assert 0.75 <= mem <= 1.5, mem
    print(f"{name} {shape}: flops {got['flops_dev'] / whole['flops']:.4f}, "
          f"bytes {got['bytes_dev'] / whole['bytes']:.3f}, memory "
          f"{mem:.3f} of the whole step's")


# --- report ------------------------------------------------------------------

FIXED = {
    "a|train_4k|1xH100": {
        "status": "ok", "chips": 1, "flops_total": 2.5e15,
        "bytes_total": 1e13, "coll_bytes_per_chip": 0.0,
        "mem_argument_gb": 10.0, "mem_temp_gb": 2.5, "fits": True,
        "t_trace_s": 1.25, "t_compute": 2.5, "t_memory": 0.004,
        "t_collective": 0.0, "bottleneck": "compute", "model_flops": 1e15,
        "useful_ratio": 0.4, "roofline_fraction": 0.4, "pieces": {}},
    "a|long_500k|1xH100": {"status": "skip"},
    "b|decode_32k|1xH100": {"status": "fail"},
    "pso-cubic-1d|n1048576|1xH100": {
        "status": "ok", "chips": 1, "flops_total": 3e9, "bytes_total": 5e9,
        "coll_bytes_per_chip": 0.0, "mem_argument_gb": 0.04,
        "mem_temp_gb": 0.0, "fits": True},
}


def test_report_text():
    assert t_report.summary(FIXED) == "2 traced ok, 1 defined-skips, " \
        "1 failures"
    assert t_report.dryrun_table(FIXED).splitlines() == [
        "| cell | mesh | status | flops/dev | bytes/dev | coll GB/chip | "
        "mem/dev (arg+tmp) GB | fits | trace s |",
        "|---|---|---|---|---|---|---|---|---|",
        "| a|long_500k | 1xH100 | skip | | | | | | |",
        "| a|train_4k | 1xH100 | ok | 2.50e+15 | 1.00e+13 | 0.00 | 12.5 | "
        "yes | 1.2 |",
        "| b|decode_32k | 1xH100 | **FAIL** | | | | | | |",
        "| pso-cubic-1d|n1048576 | 1xH100 | ok | 3.00e+09 | 5.00e+09 | "
        "0.00 | 0.0 | yes | 0.0 |"]
    assert t_report.roofline_table(FIXED).splitlines()[2:] == [
        "| a | train_4k | 2.50s | 4.0ms | 0µs | **compute** | 1.00e+15 | "
        "0.40 | 0.400 |"]
    assert [t_report.fmt_s(x) for x in (None, 2.0, 0.0125, 3e-6)] == \
        ["—", "2.00s", "12.5ms", "3µs"]
