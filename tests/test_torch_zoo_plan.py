"""chip_smoke.py phase 14's plan on the CPU, and the initializer's drawing
of a large leaf a run of rows at a time.

``chip_smoke.ZOO_PLAN`` gives each of phase 14's seven archs a depth for
each cell (prefill, decode, train). Every entry is recomputed here on the
meta device with the piecewise memory estimate (``chip_smoke.zoo_depth``):
the arch's own depth where the estimate fits ``ZOO_FIT_GIB`` of the cell's
mode, else the largest that does. A change to a config or to the port's
memory use that would make a planned cell overrun one card fails here,
not on the card. The module body of chip_smoke.py imports without a
card.

``models.layers.normal`` draws a leaf of more than ``DRAW_ELEMENTS`` in
runs of leading rows (a full-width stacked weight's float32 draw would not
fit one card beside the other parameters); every smaller leaf is one draw
as before, so every value the reference comparisons use is unchanged.
"""
import dataclasses
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import _nbytes
from repro_torch.models import layers, zoo
from repro_torch.optim.optimizers import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        yield importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))


def test_the_plan_names_the_seven_archs(smoke):
    assert smoke.ZOO_ARCHS == ("xlstm-350m", "stablelm-3b", "minicpm3-4b",
                               "qwen2-7b", "llava-next-34b", "qwen1.5-110b",
                               "arctic-480b")
    assert set(smoke.ZOO_PLAN) == set(smoke.ZOO_ARCHS)
    assert all(tuple(p) == tuple(smoke.ZOO_SHAPES)
               for p in smoke.ZOO_PLAN.values())
    assert tuple(smoke.ZOO_FIT_GIB) == tuple(smoke.ZOO_SHAPES)


@pytest.mark.parametrize("arch", ["xlstm-350m", "stablelm-3b", "minicpm3-4b",
                                  "qwen2-7b", "llava-next-34b",
                                  "qwen1.5-110b", "arctic-480b"])
def test_each_planned_depth_is_the_largest_that_fits(smoke, arch):
    """Every cell at the depth ``zoo_depth`` computes, or at a
    ``ZOO_TIME_CUT`` below it (a whole group of layers, cut for the run's
    time, not its memory); a planned cell's estimate within ``ZOO_FIT_GIB``
    of its mode; a cell cut for memory has its estimate one step deeper
    over it (the card forces the cut); arctic's train step the one defined
    skip, one layer's estimate over the budget."""
    full = get_arch(arch)
    unit = full.slstm_group or 1
    for mode, layers in smoke.ZOO_PLAN[arch].items():
        fits = smoke.zoo_depth(arch, mode)
        cut = smoke.ZOO_TIME_CUT.get((arch, mode))
        assert layers == (fits if cut is None else cut), (arch, mode)
        assert cut is None or 0 < cut < fits, (arch, mode)
        assert layers % unit == 0 and 0 <= layers <= full.n_layers
        if layers:
            assert smoke.zoo_gib(arch, mode, layers) <= \
                smoke.ZOO_FIT_GIB[mode]
        if fits < full.n_layers:
            assert smoke.zoo_gib(arch, mode, fits + unit) > \
                smoke.ZOO_FIT_GIB[mode], (arch, mode)
    skips = [m for m, n in smoke.ZOO_PLAN[arch].items() if not n]
    assert skips == (["train"] if arch == "arctic-480b" else [])


def test_the_estimate_counts_the_cells_arguments(smoke):
    """The arguments of each mode: the parameters, the batch, Adam's two
    float32 moments, the decode cache (qwen2-7b at two layers)."""
    cfg = smoke.zoo_cfg("qwen2-7b", 2)
    params = zoo.abstract_params(cfg)
    p = _nbytes(params)
    tokens = 2 * 4096 * 4
    arg, temp = smoke.zoo_estimate(cfg, "prefill")
    assert arg == p + tokens and temp > 0
    arg, _ = smoke.zoo_estimate(cfg, "train")
    n = sum(t.numel() for t in tree_leaves(params))
    assert arg == p + tokens + 2 * 4 * n
    arg, temp = smoke.zoo_estimate(cfg, "decode")
    cache = zoo.init_cache(cfg, 4, 4096, device="meta")
    assert arg == p + _nbytes(cache) and temp > 0


def test_vision_batch_is_laid_out_as_the_zoo_batch(smoke):
    """chip_smoke's train batch of a vision-prefix arch: the prefix rows
    first, then the text, S positions in all, as ``zoo.make_batch``."""
    cfg = get_arch("llava-next-34b").smoke()
    got = smoke.lm_batch(cfg, 2, 64, "cpu")
    want = zoo.make_batch(cfg, "prefill_32k", 2, 64,
                          torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["vision_embeds"].dtype == want["vision_embeds"].dtype


def test_normal_draws_a_large_leaf_a_run_of_rows_at_a_time(monkeypatch):
    """Above ``DRAW_ELEMENTS`` a leaf is the runs of its leading rows, each
    drawn in float32 in row order from the one generator and cast; at or
    below it the one draw of old. Rows larger than the limit split in
    turn."""
    shape, scale = (5, 6, 7), 0.5
    want_one = layers.normal(torch.Generator().manual_seed(3), shape, scale,
                             torch.bfloat16, "cpu")
    ref = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=ref, dtype=torch.float32)
    assert torch.equal(want_one, (x * scale).to(torch.bfloat16))
    monkeypatch.setattr(layers, "DRAW_ELEMENTS", 2 * 6 * 7)
    got = layers.normal(torch.Generator().manual_seed(3), shape, scale,
                        torch.bfloat16, "cpu")
    ref = torch.Generator().manual_seed(3)
    runs = [torch.randn((n, 6, 7), generator=ref, dtype=torch.float32)
            for n in (2, 2, 1)]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    assert torch.equal(got, (torch.cat(runs) * scale).to(torch.bfloat16))
    monkeypatch.setattr(layers, "DRAW_ELEMENTS", 20)   # a row is 42
    got = layers.normal(torch.Generator().manual_seed(3), shape, scale,
                        torch.float32, "cpu")
    ref = torch.Generator().manual_seed(3)
    rows = [torch.randn((2, 7), generator=ref) for _ in range(5 * 3)]
    assert torch.equal(got, (torch.cat(rows) * scale).reshape(shape))
    monkeypatch.setattr(layers, "DRAW_ELEMENTS", 1 << 12)
    big = layers.normal(torch.Generator().manual_seed(0), (64, 256, 8),
                        0.02, torch.float32, "cpu")
    assert abs(float(big.mean())) < 1e-3
    np.testing.assert_allclose(float(big.std()), 0.02, rtol=0.02)


def test_the_init_of_every_checked_model_is_one_draw_a_leaf():
    """Every leaf of the models the card ran before phase 14 (hymba-1.5B,
    whisper-small, phi-3.5-MoE at 2 layers) is at most ``DRAW_ELEMENTS``:
    their weights are drawn as before; llava-next-34b's largest is not."""
    limit = layers.DRAW_ELEMENTS
    for name in ("hymba-1.5b", "whisper-small"):
        for t in tree_leaves(zoo.abstract_params(get_arch(name))):
            assert t.numel() <= limit, name
    phi2 = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b"), n_layers=2)
    assert max(t.numel() for t in tree_leaves(zoo.abstract_params(phi2))) \
        <= limit
    big = max(t.numel() for t in tree_leaves(
        zoo.abstract_params(get_arch("llava-next-34b"))))
    assert big > limit
