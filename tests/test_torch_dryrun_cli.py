"""The LM tooling's CLIs on the CPU, each a process: the one-card dry run
(``python -m repro_torch.launch.dryrun``) on one full-size cell and a
defined skip, the report of its JSON (``python -m
repro_torch.roofline.report``), and the hillclimb against it (``python -m
repro_torch.launch.hillclimb --full``). The cell's record is held to the
port's own counts exactly (parameters, MODEL_FLOPS, argument bytes from
the meta trees)."""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch import configs as t_configs
from repro_torch.models import zoo as t_zoo
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.roofline import analysis as t_ra

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))


def _cli(module, *args, timeout=600):
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                       env=ENV, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    return r.stdout


def test_dryrun_report_and_hillclimb_cli(tmp_path):
    """The dry run on one full-size cell (and a defined skip), the report
    of its JSON, and the hillclimb against it, each a process."""
    out, hc = str(tmp_path / "dryrun.json"), str(tmp_path / "hc.json")
    text = _cli("repro_torch.launch.dryrun", "--arch", "hymba-1.5b",
                "--shape", "long_500k", "--out", out)
    assert "[dryrun] done: 1 ok, 0 skip, 0 fail" in text
    _cli("repro_torch.launch.dryrun", "--arch", "stablelm-3b", "--shape",
         "long_500k", "--out", out)
    with open(out) as f:
        res = json.load(f)
    assert res["stablelm-3b|long_500k|1xH100"]["status"] == "skip"
    cell = res["hymba-1.5b|long_500k|1xH100"]
    assert cell["status"] == "ok" and cell["chips"] == 1
    cfg = t_configs.get_arch("hymba-1.5b")
    params = t_zoo.abstract_params(cfg)
    assert cell["params_total"] == t_ra.count_params(params)
    assert cell["model_flops"] == t_ra.model_flops(cfg, params, "decode", 1)
    cache = t_zoo.abstract_cache(cfg, "long_500k")
    arg = sum(t.numel() * t.element_size()
              for t in tree_leaves((params, cache))) + 8
    assert cell["mem_argument_gb"] == arg / 1e9
    assert cell["fits"] is True and cell["t_collective"] == 0.0
    assert set(cell["pieces"]) == {"hybrid", "decode_top"}
    text = _cli("repro_torch.roofline.report", out)
    assert "1 traced ok, 1 defined-skips, 0 failures" in text
    assert "| hymba-1.5b | long_500k |" in text
    text = _cli("repro_torch.launch.hillclimb", "--arch", "hymba-1.5b",
                "--shape", "long_500k", "--set", "swa_window_decode=True",
                "--baseline", out, "--out", hc, "--tag", "win", "--full")
    assert "=== hymba-1.5b | long_500k | win ===" in text
    assert "mem_temp_gb:" in text
    with open(hc) as f:
        got = json.load(f)["hymba-1.5b|long_500k|win"]
    assert got["overrides"] == {"swa_window_decode": True}
    assert got["t_memory"] < cell["t_memory"]   # the window's rows only
    assert np.isfinite(got["mem_temp_gb"])
