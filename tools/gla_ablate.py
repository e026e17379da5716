#!/usr/bin/env python3
"""Where the bfloat16 narrow GLA output kernel's time goes: copies of
``csrc/gla.cu`` with a part of ``gla_chunk_output_narrow_bf16`` taken out,
each built and timed alone on one card.

    python3 tools/gla_ablate.py

At hymba-1.5B's SSD width (B=4, S=4096, H=25, N=16, P=128, chunk 128, the
model's gates; chip_smoke's ``gla_inputs``) every variant runs on the same
folded operands and the same H_in (this tree's chunk-state and state-pass
kernels), the L2 flushed by reading before each launch: the median of 7
launches in CUDA events, beside each variant's ``-Xptxas -v`` line. The
full kernel is also held to its plain version (chip_smoke's bf16 bound).
The variants (``VARIANTS``) take out the weights (q k^T is packed
unweighted), q H_in, (q k^T o W) v, the store of y, and the arithmetic, or
the arithmetic and the stores, together: what is left then is the kernel's
memory traffic in its own order. A variant whose text is not found in the
source (the kernel changed) is reported and skipped. Builds go to
``build/gla_ablate/``. Needs one CUDA card, ``nvcc`` and ``nvidia-smi``.
"""
import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, gla  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "gla_ablate"
KERNEL = "gla_chunk_output_narrow_bf16"

#: Each cut: (text of the kernel, what takes its place).
CUTS = {
    "weights": ("""    weigh_pack(s2, a, 16 * st, ra, t, L, st < rb && r0 + 16 <= L, factored,
               cum, lis, er, ec);""",
                "a[0] = pack_bf16(s2[0][0], s2[0][1]); "
                "a[1] = pack_bf16(s2[0][2], s2[0][3]); "
                "a[2] = pack_bf16(s2[1][0], s2[1][1]); "
                "a[3] = pack_bf16(s2[1][2], s2[1][3]);"),
    "qH": ("      if (carry) {                     // q H_in, then times "
           "exp(clip(cum))", "      if (false) {"),
    "PV": ("      for (int st = 0; st < steps; ++st) {   // (q k^T o W) v",
           "      for (int st = 0; st < 0; ++st) {"),
    "stores": ("""    store_bf(y + row0 * P + p0, P, vt, VS, lp, kNarrowPT, L, P - p0, vec_y,
             tid, NT);""", ""),
}
#: The variants, by the cuts each makes.
VARIANTS = {"whole kernel": (), "no weights": ("weights",),
            "no q H_in": ("qH",), "no (q k^T o W) v": ("PV",),
            "no stores": ("stores",),
            "loads and stores only": ("weights", "qH", "PV"),
            "loads only": ("weights", "qH", "PV", "stores")}


def variant_source(src: str, cuts) -> str:
    """``src`` with ``cuts`` made inside the narrow bfloat16 kernel only;
    KeyError names a cut whose text is not there."""
    a = src.index(f"    {KERNEL}(\n")
    b = src.index("\n}\n", a)
    body = src[a:b]
    for cut in cuts:
        old, new = CUTS[cut]
        if old not in body:
            raise KeyError(cut)
        body = body.replace(old, new)
    return src[:a] + body + src[b:]


def build(name: str):
    """(name, library or None, the kernel's -Xptxas -v line or why not)."""
    try:
        text = variant_source((CSRC / "gla.cu").read_text(), VARIANTS[name])
    except KeyError as e:
        return name, None, f"cut {e} not found in the source: skipped"
    stem = name.replace(" ", "_").replace("(", "").replace(")", "")
    path = OUT / f"gla_{stem}.cu"
    path.write_text(text)
    lib = path.with_suffix(".so")
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", "-o",
                        str(lib), str(path)], capture_output=True, text=True)
    if r.returncode:
        return name, None, f"build failed: {r.stderr[-800:]}"
    line = [x for x in cs.ptxas_lines(r.stdout + r.stderr)
            if x.startswith(KERNEL)]
    return name, lib, line[0] if line else "?"


def main() -> int:
    if not torch.cuda.is_available():
        print("gla_ablate: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    OUT.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = list(pool.map(build, VARIANTS))
    x = cs.gla_inputs(4, 4096, **cs.HYMBA, model_gates=True)
    q, k, v, ld, li = cs.gla_folded([a.bfloat16() for a in x[:3]] + x[3:],
                                    128)
    h_in = gla.state_pass(*gla.chunk_states(k, v, ld, li, 128))
    want = gla.gla_chunk_output_plain(q, k, v, ld, li, h_in, 128)
    bh, s, n = q.shape
    p = v.shape[-1]
    ptr, i = ctypes.c_void_p, ctypes.c_int
    failed = False
    for name, lib, line in built:
        if lib is None:
            print(f"  {KERNEL} {name}: {line} [{card}]")
            failed |= "failed" in line
            continue
        fn = ctypes.CDLL(str(lib)).gla_chunk_output_bf16_launch
        fn.argtypes = [ptr] * 7 + [i] * 5 + [ptr]
        y = torch.empty_like(v)

        def run():
            status = fn(*(t.data_ptr() for t in (q, k, v, ld, li, h_in, y)),
                        bh, s, n, p, 128,
                        torch.cuda.current_stream().cuda_stream)
            if status:
                raise RuntimeError(f"{name}: CUDA error {status}")
        run()
        torch.cuda.synchronize()
        held = ""
        if not VARIANTS[name]:
            err, ok = cs.gla_bf16_err(y, want)
            held = f"; against plain max error {err:.3g}, in bound {ok}"
            failed |= not ok
        us = []
        for _ in range(7):
            cs.flush_l2()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            us.append(start.elapsed_time(end) * 1e3)
        us.sort()
        print(f"  {KERNEL} {name}: {us[3]:.1f} us (L2 flushed, median of 7:"
              f" {', '.join(f'{u:.1f}' for u in us)}); {line}{held} "
              f"[{card}]", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
