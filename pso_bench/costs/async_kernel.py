"""One launch of ``async_kernel`` (``csrc/pso_step.cu``, the asynchronous
queue-lock): as ``fused_kernel``'s cost, plus the ``nb`` block-local bests
(a position and a fitness each) read once and written once."""
from pso_bench.spec import load_cost


def launches(call: dict) -> list:
    """An async solve launches its whole chunks of ``sync_every``
    iterations at once and the remainder after them."""
    iters = call["iters"]
    every = max(1, min(call["sync_every"], iters))
    main = iters // every * every
    nb = call["n"] // call["block_n"]
    return [dict(call, iters=s, nb=nb) for s in (main, iters - main) if s]


def cost(launch: dict) -> dict:
    out = dict(load_cost("fused_kernel")(launch))
    nb, d = launch["nb"], launch["d"]
    out["bytes"] += launch.get("esize", 4) * 2 * nb * (d + 1)
    return out
