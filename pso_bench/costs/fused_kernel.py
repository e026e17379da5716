"""One launch of ``fused_kernel`` (``csrc/pso_step.cu``, the fused
queue-lock): ``iters`` iterations of one swarm of ``n`` particles in ``d``
dimensions. Bytes: pos, vel, pbest_pos, pbest_fit and gbest read once and
written once, ``esize`` bytes an element, and the float32 bounds rows
(lo, hi, max_v, span) and two words of seed and iteration read. Operations:
``opcounts``' per element and per particle and the objective's own
(``objectives/<name>.py``'s ``FP_OPS``), every iteration."""
from pso_bench import opcounts
from pso_bench.spec import load_module


def launches(call: dict) -> list:
    """A queue-lock solve is one launch of every iteration."""
    return [dict(call, nb=0)]


def state_elements(launch: dict) -> int:
    """Elements of one swarm's state: pos, vel, pbest_pos [n, d],
    pbest_fit [n], gbest_pos [d], gbest_fit."""
    n, d = launch["n"], launch["d"]
    return 3 * n * d + n + d + 1


def cost(launch: dict) -> dict:
    n, d, iters = launch["n"], launch["d"], launch["iters"]
    esize = launch.get("esize", 4)
    words = 2 + 4 * d
    fp_obj = load_module("objectives", launch["objective"]).FP_OPS
    fp_each = d * (opcounts.FP_DRAWS_RULE + fp_obj) + opcounts.FP_PER_PARTICLE
    return {"bytes": esize * 2 * state_elements(launch) + 4 * words,
            "int_ops": iters * n * d * opcounts.INT_PER_ELEMENT,
            "fp_ops": iters * n * fp_each}
