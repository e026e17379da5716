"""The reference of ``variant="async"``, the asynchronous queue-lock: the
particles in blocks of ``block_n``; each block moves against its own local
best, which takes the block's best new fitness where greater; at every
iteration that is a multiple of ``sync_every`` the best local is published
into gbest and every local is set to gbest; after the last iteration the
best local is published. The program's blocks do not wait for each other
at a sync point, so its runs follow this lockstep order only in
distribution."""
import torch

from pso_bench.reference import best


def run(ref, s, iters: int, traffic: dict):
    """``iters`` iterations of the swarms ``s`` (``reference.Swarms``)."""
    bn, every = ref.block_n, int(traffic.get("sync_every", 8))
    nb = ref.n // bn
    if nb * bn != ref.n:
        raise ValueError(f"block_n={bn} does not divide {ref.n}")
    lf = s.gbest_fit[:, None].repeat(1, nb)
    lp = s.gbest_pos[:, None, :].repeat(1, nb, 1)
    for t in range(1, iters + 1):
        fit = ref.move(s, t, lp.repeat_interleave(bn, dim=1))
        bf, bp = best(fit.reshape(-1, nb, bn),
                      s.pos.reshape(-1, nb, bn, ref.d))
        take = bf > lf
        lf = torch.where(take, bf, lf)
        lp = torch.where(take[..., None], bp, lp)
        if t % every == 0 or t == iters:
            ref.take(s, lf, lp)
        if t % every == 0:
            lf = s.gbest_fit[:, None].repeat(1, nb)
            lp = s.gbest_pos[:, None, :].repeat(1, nb, 1)
    return s
