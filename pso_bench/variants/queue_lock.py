"""The reference of ``variant="queue_lock"``, synchronous PPSO (the paper's
queue-lock): every particle moves against the gbest of the iteration
before; pbest folds where the new fitness is greater; gbest takes the best
pbest (the first on ties) where it is greater."""


def run(ref, s, iters: int, traffic: dict):
    """``iters`` iterations of the swarms ``s`` (``reference.Swarms``)."""
    for t in range(1, iters + 1):
        ref.move(s, t, s.gbest_pos[:, None, :])
        ref.take(s, s.pbest_fit, s.pbest_pos)
    return s
