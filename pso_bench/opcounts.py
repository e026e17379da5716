"""Operations per element of the PSO kernels, counted from the algorithm
(paper Alg. 1 with the counter RNG), work shared by all elements of an
iteration left out. The cost files under ``costs/`` build on these.

Integer, per particle-dimension-iteration: the element index (1); the two
draws' first terms, index times a constant plus a per-stream constant (2);
their shared second term (1); two fmix32 rounds per draw, each three shifts,
three xors and two multiplies (2 * 2 * 8); the xor of the second term (2);
the shift and int-to-float conversion of each draw (4).
Float, per particle-dimension-iteration: the 2^-24 scale of each draw (2)
and the pso rule's velocity and position update with its clamps (14);
the objective's own operations are its file's (``objectives/*.py``'s
``FP_OPS``). Per particle-iteration: the pbest and gbest compares (2).
"""

INT_PER_ELEMENT = 1 + 2 + 1 + 32 + 2 + 4
FP_DRAWS_RULE = 2 + 14
FP_PER_PARTICLE = 2
