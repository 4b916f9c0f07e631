"""McMurchie-Davidson Hermite expansion coefficients (port of ``e_table_1d``
in ``nbed_tpu/integrals/md.py``).

The reference builds the table for one primitive pair under ``vmap``; here
the same recursion runs on tensors that broadcast over any leading axes
(pairs, primitives of A, primitives of B), so one call serves a whole
shell-pair class. Pure torch arithmetic: autograd passes through it.

Not ported yet: ``boys`` and ``hermite_r`` (the Coulomb-type integrals,
ROADMAP queue 1 item 12); V and the ERIs stay on the C++ engine.
"""

import torch

__all__ = ["e_table_1d"]


def e_table_1d(la: int, lb: int, a, b, ab_dist):
    """Hermite expansion coefficients E_t^{ij} for one cartesian direction.

    Args:
        la, lb: maximum powers for centres A and B.
        a, b: primitive exponents, tensors broadcasting against each other.
        ab_dist: A_x - B_x, broadcasting against ``a`` and ``b``.

    Returns:
        (..., la+1, lb+1, la+lb+1) tensor; E[..., i, j, t] = 0 for t > i+j.
    """
    a, b, ab_dist = torch.broadcast_tensors(a, b, ab_dist)
    p = a + b
    mu = a * b / p
    one_over_2p = 0.5 / p
    pa = -b / p * ab_dist  # P - A
    pb = a / p * ab_dist   # P - B
    zero = torch.zeros_like(p)

    e = {(0, 0, 0): torch.exp(-mu * ab_dist * ab_dist)}

    def get(i, j, t):
        if t < 0 or t > i + j or i < 0 or j < 0:
            return zero
        return e[(i, j, t)]

    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            for t in range(i + j + 1):
                if j == 0:
                    e[(i, j, t)] = (one_over_2p * get(i - 1, j, t - 1)
                                    + pa * get(i - 1, j, t)
                                    + (t + 1) * get(i - 1, j, t + 1))
                else:
                    e[(i, j, t)] = (one_over_2p * get(i, j - 1, t - 1)
                                    + pb * get(i, j - 1, t)
                                    + (t + 1) * get(i, j - 1, t + 1))

    return torch.stack([
        torch.stack([torch.stack([get(i, j, t) for t in range(la + lb + 1)], dim=-1)
                     for j in range(lb + 1)], dim=-2)
        for i in range(la + 1)
    ], dim=-3)
