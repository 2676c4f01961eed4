"""Linear assignment: trajectory waypoints matched to distribution points.

Port of ``gaussian_process_transportation_tpu/ops/assignment.py``.  The
original project matches with scipy's Hungarian algorithm on a dense
distance matrix; two implementations:

* ``linear_sum_assignment``: scipy on the host, exact, used at fit time;
* ``auction_assignment``: the ε-scaling forward auction on the tensors'
  device, optimal to within n·ε of the last round, for matching that has to
  stay on the device.  Costs are minimized.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import Tensor


def distance_matrix(A: Tensor, B: Tensor) -> Tensor:
    """Pairwise Euclidean distances (N, M), the matching cost of the
    original project."""
    d2 = (A * A).sum(-1)[:, None] + (B * B).sum(-1)[None, :] - 2.0 * A @ B.T
    return torch.sqrt(torch.clamp(d2, min=0.0))


def linear_sum_assignment(cost) -> Tuple[np.ndarray, np.ndarray]:
    """The exact Hungarian assignment (scipy, on the host): (rows, cols)
    sorted by row."""
    from scipy.optimize import linear_sum_assignment as lsa

    return lsa(torch.as_tensor(cost).detach().cpu().numpy())


def auction_assignment(cost: Tensor, eps_start: float = 1.0, max_iter: int = 10000) -> Tensor:
    """ε-scaling auction minimizing ``cost`` (n_rows, n_cols), n_rows ≥
    n_cols: the columns are the persons (the smaller side, e.g. the
    distribution's points), the rows the objects.  Returns the row assigned
    to each column, (n_cols,).

    The problem is padded to a square one with zero-cost dummy persons,
    which take the rows left over; ten ε rounds from scale·eps_start down by
    0.2 each, every round restarting the assignment from the last round's
    prices; a round ends when every person holds an object or after
    ``max_iter`` bids.  Each bid is the first free person's: a few launches
    on the device with no host read.  The host reads whether a person is
    still free once for each n bids (a round takes at least n).  A round's
    bids are not known ahead, and an eager loop ends only on a host read:
    one read a round would run all ``max_iter`` bids of every round, most of
    them no-ops, where a read each n bids wastes fewer than n a round."""
    C = torch.as_tensor(cost)
    n_rows, n_real = C.shape
    if n_real > n_rows:
        raise ValueError("auction_assignment expects n_rows >= n_cols")
    n = n_rows
    device = C.device
    B = torch.cat([-C, C.new_zeros((n, n - n_real))], 1)
    scale = torch.clamp(B.abs().max(), min=1.0)
    persons = torch.arange(n, device=device)
    prices = B.new_zeros(n)
    neg_inf = torch.tensor(float("-inf"), dtype=B.dtype, device=device)
    zero = B.new_zeros(1)
    minus_one = torch.full((1,), -1, dtype=torch.long, device=device)
    for r in range(10):
        eps = scale * eps_start * 0.2**r
        owner = torch.full((n,), -1, dtype=torch.long, device=device)
        assigned = torch.full((n,), -1, dtype=torch.long, device=device)
        bids = 0
        while bids < max_iter and bool((assigned < 0).any()):
            for _ in range(min(n, max_iter - bids)):
                j = torch.where(assigned < 0, persons, n).min().reshape(1)
                active = j < n  # a no-op once every person holds an object
                j = torch.clamp(j, max=n - 1)
                values = B.index_select(1, j)[:, 0] - prices
                i_best = values.argmax().reshape(1)
                v_best = values.index_select(0, i_best)
                v_second = values.index_fill(0, i_best, neg_inf).max()
                prev = owner.index_select(0, i_best)
                evict = active & (prev >= 0)
                p_idx = torch.clamp(prev, min=0)
                # evict the object's previous owner, then give the object to j
                assigned.index_copy_(0, p_idx, torch.where(evict, minus_one,
                                                           assigned.index_select(0, p_idx)))
                assigned.index_copy_(0, j, torch.where(active, i_best, assigned.index_select(0, j)))
                owner.index_copy_(0, i_best, torch.where(active, j, owner.index_select(0, i_best)))
                prices.index_add_(0, i_best, torch.where(active, v_best - v_second + eps, zero))
            bids += min(n, max_iter - bids)
    return assigned[:n_real]


def match_waypoints(training_traj: Tensor, source_distribution: Tensor):
    """(mask_traj, mask_dist): which trajectory waypoint matches which
    distribution point, by scipy's exact assignment on the host."""
    return linear_sum_assignment(distance_matrix(torch.as_tensor(training_traj),
                                                 torch.as_tensor(source_distribution)))
