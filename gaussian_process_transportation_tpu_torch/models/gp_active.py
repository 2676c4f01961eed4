"""Active-learning exact GP: an informative subset for large N.

Port of ``gaussian_process_transportation_tpu/models/gp_active.py``.  When
the training set exceeds ``n_samples_max`` (the original project caps its
exact GP at 20,000 points), a random 10% seed subset is grown greedily by
the point of largest posterior variance.  With fixed hyperparameters that
is partial pivoted Cholesky on the Gram: each step takes the largest
Schur-complement diagonal (the posterior variance given the points taken
so far) and updates every diagonal entry with one new factor row.  The
hyperparameters are then fitted once on the subset: the blocked large-N
fit for a float32 CUDA subset past ``BLOCKED_CHOL_MIN_N``, scipy's
L-BFGS-B otherwise.

The selection is a host loop of m steps, a few launches each, with no read
back to the host: the taken points are an (N,) mask, the argmax stays on
the device, and step j's projection reads only the j factor rows filled so
far (Σⱼ j·N elements in all).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from ..kernels import Kernel
from . import exact_gp as core


def _greedy_variance_select(kernel: Kernel, X: Tensor, m: int, seed_idx: Tensor,
                            noise: float = 0.0) -> Tuple[Tensor, Tensor]:
    """:func:`greedy_variance_select` and the conditional variances (N,)
    after its last step (0 at the taken points, up to rounding)."""
    N = X.shape[0]
    m0 = seed_idx.shape[0]
    device = X.device
    d = kernel.diag(X)  # the current conditional variances (White included)
    chosen = torch.empty(m, dtype=torch.long, device=device)
    chosen[:m0] = seed_idx.to(device=device, dtype=torch.long)
    taken = torch.zeros(N, dtype=torch.bool, device=device)
    rows = torch.empty((m, N), dtype=X.dtype, device=device)  # the factor's rows at all N
    arange = torch.arange(N, device=device)
    for j in range(m):
        # the pick as a (1,) device tensor: index_select and index_fill_
        # never read it back to the host
        if j < m0:
            pick = chosen[j:j + 1]
        else:
            pick = torch.where(taken, float("-inf"), d).argmax().reshape(1)
            chosen[j:j + 1] = pick
        taken.index_fill_(0, pick, True)
        k_col = kernel(X, X.index_select(0, pick))[:, 0]
        k_col = k_col + noise * (arange == pick).to(k_col.dtype)
        # Schur update: l_j = (k_col − Σ_{i<j} L_i[pick]·L_i) / sqrt(d[pick])
        proj = rows[:j].index_select(1, pick)[:, 0] @ rows[:j]
        pivot = torch.sqrt(torch.clamp(d.index_select(0, pick), min=1e-12))
        l_j = ((k_col - proj) / pivot).to(rows.dtype)
        rows[j] = l_j
        d = torch.clamp(d - l_j * l_j, min=0.0)
    return chosen, d


def greedy_variance_select(kernel: Kernel, X: Tensor, m: int, seed_idx: Tensor,
                           noise: float = 0.0) -> Tensor:
    """Indices (m,) of a subset of X (N, D): ``seed_idx`` (m0,) first (the
    original project's random 10% seed), then greedy max-posterior-variance
    additions by partial pivoted Cholesky.

    ``noise`` must equal the kernel's additive White level: ``kernel.diag``
    includes it, and a cross-covariance column drops it, so it is added back
    at the pick and the factorization sees one matrix.  The factor rows
    stay in X's dtype (an (m, N) buffer) whatever the kernel's parameters'
    dtype; ties in the argmax go to the lowest index, as in JAX."""
    return _greedy_variance_select(kernel, X, m, seed_idx, noise)[0]


class GaussianProcessActiveLearning:
    """The original project's active-learning GP interface: ``fit`` takes a
    subset when N exceeds ``n_samples_max``; ``predict`` returns (mean,
    epistemic std); ``derivative`` returns (dy/dx (Nq, D, P), dσ²/dx
    (Nq, D, 1)), the original layouts.

    Every input is moved to ``device`` (the card unless the caller asks for
    the CPU) in its own dtype.  The 10% seed subset is drawn without
    replacement from a CPU ``torch.Generator`` seeded with ``seed``, so
    every device takes the same one.  ``use_blocked`` None fits the subset
    through ``exact_gp.fit_blocked`` when the kernel is C·stationary
    (+White), the subset a float32 CUDA tensor and at least
    ``exact_gp.BLOCKED_CHOL_MIN_N`` points long (``blocked_kwargs`` go to
    it), and through ``exact_gp.fit`` otherwise: the route follows the
    tensors' device, not a process-wide default."""

    def __init__(
        self,
        kernel: Kernel,
        alpha: float = 1e-10,
        n_restarts_optimizer: int = 5,
        n_samples_max: int = 20000,
        seed: int = 0,
        use_blocked: Optional[bool] = None,
        blocked_kwargs: Optional[dict] = None,
        device="cuda",
    ):
        self.kernel = kernel
        self.alpha = alpha
        self.n_restarts_optimizer = n_restarts_optimizer
        self.n_samples_max = n_samples_max
        self.seed = seed
        self.use_blocked = use_blocked
        self.blocked_kwargs = dict(blocked_kwargs or {})
        self.device = torch.device(device)
        self.state: Optional[core.ExactGP] = None

    def _tensor(self, value) -> Tensor:
        return torch.as_tensor(value, device=self.device)

    def fit(self, X, Y):
        X = self._tensor(X)
        Y = self._tensor(Y)
        Y = Y if Y.dim() == 2 else Y[:, None]
        n = X.shape[0]
        if n > self.n_samples_max:
            gen = torch.Generator().manual_seed(self.seed)
            n_initial = int(0.1 * self.n_samples_max)
            seed_idx = torch.randperm(n, generator=gen)[:n_initial]
            idx = greedy_variance_select(self.kernel, X, self.n_samples_max, seed_idx,
                                         noise=float(core.white_noise_level(self.kernel)))
            X, Y = X[idx], Y[idx]
        use_blocked = self.use_blocked
        if use_blocked is None:
            use_blocked = (core.stationary_family_params(self.kernel) is not None
                           and X.device.type == "cuda" and X.dtype == torch.float32
                           and X.shape[0] >= core.BLOCKED_CHOL_MIN_N)
        if use_blocked:
            self.state = core.fit_blocked(self.kernel, X.to(torch.float32),
                                          Y.to(torch.float32), jitter=self.alpha,
                                          **self.blocked_kwargs)
        else:
            self.state = core.fit(self.kernel, X, Y, n_restarts=self.n_restarts_optimizer,
                                  generator=torch.Generator().manual_seed(self.seed + 1),
                                  jitter=self.alpha)
        self.kernel_ = self.state.kernel
        return self

    @property
    def X(self):
        return self.state.X

    def _query(self, x) -> Tensor:
        return self._tensor(x).to(self.state.X.dtype)

    def predict(self, x):
        return core.predict(self.state, self._query(x), return_std=True, epistemic_only=True)

    def derivative(self, x):
        x = self._query(x)
        dy_dx = core.jacobian(self.state, x).transpose(1, 2)  # (Nq, D, P)
        dsigma_dx = core.variance_gradient(self.state, x)[:, :, None]  # (Nq, D, 1)
        return dy_dx, dsigma_dx
