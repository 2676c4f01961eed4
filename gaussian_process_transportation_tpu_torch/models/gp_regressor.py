"""Stateful GP regressor over the functional exact-GP core.

Port of ``gaussian_process_transportation_tpu/models/gp_regressor.py``:
the original project's duck-typed model interface — ``fit(X, Y)``,
``predict(x, return_std)``, ``samples(x)``, ``derivative(x, return_var)``,
``derivative_of_variance(x)`` — so the transport code can swap models.
Tensors stay on the device they are given.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

from ..kernels import Kernel
from . import exact_gp as core


class GaussianProcess:
    def __init__(
        self,
        kernel: Kernel,
        alpha: float = 1e-10,
        optimizer: Optional[str] = "lbfgs",
        n_restarts_optimizer: int = 5,
        seed: int = 0,
        jit_fit: bool = False,
    ):
        if optimizer not in (None, "lbfgs"):
            raise ValueError(f"optimizer must be None or 'lbfgs', got {optimizer!r}")
        self.kernel = kernel
        self.alpha = alpha
        self.optimizer = optimizer
        self.n_restarts_optimizer = n_restarts_optimizer
        self.seed = seed
        self.jit_fit = jit_fit
        self.state: Optional[core.ExactGP] = None

    def fit(self, X: Tensor, Y: Tensor):
        """Condition on (X, Y) with NaN-target rows dropped; with the
        ``"lbfgs"`` optimizer the hyperparameters are fitted first, by
        scipy's L-BFGS-B (``exact_gp.fit``), or with ``jit_fit`` by the
        restarts as lanes of one batched L-BFGS on X's device
        (``exact_gp.fit_jit``)."""
        if self.optimizer is None:
            Xn, Yn = core._filter_nan_rows(X, Y)
            self.state = core.condition(self.kernel, Xn, Yn, self.alpha)
        elif self.jit_fit:
            gen = torch.Generator().manual_seed(self.seed)
            self.state = core.fit_jit(self.kernel, X, Y, n_restarts=self.n_restarts_optimizer,
                                      generator=gen, jitter=self.alpha)
        else:
            gen = torch.Generator().manual_seed(self.seed)
            self.state = core.fit(self.kernel, X, Y, n_restarts=self.n_restarts_optimizer,
                                  generator=gen, jitter=self.alpha)
        self.kernel_ = self.state.kernel
        self.noise_var_ = self.alpha + float(core.white_noise_level(self.kernel_))
        return self

    @property
    def X(self):
        return self.state.X

    @property
    def Y(self):
        return self.state.Y

    def predict(self, x: Tensor, return_std: bool = False, return_cov: bool = False):
        if return_cov:
            return core.predict_cov(self.state, x)
        if return_std:
            # the original project's epistemic-only std
            return core.predict(self.state, x, return_std=True, epistemic_only=True)
        return core.predict(self.state, x)

    def samples(self, x: Tensor, n_samples: int = 10,
                generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(self.seed + 1)
        return core.sample_y(self.state, x, generator, n_samples)

    def derivative(self, x: Tensor, return_var: bool = False):
        return core.jacobian(self.state, x, return_var=return_var)

    def derivative_of_variance(self, x: Tensor):
        return core.variance_gradient(self.state, x)
