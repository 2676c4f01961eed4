"""Sparse variational Gaussian processes (SVGP).

Port of ``gaussian_process_transportation_tpu/models/svgp.py``:

* the whitened parameterisation q(w) = N(m_w, S_w), u = L_K w, with
  S_w = L_w L_wᵀ and L_w's diagonal a softplus of the raw one;
* independent tasks (output columns) batched on a leading axis T: the
  kernel takes per-task hyperparameters (``Kernel.with_theta`` of a (T, n)
  theta), so the M×M Cholesky factors are one (T, M, M) batch;
* minibatch training with Adam over a precomputed index schedule
  (:func:`train`), or natural-gradient steps on q(w) with Adam on the
  hyperparameters (:func:`train_natgrad`);
* :func:`collapse` to the exact-GP form on the inducing set, then the
  mean and std of f (:func:`posterior_f`) and of ∂f/∂x
  (:func:`posterior_f_prime`, from the kernel's closed-form ``dx`` and
  ``dxdz_diag``), and posterior draws (:func:`sample_f`).

A Cholesky factor that fails gives NaN (``cholesky_ex``), not an
exception, as in XLA: a training step whose loss is then not finite
zeroes its gradient, and a non-finite gradient entry is zeroed, while
the Adam step still runs, as the JAX package does.  No step reads a
value back to the host.

Random draws (the inducing points, the minibatch permutations, the
sample ε) come from a ``torch.Generator`` on the CPU seeded from ``seed``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import Tensor

from .. import kernels as K
from ..ops.linalg import cholesky_with_jitter
from ._training import DeviceInputs, adam, as_2d, cpu_generator, schedule

_LOG_2PI = math.log(2.0 * math.pi)


def _eff_jitter(dtype: torch.dtype, jitter: float) -> float:
    """float32 Cholesky needs ~1e-4 diagonal jitter when inducing points are
    near-duplicates (dense curve samples); float64 keeps the request."""
    if dtype == torch.float32:
        return max(jitter, 1e-4)
    return jitter


def softplus(x: Tensor) -> Tensor:
    """log(1 + eˣ) as ``jax.nn.softplus`` computes it, exact for large x
    (``torch.nn.functional.softplus`` returns x above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@dataclass(frozen=True)
class SVGPParams:
    """Trainable parameters, batched over the task axis T."""

    theta: Tensor  # (T, n_theta) log-hyperparameters per task
    Z: Tensor  # (T, M, D) inducing locations
    m_w: Tensor  # (T, M) whitened variational mean
    L_w_raw: Tensor  # (T, M, M) raw lower factor (its diagonal softplus-ed)
    raw_noise: Tensor  # () the likelihood noise's softplus preimage


@dataclass(frozen=True)
class SVGPState:
    """A trained model: the parameters, the kernel's structure (its own
    values unused) and the jitter."""

    params: SVGPParams
    kernel: K.Kernel
    jitter: float = 1e-6

    @property
    def noise(self) -> Tensor:
        return softplus(self.params.raw_noise)


@dataclass(frozen=True)
class CollapsedSVGP:
    """The exact-GP form of the variational posterior on the inducing set.

    The predictive variance uses k* K⁻¹(K−S)K⁻¹ k*ᵀ = ‖a‖² − ‖L_wᵀ a‖²,
    a = L_K⁻¹ k*ᵀ, which stays exact and NaN-free where the optimised S_w
    is not ⪯ I."""

    theta: Tensor  # (T, n_theta)
    Z: Tensor  # (T, M, D)
    alpha: Tensor  # (T, M) = K⁻¹ m_u
    Lk: Tensor  # (T, M, M) Cholesky factor of K_uu + jitter
    Lw: Tensor  # (T, M, M) whitened variational factor
    kernel: K.Kernel


def _tril_with_softplus_diag(L_raw: Tensor) -> Tensor:
    return torch.tril(L_raw, -1) + torch.diag_embed(
        softplus(torch.diagonal(L_raw, dim1=-2, dim2=-1)))


def draw_inducing(generator: torch.Generator, N: int, T: int, num_inducing: int,
                  device="cuda") -> Tensor:
    """(T, M) indices of each task's inducing points among the N data
    points: without replacement unless M > N."""
    if num_inducing > N:
        idx = torch.randint(N, (T, num_inducing), generator=generator)
    else:
        idx = torch.stack([torch.randperm(N, generator=generator)[:num_inducing]
                           for _ in range(T)])
    return idx.to(device)


def init_params(kernel: K.Kernel, X: Tensor, Y: Tensor, idx: Tensor,
                noise_init: float = 0.1) -> SVGPParams:
    """Each task's inducing points X[idx[t]], its whitened mean warm-started
    from the targets there, S_w = I and the noise at ``noise_init``."""
    T, M = idx.shape
    Z = X[idx]  # (T, M, D)
    m_w = Y.T.gather(1, idx)  # (T, M)
    theta = kernel.theta.to(dtype=X.dtype, device=X.device)
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    # softplus⁻¹(1): S_w starts at I
    L_w_raw = (math.log(math.e - 1.0) * eye).expand(T, M, M).clone()
    return SVGPParams(
        theta=theta.expand(T, -1).clone(),
        Z=Z,
        m_w=m_w,
        L_w_raw=L_w_raw,
        raw_noise=torch.tensor(math.log(math.expm1(noise_init)), dtype=X.dtype,
                               device=X.device),
    )


def _task_elbo(kernel: K.Kernel, theta: Tensor, Z: Tensor, m_w: Tensor, L_w_raw: Tensor,
               noise: Tensor, x: Tensor, y_t: Tensor, n_total: int, jitter: float) -> Tensor:
    """Each task's minibatch ELBO (Hensman et al. 2013, whitened), (T,):
    theta (T, n), Z (T, M, D), m_w (T, M), L_w_raw (T, M, M), the batch
    x (B, D) and its targets y_t (T, B)."""
    k = kernel.with_theta(theta)
    M = Z.shape[-2]
    B = x.shape[0]
    Lk = cholesky_with_jitter(k(Z), _eff_jitter(Z.dtype, jitter))
    A = torch.linalg.solve_triangular(Lk, k(Z, x), upper=False)  # (T, M, B)
    mu = (A.transpose(-1, -2) @ m_w[..., None])[..., 0]  # (T, B)
    Lw = _tril_with_softplus_diag(L_w_raw)
    SA = Lw.transpose(-1, -2) @ A
    qvar = k.diag(x) - (A * A).sum(-2) + (SA * SA).sum(-2)
    qvar = torch.clamp(qvar, min=1e-12)
    expected_ll = -0.5 * (_LOG_2PI + torch.log(noise) + ((y_t - mu) ** 2 + qvar) / noise)
    kl = 0.5 * ((Lw * Lw).sum((-2, -1)) + (m_w * m_w).sum(-1) - M
                - 2.0 * torch.log(torch.diagonal(Lw, dim1=-2, dim2=-1)).sum(-1))
    return (n_total / B) * expected_ll.sum(-1) - kl


def elbo(kernel: K.Kernel, params: SVGPParams, x: Tensor, y: Tensor, n_total: int,
         jitter: float) -> Tensor:
    """The ELBO summed over the independent tasks, y (B, T)."""
    noise = softplus(params.raw_noise)
    return _task_elbo(kernel, params.theta, params.Z, params.m_w, params.L_w_raw, noise, x,
                      y.T, n_total, jitter).sum()


def train(kernel: K.Kernel, params: SVGPParams, X: Tensor, Y: Tensor, sched: Tensor,
          learning_rate: float = 0.01, jitter: float = 1e-6):
    """Adam on −ELBO over the schedule (steps, B), a step with a non-finite
    loss or gradient entry zeroing that gradient: the deterministic part of
    :func:`fit`.  Returns (the trained parameters, the losses)."""
    N = X.shape[0]

    def loss(p, idx):
        return -elbo(kernel, SVGPParams(*p), X[idx], Y[idx], N, jitter)

    fields = [params.theta, params.Z, params.m_w, params.L_w_raw, params.raw_noise]
    out, losses = adam(fields, loss, sched, learning_rate, skip_nonfinite=True)
    return SVGPParams(*out), losses


def _draws(generator, X, Y, num_inducing, num_epochs, batch_size):
    generator = cpu_generator(0) if generator is None else generator
    idx = draw_inducing(generator, X.shape[0], Y.shape[1], num_inducing, X.device)
    sched = schedule(generator, X.shape[0], num_epochs, batch_size, device=X.device)
    return idx, sched


def fit(kernel: K.Kernel, X: Tensor, Y: Tensor, num_inducing: int = 100,
        num_epochs: int = 100, batch_size: int = 128, learning_rate: float = 0.01,
        generator: Optional[torch.Generator] = None, jitter: float = 1e-6,
        noise_init: float = 0.1) -> SVGPState:
    """An independent-multitask SVGP trained by minibatch Adam: the
    inducing points and the schedule drawn from ``generator`` (seed 0 by
    default), then :func:`train`."""
    Y = as_2d(Y)
    idx, sched = _draws(generator, X, Y, num_inducing, num_epochs, batch_size)
    params, _ = train(kernel, init_params(kernel, X, Y, idx, noise_init), X, Y, sched,
                      learning_rate, jitter)
    return SVGPState(params=params, kernel=kernel, jitter=jitter)


def _nat_to_moment(Lam: Tensor, h: Tensor):
    """(m_w, L_w_raw) of the natural parameters (Λ, h) of q(w)."""
    S = torch.linalg.inv_ex(Lam).inverse
    m = (S @ h[..., None])[..., 0]
    L = cholesky_with_jitter(S, 1e-10)
    raw_diag = torch.log(torch.expm1(torch.clamp(torch.diagonal(L, dim1=-2, dim2=-1),
                                                 min=1e-10)))
    return m, torch.tril(L, -1) + torch.diag_embed(raw_diag)


def train_natgrad(kernel: K.Kernel, params: SVGPParams, X: Tensor, Y: Tensor, sched: Tensor,
                  learning_rate: float = 0.01, nat_step: float = 0.5, jitter: float = 1e-6):
    """Natural-gradient steps on q(w) and Adam on (θ, Z, noise) over the
    schedule: the deterministic part of :func:`fit_natgrad`.

    With a Gaussian likelihood the minibatch's optimal natural parameters
    of q(w) are Λ* = I + (N/B)/σ² · A Aᵀ and h* = (N/B)/σ² · A y_b, with
    A = L_K⁻¹ K_zx; a step moves λ ← (1−ρ)λ + ρλ*, at the hyperparameters
    before that step's Adam update, and Adam then descends −ELBO at the
    new q(w), which it treats as a constant."""
    N = X.shape[0]
    T, M = params.m_w.shape
    eye = torch.eye(M, dtype=X.dtype, device=X.device)
    Lam, h = eye.expand(T, M, M).clone(), torch.zeros_like(params.m_w)

    def loss(hyper, idx):
        theta, Z, raw_noise = hyper
        xb, yb = X[idx], Y[idx]
        with torch.no_grad():
            k = kernel.with_theta(theta)
            Lk = cholesky_with_jitter(k(Z), _eff_jitter(Z.dtype, jitter))
            A = torch.linalg.solve_triangular(Lk, k(Z, xb), upper=False)  # (T, M, B)
            scale = (N / xb.shape[0]) / softplus(raw_noise)
            Lam_star = eye + scale * (A @ A.transpose(-1, -2))
            h_star = scale * (A @ yb.T[..., None])[..., 0]
            Lam.copy_((1 - nat_step) * Lam + nat_step * Lam_star)
            h.copy_((1 - nat_step) * h + nat_step * h_star)
            m_w, L_raw = _nat_to_moment(Lam, h)
        p = SVGPParams(theta=theta, Z=Z, m_w=m_w, L_w_raw=L_raw, raw_noise=raw_noise)
        return -elbo(kernel, p, xb, yb, N, jitter)

    (theta, Z, raw_noise), losses = adam([params.theta, params.Z, params.raw_noise], loss,
                                         sched, learning_rate, loss_state=(Lam, h))
    m_w, L_raw = _nat_to_moment(Lam, h)
    return SVGPParams(theta=theta, Z=Z, m_w=m_w, L_w_raw=L_raw, raw_noise=raw_noise), losses


def fit_natgrad(kernel: K.Kernel, X: Tensor, Y: Tensor, num_inducing: int = 100,
                num_epochs: int = 100, batch_size: int = 128, learning_rate: float = 0.01,
                nat_step: float = 0.5, generator: Optional[torch.Generator] = None,
                jitter: float = 1e-6, noise_init: float = 0.1) -> SVGPState:
    """SVGP training with natural-gradient variational updates (Hensman
    2013 §3): the draws as :func:`fit`'s, then :func:`train_natgrad`."""
    Y = as_2d(Y)
    idx, sched = _draws(generator, X, Y, num_inducing, num_epochs, batch_size)
    params, _ = train_natgrad(kernel, init_params(kernel, X, Y, idx, noise_init), X, Y, sched,
                              learning_rate, nat_step, jitter)
    return SVGPState(params=params, kernel=kernel, jitter=jitter)


# ---- the collapsed exact-GP form and its posteriors -------------------------

def collapse(state: SVGPState) -> CollapsedSVGP:
    """The variational posterior in exact-GP form: m_u = L_K m_w, so
    α = K⁻¹ m_u = L_K⁻ᵀ m_w, by triangular solves."""
    p = state.params
    k = state.kernel.with_theta(p.theta)
    Lk = cholesky_with_jitter(k(p.Z), _eff_jitter(p.Z.dtype, state.jitter))
    alpha = torch.linalg.solve_triangular(Lk.transpose(-1, -2), p.m_w[..., None],
                                          upper=True)[..., 0]
    return CollapsedSVGP(theta=p.theta, Z=p.Z, alpha=alpha, Lk=Lk,
                         Lw=_tril_with_softplus_diag(p.L_w_raw), kernel=state.kernel)


def _predictive(c: CollapsedSVGP, x: Tensor):
    k = c.kernel.with_theta(c.theta)
    k_star = k(x, c.Z)  # (T, Nq, M)
    mean = (k_star @ c.alpha[..., None])[..., 0]  # (T, Nq)
    a = torch.linalg.solve_triangular(c.Lk, k_star.transpose(-1, -2), upper=False)  # (T, M, Nq)
    b = c.Lw.transpose(-1, -2) @ a
    return k, mean, a, b


def posterior_f(c: CollapsedSVGP, x: Tensor) -> Tuple[Tensor, Tensor]:
    """The mean and std of the latent f at x (Nq, D): (Nq, T) each, no
    likelihood noise added."""
    k, mean, a, b = _predictive(c, x)
    var = k.diag(x) - (a * a).sum(-2) + (b * b).sum(-2)
    return mean.T, torch.sqrt(torch.clamp(var, min=0.0)).T


def posterior_f_prime(c: CollapsedSVGP, x: Tensor) -> Tuple[Tensor, Tensor]:
    """The mean and std of ∂f/∂x at x: (Nq, T, D) each.  The mean is
    ∂k(x, Z)/∂x α; the variance of entry d is the derivative kernel's
    k''_dd(x, x) − dk_d K⁻¹(K−S)K⁻¹ dk_dᵀ, for a stationary kernel."""
    k = c.kernel.with_theta(c.theta)
    dk = k.dx(x, c.Z)  # (T, Nq, M, D)
    mean = torch.einsum("tqmd,tm->tqd", dk, c.alpha)
    dkT = dk.permute(0, 3, 2, 1)  # (T, D, M, Nq)
    a = torch.linalg.solve_triangular(c.Lk[:, None], dkT, upper=False)
    b = c.Lw.transpose(-1, -2)[:, None] @ a  # (T, D, M, Nq)
    quad = (a * a).sum(-2) - (b * b).sum(-2)  # (T, D, Nq)
    var = torch.clamp(k.dxdz_diag(x) - quad.transpose(-1, -2), min=0.0)  # (T, Nq, D)
    return mean.permute(1, 0, 2), torch.sqrt(var).permute(1, 0, 2)


def sample_f(c: CollapsedSVGP, x: Tensor, generator: torch.Generator,
             n_samples: int = 10) -> Tensor:
    """Posterior function draws (n_samples, Nq, T), ε from ``generator``."""
    k, mean, a, b = _predictive(c, x)
    cov = k(x) - a.transpose(-1, -2) @ a + b.transpose(-1, -2) @ b  # (T, Nq, Nq)
    L = cholesky_with_jitter(cov, 1e-8)
    T, Nq = mean.shape
    eps = torch.randn((T, n_samples, Nq), generator=generator, dtype=torch.float64)
    eps = eps.to(dtype=x.dtype, device=x.device)
    return (mean[:, None] + eps @ L.transpose(-1, -2)).permute(1, 2, 0)


class StochasticVariationalGaussianProcess(DeviceInputs):
    """The original project's interface: construct with (X, Y,
    num_inducing), ``fit(num_epochs)``, then ``predict``, ``derivative``
    and ``samples`` from the collapsed form."""

    def __init__(self, X, Y, num_inducing: int = 100, kernel: Optional[K.Kernel] = None,
                 seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.X = self._tensor(X)
        self.Y = as_2d(self._tensor(Y))
        self.num_inducing = min(num_inducing, self.X.shape[0])
        D = self.X.shape[1]
        self.kernel = kernel if kernel is not None else (
            K.Constant(1.0) * K.RBF(torch.ones(D, dtype=self.X.dtype, device=self.X.device)))
        self.seed = seed
        self.state: Optional[SVGPState] = None
        self.collapsed: Optional[CollapsedSVGP] = None

    def fit(self, num_epochs: int = 100, batch_size: int = 128, learning_rate: float = 0.01):
        self.state = fit(self.kernel, self.X, self.Y, num_inducing=self.num_inducing,
                         num_epochs=num_epochs, batch_size=batch_size,
                         learning_rate=learning_rate, generator=cpu_generator(self.seed))
        self.collapsed = collapse(self.state)
        return self

    def predict(self, x, return_std: bool = False):
        mean, std = posterior_f(self.collapsed, self._tensor(x))
        return (mean, std) if return_std else mean

    def derivative(self, x, return_var: bool = False):
        mean, std = posterior_f_prime(self.collapsed, self._tensor(x))
        return (mean, std**2) if return_var else mean

    def samples(self, x, n_samples: int = 10, generator: Optional[torch.Generator] = None):
        generator = cpu_generator(self.seed + 1) if generator is None else generator
        return sample_f(self.collapsed, self._tensor(x), generator, n_samples)
