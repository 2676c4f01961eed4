"""The squared-exponential covariance amp·exp(−½‖(a − b)/ℓ‖²), per member:
its values, its derivative along the second point, and the prior
variances of a value and of a derivative."""
from torch import Tensor


def k(A: Tensor, B: Tensor, amp: Tensor, ls: Tensor) -> Tensor:
    """(batch, M, N) for A (batch, M, D), B (batch, N, D), amp (batch,),
    ℓ (batch, D)."""
    d = (A[:, :, None, :] - B[:, None, :, :]) / ls[:, None, None, :]
    return amp[:, None, None] * (-0.5 * (d * d).sum(-1)).exp()


def dk(A: Tensor, B: Tensor, amp: Tensor, ls: Tensor, K: Tensor) -> Tensor:
    """∂k(a, b)/∂b_d, laid out (batch, D, M, N); K is k(A, B)."""
    diff = A.transpose(-1, -2)[:, :, :, None] - B.transpose(-1, -2)[:, :, None, :]
    return diff / (ls * ls)[:, :, None, None] * K[:, None]


def prior_var(amp: Tensor, ls: Tensor) -> Tensor:
    """k(x, x): (batch,)."""
    return amp


def prior_grad_var(amp: Tensor, ls: Tensor) -> Tensor:
    """The prior variance of ∂f/∂x_d: (batch, D)."""
    return amp[:, None] / (ls * ls)
