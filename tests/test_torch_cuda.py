"""On-card tests of the torch port's CUDA kernel, marked ``cuda``: the
kernel against its plain twin on the card (phase 3 of ``chip_smoke.py`` at
a smaller E) and the batched transport's one launch.  They skip where no
CUDA card is present.  On a machine with a card and nvcc (and no JAX):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu_torch import kernels as K
from gaussian_process_transportation_tpu_torch.ops import batched_linalg as tbl
from gaussian_process_transportation_tpu_torch.transport import gpt

pytestmark = pytest.mark.cuda

E_SMALL = 1024


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _spd_elast(n, E, seed=0):
    """(E, n, n) float32 SPD matrices A Aᵀ + 3I and their (n, n, E) stack."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((E, n, n)).astype(np.float32)
    K_ = np.einsum("eij,ekj->eik", A, A) + 3 * np.eye(n, dtype=np.float32)
    return K_, np.ascontiguousarray(np.transpose(K_, (1, 2, 0)))


def _check(device, n, E, dtype, atol, inv_tol):
    K_, Ke = _spd_elast(n, E)
    Kd = torch.as_tensor(Ke, dtype=dtype, device=device)
    L1, Ki1 = tbl.spd_inverse_elast_fused(Kd)
    L0, Ki0 = tbl.spd_inverse_elast(Kd)
    torch.cuda.synchronize()
    assert (L1 - L0).abs().max().item() <= atol
    assert (Ki1 - Ki0).abs().max().item() <= atol
    Lb = L1.permute(2, 0, 1)
    assert torch.equal(Lb, torch.tril(Lb))
    got = Ki1.permute(2, 0, 1).double().cpu().numpy()
    assert np.abs(got - np.linalg.inv(K_.astype(np.float64))).max() < inv_tol


@pytest.mark.parametrize("E", [E_SMALL, E_SMALL + 37])
@pytest.mark.parametrize("n", [8, 20, 24, 32, 64])
def test_kernel_matches_twin_f32(device, n, E):
    _check(device, n, E, torch.float32, atol=2e-5, inv_tol=1e-4)


def test_kernel_matches_twin_f64(device):
    _check(device, 20, E_SMALL + 37, torch.float64, atol=1e-10, inv_tol=1e-10)


def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    good = torch.eye(4, device=device)[:, :, None].repeat(1, 1, 8)
    tbl.spd_inverse_elast_fused(good)
    with pytest.raises(TypeError):
        tbl.spd_inverse_elast_fused(good.half())
    with pytest.raises(ValueError, match="contiguous"):
        tbl.spd_inverse_elast_fused(good.transpose(0, 1))
    with pytest.raises(ValueError):
        tbl.spd_inverse_elast_fused(torch.eye(65, device=device)[:, :, None].contiguous())
    with pytest.raises(ValueError):
        tbl.spd_inverse_elast_fused(good[:3])


def test_batched_transport_launches_the_kernel_once(device, monkeypatch):
    monkeypatch.setattr(tbl.spd_inverse_elast_fused, "launches", 0)
    t = np.linspace(0, 1, 100)
    s = np.linspace(0, 1, 20)
    X = np.stack([10 * t, 5 * np.sin(3 * t)], 1)
    S = np.stack([10 * s, -2 + 0 * s], 1)
    targets = np.stack([10 * s, -2 + 3 * np.sin(2 * s)], 1)[None] + np.linspace(0, 1, 64)[:, None, None]
    dX = np.zeros_like(X)
    dX[:-1] = np.diff(X, axis=0)

    def run(dtype, dev):
        kern = K.Constant(10.0) * K.RBF(4.0 * torch.ones(2, dtype=dtype, device=dev)) + K.White(0.01)
        return gpt.fit_and_transport_batched(
            kern, *(torch.as_tensor(a, dtype=dtype, device=dev) for a in (S, targets, X, dX)))

    got = run(torch.float32, device)
    torch.cuda.synchronize()
    assert tbl.spd_inverse_elast_fused.launches == 1
    ref = run(torch.float64, "cpu")
    for name in ("traj", "delta"):
        err = (getattr(got, name).double().cpu() - getattr(ref, name)).abs().max().item()
        assert err / np.abs(X).max() < 1e-3, name
