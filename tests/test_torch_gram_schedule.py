"""The schedule of the Gram panel kernel (``csrc/stationary_gram.cu``,
``stationary_gram_panels_f32``; TPU kernel #7), stepped through in numpy on
the CPU.

One launch writes every lower column panel of an n-point Gram padded to
P = ⌈n/B⌉ blocks into one buffer: panel k, (P·B − k·B, B) row-major, at
float B²·(k·P − k(k−1)/2).  The grid is flat: block t walks the panels,
subtracting each one's tiles (⌈rows/TR⌉·⌈B/TC⌉) until t falls inside one,
and takes row tile t // ⌈B/TC⌉ and column tile t % ⌈B/TC⌉ of it.  Entries
outside the panel are masked.  Point p of the tile is x_p / ℓ for p < n and
the far pseudo-point 1e6·(1 + p − n) in every coordinate past it; noise is
added where the global row equals the global column.

The twin below repeats that index arithmetic: every entry of every panel is
written exactly once, noise lands on the diagonal blocks' diagonals only,
the padding points are the JAX package's, and the entries built tile by
tile from the twin's points equal the JAX package's panels.  Index
arithmetic only, apart from the last, so the large shapes are cheap."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu.ops import blocked_chol as jbc
from gaussian_process_transportation_tpu_torch.ops import blocked_chol as tbc
from gaussian_process_transportation_tpu_torch.ops import pallas_gram as tpg

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TR, TC = tpg.GRAM_TILE_ROWS, tpg.GRAM_TILE_COLS


def _cdiv(a, b):
    return -(-a // b)


def tile_count(n, B):
    """The entry's grid: the tiles of every panel."""
    P = _cdiv(n, B)
    return sum(_cdiv((P - k) * B, TR) * _cdiv(B, TC) for k in range(P))


def tile_map(n, B):
    """For every block index: (panel k, its rows, its float offset, first row,
    first column), found as the kernel finds them."""
    P, ct = _cdiv(n, B), _cdiv(B, TC)
    rest = np.arange(tile_count(n, B), dtype=np.int64)
    k = np.zeros_like(rest)
    for kk in range(P):  # the kernel's loop over the panels, for all blocks at once
        tiles = _cdiv((P - kk) * B, TR) * ct
        move = (k == kk) & (rest >= tiles)
        rest[move] -= tiles
        k[move] += 1
    return k, (P - k) * B, B * B * (k * P - k * (k - 1) // 2), rest // ct * TR, rest % ct * TC


def tile_points(Z, ls, p0, count):
    """The points a tile loads, from point p0: x / ℓ in float32 below n, the
    far pseudo-point 1e6·(1 + p − n) from n on."""
    n, D = Z.shape
    p = p0 + np.arange(count)
    far = np.float32(1e6) * (1 + p - n).astype(np.float32)
    inside = np.clip(p, 0, max(n - 1, 0))
    scaled = (Z[inside] / ls).astype(np.float32)
    return np.where((p < n)[:, None], scaled, far[:, None])


@pytest.mark.parametrize("B", [64, 128, 512])
@pytest.mark.parametrize("n", [1, 200, 511, 512, 513, 2500, 10240])
def test_every_entry_is_written_once_and_noise_lands_on_the_diagonal(n, B):
    P = _cdiv(n, B)
    offsets = tbc.panel_offsets(n, B)
    assert offsets == [B * B * (k * P - k * (k - 1) // 2) for k in range(P + 1)]
    assert [b - a for a, b in zip(offsets, offsets[1:])] == [(P - k) * B * B for k in range(P)]
    writes = np.zeros(offsets[-1], np.int8)
    noise = np.zeros(offsets[-1], np.int8)
    k, rows, off, r0, c0 = tile_map(n, B)
    assert (k < P).all() and (r0 < rows).all() and (c0 < B).all()
    for kk, rr, oo, a, c in zip(k, rows, off, r0, c0):
        # the kernel's addresses off + r·B + c for r < rows, c < B, as a slice
        writes[oo:oo + rr * B].reshape(rr, B)[a:a + TR, c:c + TC] += 1
        diag = np.arange(max(a, c), min(a + TR, c + TC, rr, B))  # global row == column
        noise[oo + diag * B + diag] += 1
    assert (writes == 1).all()
    want = np.zeros_like(noise)
    for oo in offsets[:-1]:
        want[oo + np.arange(B) * (B + 1)] = 1
    assert np.array_equal(noise, want)


def test_the_grid_stays_inside_one_launch_at_the_largest_gram():
    """N = 65536, B = 512: 2.2·10⁹ entries (64-bit offsets), 264,192 tiles of
    a flat grid (a y dimension would stop at 65,535)."""
    assert tbc.panel_offsets(65536, 512)[-1] == 2_164_260_864 > 2**31
    assert tile_count(65536, 512) == 264_192 < 2**31


@pytest.mark.parametrize("n,B", [(200, 64), (513, 128)])
def test_padding_points_are_the_jax_packages(n, B):
    """Past n the tile's points are JAX's far pseudo-points, bit for bit
    (``stationary_gram_panels``: 1e6·(1 + arange) in float32)."""
    Np = _cdiv(n, B) * B
    Z = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    pts = tile_points(Z, np.float32(1.3), 0, Np)
    far = np.asarray(1e6 * (1.0 + jnp.arange(Np - n, dtype=jnp.float32)))
    assert np.array_equal(pts[n:], np.broadcast_to(far[:, None], (Np - n, 3)))
    assert np.array_equal(pts[:n], Z / np.float32(1.3))


@pytest.mark.parametrize("family", tpg.STATIONARY_FAMILIES)
def test_panels_built_tile_by_tile_are_the_jax_packages(family):
    """Each block's tile from the points it loads and the noise where the
    global row equals the column, into the one buffer, against JAX's
    ``stationary_gram_panels`` (f32 sums in another order: 2e-6)."""
    n, B, D, amp, noise = 300, 128, 2, 2.0, 0.1
    rng = np.random.default_rng(3)
    Z = rng.standard_normal((n, D)).astype(np.float32)
    ls = np.array([1.2, 0.7], np.float32)
    buf = np.full(tbc.panel_offsets(n, B)[-1], np.nan, np.float32)
    for kk, rr, oo, a, c in zip(*tile_map(n, B)):
        xs = tile_points(Z, ls, kk * B + a, min(TR, rr - a))
        zs = tile_points(Z, ls, kk * B + c, min(TC, B - c))
        d2 = ((xs[:, None, :] - zs[None, :, :]) ** 2).sum(-1)
        tile = amp * tbc.stationary_from_sqdist(torch.as_tensor(d2), family).numpy()
        r, cc = np.meshgrid(a + np.arange(len(xs)), c + np.arange(len(zs)), indexing="ij")
        tile = np.where(r == cc, tile + noise, tile)
        buf[oo:oo + rr * B].reshape(rr, B)[a:a + TR, c:c + TC] = tile
    want, _ = jbc.stationary_gram_panels(jnp.asarray(Z), jnp.asarray(ls), amp, noise, B,
                                         family=family)
    np.testing.assert_allclose(buf, np.concatenate([np.asarray(p).ravel() for p in want]),
                               atol=2e-6)
