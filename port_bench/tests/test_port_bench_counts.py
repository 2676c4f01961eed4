"""counts.py against counts made by hand at small shapes."""
import pytest

from port_bench import counts


def test_least_s_takes_the_largest_bound():
    assert counts.least_s(67e12, 0) == pytest.approx(1.0)
    assert counts.least_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_s(1, 1, counts.SFU_PER_S) == pytest.approx(1.0)


def test_chol_inverse_by_hand():
    # E = 2 matrices of n = 3: read K, write L and K^-1: 3 * 2 * 9 * 4 bytes;
    # 2 * 27 operations
    E, n = 2, 3
    assert counts.chol_inverse(E, n) == pytest.approx(max(54 / 67e12, 216 / 3.35e12))
    # at the floor's shape the bytes bound it: 78.6 MB at 3.35 TB/s
    assert counts.chol_inverse(16384, 20) == pytest.approx(3 * 16384 * 400 * 4 / 3.35e12)


def test_apply_by_hand():
    E, n, Q, D, P = 1, 2, 3, 2, 2
    per_member = (n * Q * (3 * D + 6) + 2 * P * n * Q + Q * n * n + 2 * D * n * Q
                  + 2 * P * D * n * Q + D * Q * n * n
                  + Q * (2 * P * D * D + 2 * D * D + 4 * P * D + 10 * D))
    read = 4 * (Q * 2 * D + E * (n * D + n * P + 3))
    write = 4 * E * Q * 4 * D + 4 * E
    assert counts.apply(E, n, Q, D, P) == pytest.approx(
        max(per_member / 67e12, (read + write) / 3.35e12, n * Q / counts.SFU_PER_S))


def test_floor_apply_is_about_twelve_gflop():
    # the floor's least apply work: ~12 GFLOP at 67 TFLOP/s, ~0.18 ms
    t = counts.apply(16384, 20, 400, 2, 2)
    assert 0.15e-3 < t < 0.2e-3
