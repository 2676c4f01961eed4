"""Port parity: ``avoidance/{geometry,directional,modulation}.py`` against
the JAX package's, float64 on the CPU: the closed forms (Γ, the bases, the
weights, the modulation matrices, the directional maps, ``avoid``) to
1e-12 relative, where JAX gives NaN the port too; the rollouts to 1e-10
of max|x|.  Scenes of at most 3 obstacles and 16 agents."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussian_process_transportation_tpu import avoidance as JA
from gaussian_process_transportation_tpu.avoidance import directional as JD
from gaussian_process_transportation_tpu.avoidance import geometry as JG
from gaussian_process_transportation_tpu_torch import avoidance as TA
from gaussian_process_transportation_tpu_torch import convert
from gaussian_process_transportation_tpu_torch.avoidance import directional as TD
from gaussian_process_transportation_tpu_torch.avoidance import geometry as TG
from gaussian_process_transportation_tpu_torch.avoidance import modulation as TM

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
CPU = dict(dtype=torch.float64, device="cpu")

# a moving ellipse, a cuboid that keeps raw inward motion, and a turned
# ellipse with an off-center reference point
SCENE = [
    dict(shape="ellipse", center=[4.0, 1.5], axis_length=[2.5, 1.5], orientation=30,
         margin=0.1, linear_velocity=[0.3, -0.2], angular_velocity=0.2),
    dict(shape="cuboid", center=[7.0, -1.5], axis_length=[2.0, 1.5], orientation=-15,
         margin=0.1, repulsion_coeff=1.5),
    dict(shape="ellipse", center=[2.0, -2.0], reference_point=[0.1, 0.2],
         axis_length=[1.0, 0.7], orientation=100, margin=0.05),
]


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def _scene(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 9, (n, 2))
    x[0] = SCENE[0]["center"]  # an agent at an obstacle's center
    v = rng.standard_normal((n, 2))
    return (JA.Obstacles.from_dicts(SCENE), TA.Obstacles.from_dicts(SCENE, device="cpu"), x, v)


def test_obstacles_from_dicts_and_convert_match_jax():
    jo, to, _, _ = _scene()
    carried = convert.obstacles_from_tree(jo, device="cpu")
    for name in ("center", "reference_point", "axis_length", "orientation", "margin",
                 "repulsion_coeff", "linear_velocity", "angular_velocity", "is_ellipse"):
        np.testing.assert_array_equal(getattr(to, name).numpy(), np.asarray(getattr(jo, name)))
        assert torch.equal(getattr(carried, name), getattr(to, name))
    moved = to.to(dtype=torch.float32)
    assert moved.center.dtype == torch.float32 and moved.center.device.type == "cpu"


def test_gamma_and_bases_match_jax():
    jo, to, x, _ = _scene()
    _close(TA.gamma(to, _t(x)), jax.jit(JA.gamma)(jo, jnp.asarray(x)))
    for got, want in zip(TA.modulation_bases(to, _t(x)),
                         jax.jit(JA.modulation_bases)(jo, jnp.asarray(x))):
        _close(got, want)


def test_gamma_blend_is_nan_where_jax_is():
    """A zero-size ellipse at an agent gives 0/0 in its Γ; the mask blend
    carries the NaN into a cuboid's Γ there (0·NaN), as in JAX."""
    scene = [dict(shape="cuboid", center=[1.0, 1.0], axis_length=[0.0, 0.0], margin=0.0),
             dict(shape="ellipse", center=[3.0, 0.0], axis_length=[1.0, 1.0], margin=0.1)]
    x = np.array([[1.0, 1.0], [0.0, 0.0], [3.0, 0.0]])
    want = np.asarray(jax.jit(JA.gamma)(JA.Obstacles.from_dicts(scene), jnp.asarray(x)))
    got = TA.gamma(TA.Obstacles.from_dicts(scene, device="cpu"), _t(x)).numpy()
    assert np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], **TOL)


def test_single_obstacle_gammas_match_jax():
    _, _, x, _ = _scene()
    c, ax, ori, m = np.array([3.0, 1.0]), np.array([2.0, 1.2]), 25.0, 0.2
    for jf, tf in ((JG.gamma_ellipse, TG.gamma_ellipse), (JG.gamma_cuboid, TG.gamma_cuboid)):
        _close(tf(_t(x), _t(c), _t(ax), _t(ori), _t(m)),
               jax.jit(jf)(jnp.asarray(x), jnp.asarray(c), jnp.asarray(ax), ori, m))


def test_obstacle_weights_match_jax():
    g = np.random.default_rng(2).uniform(1.0, 5.0, (3, 16))
    g[1, 3] = 1.0  # on a surface: every weight goes to that obstacle
    _close(TA.obstacle_weights(_t(g)), jax.jit(JA.obstacle_weights)(jnp.asarray(g)))


def test_modulation_matrices_match_jax():
    _, _, x, _ = _scene()
    x[1] = [3.0, 1.0]  # the elliptic basis is singular at its center: identity
    c = np.array([3.0, 1.0])
    _close(TM.modulation_matrix_spherical(_t(x), _t(c), 1.2),
           jax.jit(JA.modulation_matrix_spherical)(jnp.asarray(x), jnp.asarray(c), 1.2))
    got = TM.modulation_matrix_elliptic(_t(x), _t(c), 1.2, 0.7, 4)
    want = jax.jit(JA.modulation_matrix_elliptic, static_argnums=(2, 3, 4))(
        jnp.asarray(x), jnp.asarray(c), 1.2, 0.7, 4)
    _close(got, want)
    assert torch.equal(got[1], torch.eye(2, dtype=torch.float64))


def test_singular_basis_gives_non_finite_without_raising():
    E = torch.tensor([[[1.0, 2.0], [2.0, 4.0]]], dtype=torch.float64)
    assert not torch.isfinite(TM._inv2(E)).all()


def test_modulate_multiple_and_avoid_match_jax():
    jo, to, x, v = _scene()
    _close(TA.modulate_multiple(to, _t(x)), jax.jit(JA.modulate_multiple)(jo, jnp.asarray(x)))
    javoid = jax.jit(JA.avoid, static_argnames="cut_off_gamma")
    _close(TA.avoid(to, _t(x), _t(v)), javoid(jo, jnp.asarray(x), jnp.asarray(v)))
    # a zero velocity gives the obstacles' own velocity; a small cut-off drops them
    v0 = v.copy()
    v0[2] = 0.0
    _close(TA.avoid(to, _t(x), _t(v0), cut_off_gamma=3.0),
           javoid(jo, jnp.asarray(x), jnp.asarray(v0), cut_off_gamma=3.0))


def test_modulated_rollout_matches_jax():
    jo, to, x, _ = _scene()
    att = np.array([10.0, 0.0])
    x0 = x[1:]
    want = jax.jit(lambda x0_: JA.rollout(lambda y: 0.2 * (jnp.asarray(att)[None] - y),
                                          lambda y: JA.modulate_multiple(jo, y), x0_, 50,
                                          0.25))(jnp.asarray(x0))
    got = TA.rollout(lambda y: 0.2 * (_t(att)[None] - y), lambda y: TA.modulate_multiple(to, y),
                     _t(x0), 50, 0.25)
    assert got.shape == (50, 15, 2)
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10 * scale)


def test_avoid_rollout_of_the_wavy_ds_matches_jax():
    """The example's first scene: the wavy DS through ``avoid`` around its
    static ellipse and cuboid, 9 agents, 50 Euler steps of 0.03; no agent
    enters an obstacle (Γ ≥ 1)."""
    scene = [{k: v for k, v in o.items() if k in ("shape", "center", "axis_length",
                                                  "orientation", "margin")} for o in SCENE[:2]]
    jo, to = JA.Obstacles.from_dicts(scene), TA.Obstacles.from_dicts(scene, device="cpu")
    att = np.array([10.0, 0.0])

    def wavy(x, lib, att_):
        diff = att_[None, :] - x
        dist = (lib.linalg.norm(diff, axis=1) if lib is jnp
                else torch.linalg.vector_norm(diff, dim=1))
        c, s = lib.cos(lib.sin(dist)), lib.sin(lib.sin(dist))
        R = lib.stack([lib.stack([c, -s], -1), lib.stack([s, c], -1)], 1)
        return (R @ diff[:, :, None])[:, :, 0]

    x0 = np.stack([np.zeros(9), np.linspace(-3, 3, 9)], 1)

    def step(x, _):
        x = x + 0.03 * JA.avoid(jo, x, wavy(x, jnp, jnp.asarray(att)))
        return x, x

    _, want = jax.jit(lambda x0_: jax.lax.scan(step, x0_, None, length=50))(jnp.asarray(x0))
    x = _t(x0)
    got = []
    for _ in range(50):
        x = x + 0.03 * TA.avoid(to, x, wavy(x, torch, _t(att)))
        got.append(x)
    got = torch.stack(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(want)).max())
    assert TA.gamma(to, got.reshape(-1, 2)).min().item() >= 1.0


@pytest.mark.parametrize("D", [2, 3, 5])
def test_directional_maps_match_jax(D):
    rng = np.random.default_rng(D)
    vec = rng.standard_normal((4, D))
    vec[0] = 0.0  # a zero vector: the first axis
    other = rng.standard_normal((4, D))
    angle = rng.standard_normal((4, D - 1))
    angle[1] = 0.0  # the center of the inverted chart
    B1, B2 = (jax.jit(jax.vmap(JD.orthogonal_basis))(jnp.asarray(a)) for a in (vec, other))
    _close(TD.orthogonal_basis(_t(vec)), B1)
    _close(TD.angle_from_vector(_t(other), _t(B1)),
           jax.jit(jax.vmap(JD.angle_from_vector))(jnp.asarray(other), B1))
    _close(TD.vector_from_angle(_t(angle), _t(B1)),
           jax.jit(jax.vmap(JD.vector_from_angle))(jnp.asarray(angle), B1))
    _close(TD.invert_normal(_t(angle)), jax.jit(jax.vmap(JD.invert_normal))(jnp.asarray(angle)))
    for windup in (False, True):
        want = jax.jit(jax.vmap(lambda a, b, c: JD.transform_to_base(
            a, b, c, track_windup=windup)))(
            jnp.asarray(angle), B1, B2)
        _close(TD.transform_to_base(_t(angle), _t(B1), _t(B2), track_windup=windup), want)
    dirs = rng.standard_normal((4, D, 3))
    w = rng.uniform(0, 1, (4, 3))
    w[2, 1] = 0.0  # a zero weight is ignored
    _close(TD.directional_weighted_sum(_t(vec), _t(dirs), _t(w)),
           jax.jit(jax.vmap(JD.directional_weighted_sum))(jnp.asarray(vec), jnp.asarray(dirs),
                                                 jnp.asarray(w)))
    assert TA.directional_weighted_sum is TD.directional_weighted_sum
