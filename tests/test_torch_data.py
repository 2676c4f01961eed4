"""Port parity: ``data/{datasets,tags,robot_analysis,drawing}.py`` against
the JAX package's on the CPU.  Every loader reads synthetic files that the
test writes under ``tmp_path`` in the original project's layouts (the
reach-target and LASA writers are ``chip_smoke.py``'s); both
packages read the same arrays exactly.  The frame helpers and the tag
adapters agree exactly or to 1e-12; the GP surfaces, sampled from JAX's
own normal draws, to 1e-12 of the surface's height; the robot-analysis
matrices to 1e-12."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import write_lasa_file, write_reach_file
from gaussian_process_transportation_tpu.data import datasets as jds
from gaussian_process_transportation_tpu.data import robot_analysis as jra
from gaussian_process_transportation_tpu.data import tags as jtags
from gaussian_process_transportation_tpu.data.drawing import DrawingRecorder as JRecorder
from gaussian_process_transportation_tpu_torch import data as tdata
from gaussian_process_transportation_tpu_torch.data import datasets as tds
from gaussian_process_transportation_tpu_torch.data import robot_analysis as tra
from gaussian_process_transportation_tpu_torch.data import tags as ttags
from gaussian_process_transportation_tpu_torch.data.drawing import DrawingRecorder

# One intra-op thread: the suite runs in several workers that share the
# cores, and on tensors this small torch's default pool (a thread a core)
# spins against them (a 7 s check read 175 s so on a loaded 8-core CPU).
torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)


def test_data_package_has_no_public_list_like_jax():
    import gaussian_process_transportation_tpu.data as jdata

    assert not hasattr(jdata, "__all__") and not hasattr(tdata, "__all__")


def test_loaders_read_the_same_files_as_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    arrays = {k: rng.standard_normal((20, 2)) for k in ("demo", "floor", "newfloor")}
    np.savez(tmp_path / "example.npz", **arrays)
    (tmp_path / "three").mkdir()
    np.savez(tmp_path / "three" / "example.npz", demo=rng.standard_normal((30, 3)))
    reach = write_reach_file(str(tmp_path / "reach_target.npy"), n_demos=5, T=40)
    write_lasa_file(str(tmp_path), "Synth", n_demos=3, T=60)

    for a, b in ((tds.load_2d_drawing(root=str(tmp_path)), jds.load_2d_drawing(root=str(tmp_path))),
                 (tds.load_3d_example(root=str(tmp_path / "three")),
                  jds.load_3d_example(root=str(tmp_path / "three")))):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    a, b = tds.load_reach_target(reach), jds.load_reach_target(reach)
    for key in ("x", "A", "b"):
        assert all(np.array_equal(u, v) for u, v in zip(a[key], b[key]))
    a, b = tds.load_lasa("Synth", root=str(tmp_path)), jds.load_lasa("Synth", root=str(tmp_path))
    assert len(a) == 3 and a[0]["pos"].shape == (60, 2) and a[0]["t"].shape == (60,)
    np.testing.assert_allclose(a[0]["pos"][-1], 0.0, atol=1e-12)
    for u, v in zip(a, b):
        assert all(np.array_equal(u[k], v[k]) for k in ("pos", "t", "vel", "acc"))

    # without root or path the loaders look under GPT_REFERENCE_ROOT, and
    # without that they say so
    monkeypatch.delenv(tds.ROOT_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match=tds.ROOT_ENV):
        tds.load_2d_drawing()
    layout = tmp_path / "checkout" / "example" / "2D" / "data"
    layout.mkdir(parents=True)
    np.savez(layout / "example.npz", **arrays)
    monkeypatch.setenv(tds.ROOT_ENV, str(tmp_path / "checkout"))
    assert np.array_equal(tds.load_2d_drawing()["demo"], arrays["demo"])


def test_frame_helpers_match_jax(tmp_path):
    d = tds.load_reach_target(write_reach_file(str(tmp_path / "r.npy"), n_demos=5, T=40))
    np.testing.assert_array_equal(tds.distribution_from_frames(d["A"], d["b"]),
                                  jds.distribution_from_frames(d["A"], d["b"]))
    A1, b1 = tds.generate_frame_orientation(d["A"], d["b"], np.random.RandomState(4))
    A2, b2 = jds.generate_frame_orientation(d["A"], d["b"], np.random.RandomState(4))
    for u, v in zip(A1 + b1, A2 + b2):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_gp_surfaces_from_jax_draws_match_jax():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jds.random_gp_surface(key, n=8))
    normals = np.asarray(jax.random.normal(key, (64,)))
    got = tds.random_gp_surface(normals=torch.tensor(normals), n=8, device="cpu")
    assert got.shape == (8, 8, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    demo_j, old_j, new_j = jds.spiral_demo(key, n_spiral=50, n_lift=20, n_grid=6)
    normals = np.asarray(jax.random.normal(key, (36,)))
    demo_t, old_t, new_t = tds.spiral_demo(normals=torch.tensor(normals), n_spiral=50,
                                           n_lift=20, n_grid=6, device="cpu")
    np.testing.assert_array_equal(demo_t, demo_j)
    np.testing.assert_array_equal(old_t, old_j)
    np.testing.assert_allclose(new_t, np.asarray(new_j), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(new_j)).max())
    # a generator's draws: the same surface for the same seed
    g = lambda: torch.Generator().manual_seed(7)
    np.testing.assert_array_equal(tds.random_gp_surface(g(), n=5, device="cpu"),
                                  tds.random_gp_surface(g(), n=5, device="cpu"))


def test_complete_surface_recovers_a_smooth_surface():
    rng = np.random.RandomState(8)
    pts = rng.uniform(-1, 1, (300, 2))
    z = 0.2 * np.sin(2 * pts[:, 0]) + 0.1 * pts[:, 1]
    cloud = np.column_stack([pts, z + 0.01 * rng.randn(300)])
    dist = tds.complete_surface(cloud, grid_n=6, num_inducing=40, num_epochs=30, device="cpu")
    assert dist.shape == (36, 3)
    gx, gy = np.meshgrid(np.linspace(pts[:, 0].min(), pts[:, 0].max(), 6),
                         np.linspace(pts[:, 1].min(), pts[:, 1].max(), 6))
    np.testing.assert_array_equal(dist[:, :2], np.column_stack([gx.ravel(), gy.ravel()]))
    z_true = 0.2 * np.sin(2 * dist[:, 0]) + 0.1 * dist[:, 1]
    assert np.sqrt(np.mean((dist[:, 2] - z_true) ** 2)) < 0.05


def _tag(id_, pos, ori=(1.0, 0, 0, 0), size=0.1):
    return {"id": id_, "position": np.asarray(pos, float), "orientation": np.asarray(ori, float),
            "size": size}


@pytest.mark.parametrize("use_orientation", [False, True])
def test_tag_adapters_match_jax(use_orientation):
    q = np.array([np.cos(0.4), 0.3 * np.sin(0.4), 0.0, np.sqrt(0.91) * np.sin(0.4)])
    source = [_tag(1, [0, 0, 0]), _tag(2, [1, 0, 0], ori=q), _tag(9, [5, 5, 5])]
    target = [_tag(2, [1, 1, 0], ori=q[[0, 3, 2, 1]]), _tag(1, [0, 1, 0.2], size=0.2)]
    got = ttags.convert_distribution(source, target, use_orientation=use_orientation)
    want = jtags.convert_distribution(source, target, use_orientation=use_orientation)
    assert got[0].shape == ((26, 3) if use_orientation else (2, 3))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    far = [_tag(1, [5, 0, 0]), _tag(2, [1, 0, 0])]
    got = ttags.find_closest_source_to_target([far, source], target, use_orientation)
    want = jtags.find_closest_source_to_target([far, source], target, use_orientation)
    assert got[2] == want[2] == 1
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_array_equal(ttags.marker_corners(0.3), jtags.marker_corners(0.3))
    assert ttags.convert_distribution([_tag(3, [0, 0, 0])], target)[0].shape == (0, 3)


def test_robot_analysis_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    base = rng.standard_normal((25, 3))
    sets = [base, base + 0.1 * rng.standard_normal((25, 3)), rng.standard_normal((18, 3))]
    for name, s in zip(("source", "target_0", "target_1"), sets):
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(s, f)
    loaded = tra.load_recorded_distributions(str(tmp_path))
    assert all(np.array_equal(a, b) for a, b in zip(loaded, sets)) and len(loaded) == 3
    got = tra.distribution_distance_matrices(loaded, device="cpu")
    want = jra.distribution_distance_matrices(loaded)
    for key in ("hausdorff", "chamfer", "max_mse", "pca"):
        np.testing.assert_array_equal(np.isnan(got[key]), np.isnan(want[key]))
        np.testing.assert_allclose(got[key], want[key], **TOL)
    np.testing.assert_allclose(np.diag(got["hausdorff"]), 0.0, atol=1e-12)
    for ft in (rng.standard_normal((6, 40)), rng.standard_normal((40, 6))):
        for a, b in zip(tra.force_norm_trace({"recorded_force_torque": ft}),
                        jra.force_norm_trace({"recorded_force_torque": ft})):
            np.testing.assert_array_equal(a, b)


def test_drawing_recorder_writes_the_same_file_as_jax(tmp_path):
    t = np.linspace(0, 1, 30)
    segments = (np.stack([t * 10, np.sin(t)], 1), np.stack([t * 10, -np.ones_like(t)], 1),
                np.stack([t * 10, -1 + np.sin(2 * t)], 1))
    for cls, name in ((DrawingRecorder, "torch.npz"), (JRecorder, "jax.npz")):
        rec = cls(interactive=False)
        for seg, mark in zip(segments, ("mark_demo", "mark_floor", "mark_newfloor")):
            rec.feed(seg)
            getattr(rec, mark)()
        rec.save(str(tmp_path / name))
    a, b = np.load(tmp_path / "torch.npz"), np.load(tmp_path / "jax.npz")
    assert a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    assert a["demo"].shape == (30, 2)
