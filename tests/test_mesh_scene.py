"""Seeded large-mesh scene (procedural.mesh_scene) and the XLA shortlist on
it: exact agreement with the brute sweep, and a finite ``auto`` render."""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.models.procedural import bumpy_torus, mesh_scene
from pathtracer_tpu.models.scene import RenderSettings
from pathtracer_tpu.ops.intersect import closest_tri_brute, resolve_intersector


@pytest.fixture(scope="module")
def mesh():
    return mesh_scene(2500, seed=3)


def _rays(rng_np, n=1024):
    """Half camera-like rays from the front, half from inside the room."""
    o = np.concatenate([
        np.broadcast_to([0.0, 1.0, 3.6], (n // 2, 3)),
        rng_np.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n - n // 2, 3)),
    ])
    d = rng_np.normal(size=(n, 3))
    d[: n // 2, 2] = -np.abs(d[: n // 2, 2]) - 1.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def test_mesh_scene_size_and_seed():
    pts, faces = bumpy_torus(2500, seed=3)
    assert abs(len(faces) - 2500) < 60
    assert faces.max() == len(pts) - 1
    again, _ = bumpy_torus(2500, seed=3)
    other, _ = bumpy_torus(2500, seed=4)
    np.testing.assert_array_equal(pts, again)
    assert not np.allclose(pts, other)
    # Inside the room (x, z in [-1, 1], y in [0, 2]).
    assert (np.abs(pts[:, [0, 2]]) < 1.0).all()
    assert ((pts[:, 1] > 0.0) & (pts[:, 1] < 2.0)).all()


def test_mesh_shortlist_matches_brute_exactly(mesh, rng_np):
    from pathtracer_tpu.ops.intersect_shortlist import closest_tri_shortlist

    scene, _ = mesh
    o, d = _rays(rng_np)
    t0, id0 = (np.asarray(a) for a in closest_tri_brute(scene, o, d))
    t1, id1 = (np.asarray(a) for a in closest_tri_shortlist(scene, o, d))
    hit = np.isfinite(t0)
    assert 0.3 < hit.mean()
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(id0[hit], id1[hit])


def test_mesh_shortlist_occlusion_matches_brute(mesh, rng_np):
    from pathtracer_tpu.ops.intersect_shortlist import occluded_tri_shortlist

    scene, _ = mesh
    o, d = _rays(rng_np)
    t_cut = jnp.asarray(rng_np.uniform(0.05, 3.0, o.shape[0]), jnp.float32)
    t0, _ = closest_tri_brute(scene, o, d)
    expected = np.asarray(t0 < t_cut)
    assert 0 < expected.sum() < len(expected)
    np.testing.assert_array_equal(
        expected, np.asarray(occluded_tri_shortlist(scene, o, d, t_cut))
    )


@pytest.mark.parametrize("intersector", ["auto", "shortlist"])
def test_mesh_renders_finite(mesh, intersector):
    """Through auto (the brute sweep) and through the shortlist, whose
    pool sorts its rays."""
    from pathtracer_tpu.render import render_image

    scene, camera = mesh
    settings = RenderSettings(width=16, height=16, samples_per_pixel=1,
                              max_depth=3, intersector=intersector)
    assert resolve_intersector(settings, scene) == (
        "brute" if intersector == "auto" else "shortlist"
    )
    img = np.asarray(render_image(scene, camera, settings))
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.0
