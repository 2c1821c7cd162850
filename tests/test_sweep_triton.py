"""Triton small-scene sweep (ops.sweep_triton) in interpret mode: exact
agreement with the XLA brute sweep, and the same renders through
``intersector="sweep"``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.models.procedural import cornell_box_scene
from pathtracer_tpu.models.scene import RenderSettings
from pathtracer_tpu.ops.intersect import closest_tri_brute, occluded_before
from pathtracer_tpu.ops.sweep_triton import BLOCK, closest_tri_sweep, sweep_table


@pytest.fixture(scope="module")
def box():
    return cornell_box_scene()


def _rays(rng_np, n):
    o = rng_np.uniform(-0.9, 0.9, (n, 3)) * [1, 0, 1] + [0, 1, 0]
    d = rng_np.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


@pytest.mark.parametrize("n", [BLOCK, 3 * BLOCK + 17])
def test_sweep_matches_brute_exactly(box, rng_np, n):
    scene, _ = box
    o, d = _rays(rng_np, n)
    t0, id0 = (np.asarray(a) for a in closest_tri_brute(scene, o, d))
    t1, id1 = (np.asarray(a) for a in closest_tri_sweep(scene, o, d,
                                                        interpret=True))
    assert t1.shape == (n,) and id1.dtype == np.int32
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(id0, id1)


def test_sweep_table_layout(box):
    scene, _ = box
    table, n = sweep_table(scene)
    assert n == 40  # 36 tris rounded to 8
    assert table.shape == (9, 64)  # padded to a power of two
    np.testing.assert_array_equal(np.asarray(table[:3, :36]).T,
                                  np.asarray(scene.tri_v0[:36]))
    assert not np.asarray(table[3:, 36:]).any()  # padding: zero edges


def test_sweep_occlusion_matches_brute(box, rng_np):
    scene, _ = box
    o, d = _rays(rng_np, 512)
    t_max = jnp.asarray(rng_np.uniform(0.05, 3.0, 512), jnp.float32)
    ref = occluded_before(scene, o, d, t_max, RenderSettings(intersector="brute"))
    got = occluded_before(scene, o, d, t_max, RenderSettings(intersector="sweep"))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sweep_render_matches_brute(box):
    from pathtracer_tpu.render import render

    scene, camera = box
    st = RenderSettings(width=16, height=16, samples_per_pixel=2, max_depth=3,
                        intersector="brute")
    ref = np.asarray(render(scene, camera, st))
    got = np.asarray(render(scene, camera,
                            dataclasses.replace(st, intersector="sweep")))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_sweep_gradient_matches_brute(box):
    """The kernel's outputs carry no gradient, and need none: material
    gradients through ``sweep`` equal those through ``brute``."""
    import jax

    from pathtracer_tpu.inverse import material_params, pixel_loss

    scene, camera = box
    frame = {k: jnp.asarray(v) for k, v in camera.ray_frame(8, 8).items()}
    n = 64
    grads = []
    for name in ("brute", "sweep"):
        st = RenderSettings(width=8, height=8, samples_per_pixel=1,
                            max_depth=3, scheduler="scan", intersector=name)
        grads.append(jax.grad(lambda p, st=st: pixel_loss(
            p, scene, st, frame, jnp.zeros((n, 3)),
            jnp.arange(n, dtype=jnp.uint32), jnp.zeros((n,), jnp.uint32),
        ))(material_params(scene, ("mat_Kd",)))["mat_Kd"])
    assert np.abs(np.asarray(grads[0])).sum() > 0
    np.testing.assert_allclose(np.asarray(grads[1]), np.asarray(grads[0]),
                               rtol=1e-6, atol=1e-9)


def test_sweep_under_shard_map(box):
    """The kernel inside the sharded pool and the sharded train step."""
    import jax
    import optax

    from pathtracer_tpu.inverse import make_train_step, material_params
    from pathtracer_tpu.ops.wavefront import render_regenerative
    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_pool_sharded

    scene, camera = box
    mesh = make_mesh(jax.devices()[:4])
    st = RenderSettings(width=16, height=16, samples_per_pixel=4,
                        intersector="sweep")
    np.testing.assert_allclose(
        np.asarray(render_pool_sharded(scene, camera, st, mesh=mesh)),
        np.asarray(render_regenerative(scene, camera, st)),
        rtol=3e-5, atol=3e-6,
    )
    ts = dataclasses.replace(st, width=8, height=8, samples_per_pixel=1)
    frame = {k: jnp.asarray(v) for k, v in camera.ray_frame(8, 8).items()}
    params, opt = material_params(scene), optax.adam(1e-2)
    args = (jnp.zeros((64, 3)), jnp.arange(64, dtype=jnp.uint32),
            jnp.zeros((64,), jnp.uint32), jnp.ones((64,), jnp.uint32))
    losses = [
        float(make_train_step(ts, opt, mesh=m)(
            params, opt.init(params), scene, frame, *args)[2])
        for m in (mesh, None)
    ]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_auto_sweep_runs_on_cpu_device_in_gpu_process(box, monkeypatch):
    """With a GPU as default backend, auto picks ``sweep``; a computation
    placed on the CPU must still run (the kernel lowers per platform)."""
    import jax

    from pathtracer_tpu.ops.intersect import resolve_intersector
    from pathtracer_tpu.render import render

    scene, camera = box
    st = RenderSettings(width=8, height=8, samples_per_pixel=1, max_depth=3,
                        scheduler="scan")
    ref = np.asarray(render(scene, camera, st))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_intersector(st, scene) == "sweep"
    with jax.default_device(jax.devices("cpu")[0]):
        got = np.asarray(render(scene, camera, st))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
