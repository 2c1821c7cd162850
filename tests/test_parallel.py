"""Sharded rendering: bit-identical to single-device, psum'd training step.

Runs on the 8-virtual-device CPU mesh (conftest). This is the without-a-pod
validation path from SURVEY.md §4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.models.procedural import cornell_box_scene
from pathtracer_tpu.models.scene import RenderSettings


@pytest.fixture(scope="module")
def box():
    return cornell_box_scene()


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single(box):
    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_sharded
    from pathtracer_tpu.render import render

    scene, camera = box
    settings = RenderSettings(width=16, height=16, samples_per_pixel=2, max_depth=4)
    single = np.asarray(render(scene, camera, settings))
    sharded = np.asarray(
        render_sharded(scene, camera, settings, mesh=make_mesh())
    )
    # Counter-based RNG makes these bit-identical, not just close.
    np.testing.assert_array_equal(single, sharded)


def test_pool_sharded_matches_single(box):
    """Sharded regenerative pool ≡ single-device pool: per-path radiance is
    bit-identical (counter RNG); image differs only by fp summation order."""
    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_pool_sharded
    from pathtracer_tpu.render import render

    scene, camera = box
    settings = RenderSettings(
        width=16, height=16, samples_per_pixel=8, max_depth=4,
        scheduler="regen",
    )
    single = np.asarray(render(scene, camera, settings))
    sharded = np.asarray(
        render_pool_sharded(scene, camera, settings, mesh=make_mesh())
    )
    np.testing.assert_allclose(single, sharded, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("n_dev", [3, 5, 7])
def test_pool_sharded_odd_device_counts(box, n_dev):
    """Non-power-of-two meshes: both the per-device id
    slicing (ceil division + ragged tail) and the psum reduce must be
    correct when the device count does not divide the ray-id space."""
    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_pool_sharded
    from pathtracer_tpu.render import render

    scene, camera = box
    settings = RenderSettings(
        width=16, height=16, samples_per_pixel=3, max_depth=4,
        scheduler="regen",
    )
    mesh = make_mesh(jax.devices()[:n_dev])
    single = np.asarray(render(scene, camera, settings))
    sharded = np.asarray(
        render_pool_sharded(scene, camera, settings, mesh=mesh)
    )
    np.testing.assert_allclose(single, sharded, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("n_dev", [3, 7])
def test_scan_sharded_odd_device_counts(box, n_dev):
    """Scan-path sharding at odd device counts stays bit-identical (the
    pad-with-clamped-duplicate-ids path, sliced off after the wave)."""
    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_sharded
    from pathtracer_tpu.render import render

    scene, camera = box
    settings = RenderSettings(width=10, height=10, samples_per_pixel=2, max_depth=3)
    assert (10 * 10) % n_dev != 0
    mesh = make_mesh(jax.devices()[:n_dev])
    single = np.asarray(render(scene, camera, settings))
    sharded = np.asarray(render_sharded(scene, camera, settings, mesh=mesh))
    np.testing.assert_array_equal(single, sharded)


def test_pool_sharded_ragged_id_space(box):
    """Total ray count not divisible by the mesh: the last device's slice is
    ragged (id_limit masks the tail) and the result still matches."""
    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_pool_sharded
    from pathtracer_tpu.render import render

    scene, camera = box
    settings = RenderSettings(
        width=15, height=15, samples_per_pixel=3, max_depth=4,
        scheduler="regen",
    )
    assert (15 * 15 * 3) % 8 != 0
    single = np.asarray(render(scene, camera, settings))
    sharded = np.asarray(
        render_pool_sharded(scene, camera, settings, mesh=make_mesh())
    )
    np.testing.assert_allclose(single, sharded, rtol=3e-5, atol=3e-6)


def test_sharded_render_pads_non_divisible(box):
    """500x500-style non-divisible pixel counts render."""
    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_sharded
    from pathtracer_tpu.render import render

    scene, camera = box
    settings = RenderSettings(
        width=9, height=7, samples_per_pixel=2, max_depth=3, scheduler="scan"
    )
    assert (9 * 7) % 8 != 0
    single = np.asarray(render(scene, camera, settings))
    sharded = np.asarray(
        render_sharded(scene, camera, settings, mesh=make_mesh())
    )
    np.testing.assert_array_equal(single, sharded)


def test_sharded_train_step_runs_and_reduces(box):
    import optax

    from pathtracer_tpu.inverse import make_train_step, material_params
    from pathtracer_tpu.parallel.mesh import make_mesh

    scene, camera = box
    settings = RenderSettings(width=8, height=8, max_depth=3)
    mesh = make_mesh()
    params = material_params(scene)
    optimizer = optax.sgd(1e-2)
    opt_state = optimizer.init(params)
    step = make_train_step(settings, optimizer, mesh=mesh)

    n = settings.width * settings.height
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    pixel_ids = jnp.arange(n, dtype=jnp.uint32)
    sample_ids = jnp.zeros((n,), jnp.uint32)
    target = jnp.zeros((n, 3))

    new_params, _, loss = step(
        params, opt_state, scene, frame, target, pixel_ids, sample_ids,
        sample_ids + 1,
    )
    assert np.isfinite(float(loss))
    # Params actually moved.
    delta = sum(
        float(jnp.abs(new_params[k] - params[k]).sum()) for k in params
    )
    assert delta > 0.0


def test_sharded_display_space_step_matches_unsharded(box):
    """Display-space training (loss in tonemapped [0, 1] space) under the
    mesh: previously only exercised unsharded. The
    psum'd gradient must match the single-device gradient — the tonemap is
    per-pixel, so sharding the pixel axis commutes with it."""
    import optax

    from pathtracer_tpu.inverse import make_train_step, material_params
    from pathtracer_tpu.parallel.mesh import make_mesh

    scene, camera = box
    settings = RenderSettings(width=8, height=8, max_depth=3)
    params = material_params(scene)
    optimizer = optax.sgd(1e-1)
    opt_state = optimizer.init(params)

    n = settings.width * settings.height
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    pixel_ids = jnp.arange(n, dtype=jnp.uint32)
    sample_ids = jnp.zeros((n,), jnp.uint32)
    target = jnp.full((n, 3), 0.25)

    step_single = make_train_step(
        settings, optimizer, mesh=None, loss_space="display"
    )
    step_sharded = make_train_step(
        settings, optimizer, mesh=make_mesh(), loss_space="display"
    )
    p1, _, l1 = step_single(
        params, opt_state, scene, frame, target, pixel_ids, sample_ids,
        sample_ids + 1,
    )
    p2, _, l2 = step_sharded(
        params, opt_state, scene, frame, target, pixel_ids, sample_ids,
        sample_ids + 1,
    )
    assert np.isfinite(float(l1))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(
            np.asarray(p1[k]), np.asarray(p2[k]), rtol=1e-4, atol=1e-6
        )


def test_sharded_grads_match_unsharded(box):
    import optax

    from pathtracer_tpu.inverse import make_train_step, material_params
    from pathtracer_tpu.parallel.mesh import make_mesh

    scene, camera = box
    settings = RenderSettings(width=8, height=8, max_depth=3)
    params = material_params(scene)
    optimizer = optax.sgd(1e-1)
    opt_state = optimizer.init(params)

    n = settings.width * settings.height
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    pixel_ids = jnp.arange(n, dtype=jnp.uint32)
    sample_ids = jnp.zeros((n,), jnp.uint32)
    target = jnp.zeros((n, 3))

    step_single = make_train_step(settings, optimizer, mesh=None)
    step_sharded = make_train_step(settings, optimizer, mesh=make_mesh())
    p1, _, l1 = step_single(
        params, opt_state, scene, frame, target, pixel_ids, sample_ids,
        sample_ids + 1,
    )
    p2, _, l2 = step_sharded(
        params, opt_state, scene, frame, target, pixel_ids, sample_ids,
        sample_ids + 1,
    )
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for k in p1:
        np.testing.assert_allclose(
            np.asarray(p1[k]), np.asarray(p2[k]), rtol=1e-4, atol=1e-6
        )


def test_pool_sharded_shortlist_intersector(reference_root):
    """Sharded pool with the shortlist intersector (the production
    large-scene path) matches the single-device render on a >2048-tri
    scene — exercises the shortlist's while_loop + data-dependent state
    under shard_map."""
    from pathtracer_tpu.models.scene import load_scene
    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_pool_sharded
    from pathtracer_tpu.render import render

    ini = str(reference_root / "scene_files/final/refraction.ini")
    scene, camera, settings, _ = load_scene(
        ini, width=12, height=12, samples_per_pixel=2,
        intersector="shortlist", scheduler="regen",
    )
    import dataclasses

    settings = dataclasses.replace(settings, max_depth=3)
    single = np.asarray(render(scene, camera, settings))
    sharded = np.asarray(
        render_pool_sharded(scene, camera, settings, mesh=make_mesh())
    )
    np.testing.assert_allclose(single, sharded, rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("k", [2, 4])
def test_pool_spawn_chunk_matches_unchunked(box, k):
    """spawn_chunk=K (in-lane accumulation over K samples/pixel, one flush
    per chunk) must reproduce the K=1 render up to fp accumulation order —
    including ragged spp (spp % K != 0 exercises the padded id space)."""
    import dataclasses

    from pathtracer_tpu.render import render

    scene, camera = box
    base = RenderSettings(
        width=16, height=16, samples_per_pixel=5, max_depth=4,
        scheduler="regen",
    )
    assert base.samples_per_pixel % k != 0
    ref = np.asarray(render(scene, camera, base))
    chunked = np.asarray(
        render(scene, camera, dataclasses.replace(base, spawn_chunk=k))
    )
    np.testing.assert_allclose(ref, chunked, rtol=3e-5, atol=3e-6)


def test_pool_sharded_spawn_chunk(box):
    """Chunked spawning under the mesh: K-aligned per-device id slices."""
    import dataclasses

    from pathtracer_tpu.parallel.mesh import make_mesh
    from pathtracer_tpu.parallel.render import render_pool_sharded
    from pathtracer_tpu.render import render

    scene, camera = box
    settings = RenderSettings(
        width=16, height=16, samples_per_pixel=6, max_depth=4,
        scheduler="regen", spawn_chunk=4,
    )
    single = np.asarray(render(scene, camera, settings))
    sharded = np.asarray(
        render_pool_sharded(scene, camera, settings, mesh=make_mesh())
    )
    np.testing.assert_allclose(single, sharded, rtol=3e-5, atol=3e-6)


def test_resolve_spawn_chunk_auto_rule():
    """Auto chunking engages only with >= 16 chunks/lane of stealing
    slack."""
    from pathtracer_tpu.ops.wavefront import (
        pool_ids_total,
        resolve_spawn_chunk,
    )

    auto = RenderSettings(spawn_chunk=0)
    # 512^2 @ spp16: 4.2M paths vs 16*2*262144 = 8.4M -> stays 1.
    assert resolve_spawn_chunk(auto, 512 * 512, 16) == 1
    # 512^2 @ spp50: middle band -> K=2.
    assert resolve_spawn_chunk(auto, 512 * 512, 50) == 2
    # 512^2 @ spp1024: 268M paths -> K=4.
    assert resolve_spawn_chunk(auto, 512 * 512, 1024) == 4
    # Short-path regimes chunk regardless of slack (flush-throttle fix).
    dlo = RenderSettings(spawn_chunk=0, direct_lighting_only=True)
    assert resolve_spawn_chunk(dlo, 512 * 512, 16) == 4
    lowp = RenderSettings(spawn_chunk=0, rr_prob=0.1)
    assert resolve_spawn_chunk(lowp, 512 * 512, 16) == 4
    # Explicit settings pass through.
    assert resolve_spawn_chunk(RenderSettings(spawn_chunk=8), 64, 4) == 8
    assert resolve_spawn_chunk(RenderSettings(spawn_chunk=1), 512 * 512, 1024) == 1
    # Padded id space is consistent with the resolved K.
    st = RenderSettings(spawn_chunk=0)
    assert pool_ids_total(st, 512 * 512, 1022) == 512 * 512 * 1024  # pad to 4
    assert pool_ids_total(st, 512 * 512, 16) == 512 * 512 * 16  # K = 1
