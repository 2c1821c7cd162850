"""Card-only checks (marker ``gpu``): skip without a GPU; run on one with
``PT_TPU_TEST_REAL_DEVICE=1 python -m pytest tests/ -m gpu``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.models.procedural import cornell_box_scene, mesh_scene
from pathtracer_tpu.models.scene import RenderSettings

pytestmark = pytest.mark.gpu


def test_shortlist_matches_brute_on_gpu(gpu_device, rng_np):
    from pathtracer_tpu.ops.intersect import closest_tri_brute
    from pathtracer_tpu.ops.intersect_shortlist import closest_tri_shortlist

    scene, _ = mesh_scene(12_600, seed=0)
    scene = jax.device_put(scene, gpu_device)
    o = rng_np.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (4096, 3))
    d = rng_np.normal(size=(4096, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (jax.device_put(jnp.asarray(a, jnp.float32), gpu_device)
            for a in (o, d))
    t0, id0 = (np.asarray(a) for a in closest_tri_brute(scene, o, d))
    t1, id1 = (np.asarray(a) for a in closest_tri_shortlist(scene, o, d))
    hit = np.isfinite(t0)
    np.testing.assert_array_equal(t0, t1)
    np.testing.assert_array_equal(id0[hit], id1[hit])


def test_pool_matches_scan_on_gpu(gpu_device):
    from pathtracer_tpu.render import render

    scene, camera = cornell_box_scene()
    settings = RenderSettings(width=64, height=64, samples_per_pixel=4)
    with jax.default_device(gpu_device):
        pool = np.asarray(render(scene, camera, settings))
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(render(
                scene, camera,
                dataclasses.replace(settings, scheduler="scan",
                                    intersector="brute"),
            ))
    assert np.isfinite(pool).all()
    assert abs(pool.mean() - ref.mean()) <= 1e-5 * ref.mean()
