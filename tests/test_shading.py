"""Vertex-normal smooth shading.

The reference parses vertex normals but abandons interpolation
(parse-obj.ts:41-55; intersection-logic.wgsl:81-108 commented out). Here
``RenderSettings.use_vertex_normals`` must actually change shaded pixels:
``Hit.normal_shade`` drives NEE and BSDF sampling in the integrator.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.models.scene import RenderSettings, load_scene
from pathtracer_tpu.ops.intersect import closest_hit
from pathtracer_tpu.render import render
from pathtracer_tpu.utils.image import mse


@pytest.fixture(scope="module")
def sphere_scene(reference_root):
    """CornellBox-Sphere: 1116-vertex-normal smooth sphere mesh."""
    ini = str(reference_root / "scene_files/final/refraction.ini")
    scene, camera, settings, _ = load_scene(
        ini, width=48, height=48, samples_per_pixel=4
    )
    return scene, camera, settings


def test_normal_shade_differs_on_smooth_mesh(sphere_scene):
    """Rays hitting the tessellated sphere get interpolated shading normals
    that differ from the facet (geometric) normals."""
    scene, camera, settings = sphere_scene
    # Rays aimed at the sphere from the camera position (sphere sits near
    # the box center in CornellBox-Sphere.obj).
    o = jnp.tile(jnp.asarray([[0.0, 1.0, 3.0]], jnp.float32), (64, 1))
    ang = jnp.linspace(-0.12, 0.12, 64)
    d = jnp.stack([jnp.sin(ang), jnp.zeros_like(ang) - 0.12, -jnp.cos(ang)], axis=1)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)

    smooth = RenderSettings(use_vertex_normals=True, **{
        k: getattr(settings, k)
        for k in ("width", "height", "samples_per_pixel", "rr_prob")
    })
    hit, _ = closest_hit(scene, o, d, smooth)
    got = np.asarray(hit.hit)
    assert got.any(), "test rays missed the scene entirely"
    ns = np.asarray(hit.normal_shade)[got]
    ng = np.asarray(hit.normal)[got]
    # Unit length everywhere.
    np.testing.assert_allclose(
        np.linalg.norm(ns, axis=1), 1.0, rtol=0, atol=1e-4
    )
    # On at least some sphere hits the interpolated normal deviates from
    # the facet normal (flat walls legitimately agree).
    dev = np.abs(ns - ng).max(axis=1)
    assert dev.max() > 1e-3, "shading normals never differ from geometric"


def test_smooth_render_differs_from_flat(sphere_scene):
    """End-to-end: enabling vertex normals visibly changes the image, and
    disabling them reproduces the golden (geometric) estimator exactly."""
    scene, camera, settings = sphere_scene
    import dataclasses

    flat = dataclasses.replace(settings, use_vertex_normals=False)
    smooth = dataclasses.replace(settings, use_vertex_normals=True)

    img_flat = np.asarray(render(scene, camera, flat))
    img_smooth = np.asarray(render(scene, camera, smooth))
    assert np.isfinite(img_flat).all() and np.isfinite(img_smooth).all()
    assert mse(img_flat, img_smooth) > 1e-5, (
        "use_vertex_normals had no effect on shaded pixels"
    )

    # Geometric mode is the default — bit-identical to a fresh default run.
    img_default = np.asarray(render(scene, camera, settings))
    np.testing.assert_array_equal(img_flat, img_default)
