"""Estimator-option tests.

Covers the two previously-untested settings:

- ``num_direct_lighting_samples > 1`` — the INI key the reference parses
  but ignores (parse-ini.ts:47); honored here as extra NEE samples per
  bounce (ops/integrator._nee). Property: per-pixel variance across sample
  waves shrinks ~4x at 4 light samples, with an unchanged mean.
- ``compat_count_light_pdf=False`` (the ``area`` light pdf) vs the
  reference's count pdf (intersection-logic.wgsl:284). Properties: on an
  equal-area light triangulation the two estimators' NEE terms differ by
  exactly the total emissive area (count = area / A_total in expectation);
  on very-unequal-area lights the count estimator overweights a tiny
  triangle by ~1/area while the area estimator weights it by its actual
  area — the failure mode area sampling exists to fix.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.models.camera import Camera
from pathtracer_tpu.models.obj import ObjMaterial, ObjMesh
from pathtracer_tpu.models.pack import pack_scene
from pathtracer_tpu.models.procedural import cornell_box_scene
from pathtracer_tpu.models.scene import RenderSettings, _to_device
from pathtracer_tpu.render import render, sample_wave


def _waves(scene, camera, settings, n_waves):
    """Stack of per-sample radiance waves [n, H*W, 3]."""
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    return np.stack(
        [
            np.asarray(sample_wave(scene, frame, settings, jnp.uint32(s)))
            for s in range(n_waves)
        ]
    )


def test_num_direct_lighting_samples_variance():
    """N NEE samples/bounce: ~1/N light-sampling variance, same mean.

    Measured at the ``_nee`` estimator itself (a fixed shading point on the
    Cornell floor, many sample ids) so the property is not drowned by
    pixel-jitter variance as it is in a full low-res render.
    """
    import dataclasses

    from pathtracer_tpu.ops import rng
    from pathtracer_tpu.ops.integrator import _nee, _uniforms
    from pathtracer_tpu.ops.intersect import closest_hit

    scene, _ = cornell_box_scene()
    st = RenderSettings(width=8, height=8, max_depth=2, scheduler="scan")
    n = 8192
    pix = jnp.full((n,), 100, jnp.uint32)
    samp = jnp.arange(n, dtype=jnp.uint32)
    o = jnp.tile(jnp.asarray([[0.2, 1.0, 0.1]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (n, 1))
    hit, mat = closest_hit(scene, o, d, st)
    beta = jnp.ones((n, 3))
    active = jnp.ones((n,), bool)

    stats = {}
    for ndl in (1, 4):
        s2 = dataclasses.replace(st, num_direct_lighting_samples=ndl)
        n_uni = (
            rng.BSDF_DIR + 2 if ndl == 1 else rng.STRIDE + 3 * (ndl - 1)
        )
        u = _uniforms(s2, pix, samp, 0, n_uni)
        c, _ = _nee(scene, s2, hit, mat, d, beta, u, active)
        c = np.asarray(c)
        stats[ndl] = (c.mean(axis=0), c.var(axis=0).mean())

    m1, v1 = stats[1]
    m4, v4 = stats[4]
    np.testing.assert_allclose(m4, m1, rtol=0.02)  # same expectation
    ratio = v4 / v1
    assert 0.15 < ratio < 0.4, f"var ratio {ratio:.3f}, want ~0.25"


def test_num_direct_lighting_samples_render_mean():
    """End-to-end: an NDL=4 render agrees with NDL=1 in expectation."""
    scene, camera = cornell_box_scene()
    base = dict(
        width=12, height=12, samples_per_pixel=32, max_depth=2,
        direct_lighting_only=True, scheduler="scan",
    )
    img1 = np.asarray(render(scene, camera, RenderSettings(**base)))
    img4 = np.asarray(
        render(
            scene, camera,
            RenderSettings(**base, num_direct_lighting_samples=4),
        )
    )
    assert np.abs(img4 - img1).mean() < 0.05 * np.abs(img1).mean()


def _two_light_mesh(tiny: float):
    """Floor + two downward-facing ceiling lights; the second is a
    ``tiny`` x ``tiny`` square (equal to the first when tiny = 0.6)."""
    mats = [
        ObjMaterial(name="white", Ns=10, illum=2, Kd=(0.7, 0.7, 0.7)),
        ObjMaterial(name="lampA", Ns=10, illum=2, Ke=(10.0, 10.0, 10.0)),
        ObjMaterial(name="lampB", Ns=10, illum=2, Ke=(10.0, 10.0, 10.0)),
    ]

    def quad(a, b, c, d):
        return [(a, b, c), (a, c, d)]

    tris, mat_ids = [], []

    def add(tlist, m):
        tris.extend(tlist)
        mat_ids.extend([m] * len(tlist))

    add(quad((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2)), 0)  # floor
    # Lights at y = 2, normals pointing -y (winding as in procedural.py).
    add(quad((-1.0, 2, -0.3), (-0.4, 2, -0.3), (-0.4, 2, 0.3), (-1.0, 2, 0.3)), 1)
    add(quad((0.5, 2, 0.0), (0.5 + tiny, 2, 0.0),
             (0.5 + tiny, 2, tiny), (0.5, 2, tiny)), 2)

    verts, index, faces = [], {}, []
    for tri in tris:
        ids = []
        for v in tri:
            if v not in index:
                index[v] = len(verts)
                verts.append(v)
            ids.append(index[v])
        faces.append(ids)
    return ObjMesh(
        positions=np.asarray(verts, dtype=np.float64),
        normals=np.zeros((0, 3)),
        faces=np.asarray(faces, dtype=np.int32),
        face_normals=np.full((len(faces), 3), -1, dtype=np.int32),
        face_material=np.asarray(mat_ids, dtype=np.int32),
        materials=mats,
    )


def _two_light_scene(tiny: float):
    scene = _to_device(pack_scene(_two_light_mesh(tiny)))
    # Camera looks steeply down at the floor so no camera ray reaches the
    # y = 2 light quads (pure-NEE image under direct_lighting_only).
    camera = Camera(
        pos=(0.0, 1.6, 1.2), up=(0.0, 1.0, 0.0),
        focus=(0.0, 0.0, 0.0), height_angle_deg=40.0,
    )
    settings = RenderSettings(
        width=16, height=16, samples_per_pixel=256, max_depth=2,
        direct_lighting_only=True, scheduler="scan",
    )
    return scene, camera, settings


def _render_modes(scene, camera, settings):
    import dataclasses

    count = np.asarray(render(scene, camera, settings))
    area = np.asarray(
        render(
            scene, camera,
            dataclasses.replace(settings, compat_count_light_pdf=False),
        )
    )
    return count, area


def test_area_vs_count_equal_areas_global_scale():
    """Equal-area triangulation: count pdf == area pdf / (n * total_area).

    With n equal-area emissive triangles the two modes pick the *same*
    triangle for the same u (uniform choice == CDF inversion) and the same
    barycentric point; only the weight differs: 1/n vs A_total. The NEE
    images are therefore identical up to the exact factor n * A_total —
    per pixel, not just in expectation.
    """
    scene, camera, settings = _two_light_scene(tiny=0.6)
    a_total = float(jnp.sum(scene.emissive_area))
    n_emissive = int(scene.num_emissive)
    count, area = _render_modes(scene, camera, settings)

    lit = area > 1e-4
    assert lit.mean() > 0.3  # the floor is actually lit
    ratio = count[lit] / np.maximum(area[lit], 1e-12) * a_total * n_emissive
    np.testing.assert_allclose(ratio, 1.0, rtol=1e-4)


def test_area_mode_fixes_tiny_light_overweighting():
    """Unequal areas: count overweights a tiny bright-per-count light.

    Light B is (0.02)^2 = 4e-4 the area of light A. The area estimator
    weights B's contribution by its actual area (negligible); the count
    estimator samples B's 2 triangles half the time at weight 1/4 — B
    contributes ~as much as A despite being 1000x smaller. Measured by
    differencing renders with B's emission on/off (the emissive table and
    hence the sampling distribution stay fixed, so contributions are
    exactly additive in Ke for both estimators).
    """
    scene, camera, settings = _two_light_scene(tiny=0.02)
    scene_off = scene.replace(mat_Ke=scene.mat_Ke.at[2].set(0.0))

    count_on, area_on = _render_modes(scene, camera, settings)
    count_off, area_off = _render_modes(scene_off, camera, settings)

    frac_count = (count_on - count_off).mean() / count_on.mean()
    frac_area = (area_on - area_off).mean() / area_on.mean()
    # Area mode: B's share ~ its share of emissive area (< 2%).
    assert frac_area < 0.02, frac_area
    # Count mode: B gets ~half the samples at full 1/n weight (> 25%).
    assert frac_count > 0.25, frac_count


def test_area_mode_consistency():
    """Area mode at high spp ~= area mode at low spp (consistent estimator)."""
    import dataclasses

    scene, camera, settings = _two_light_scene(tiny=0.02)
    settings = dataclasses.replace(settings, compat_count_light_pdf=False)
    hi = np.asarray(render(scene, camera, settings))
    lo = np.asarray(
        render(
            scene, camera, dataclasses.replace(settings, samples_per_pixel=32)
        )
    )
    lit = hi > 1e-4
    assert np.abs(lo[lit] - hi[lit]).mean() < 0.1 * hi[lit].mean()


def test_rr_low_probability_self_consistency():
    """rr=0.1 estimator oracle: the Russian-roulette
    compensation path (program-raymarch.wgsl:190-193,233,249,297) must be
    *unbiased* — at high spp the rr=0.1 render converges to the rr=0.9
    render of the same scene. The low-probability golden image is itself
    50-spp noise-dominated (BENCH r4: mse_gt 0.018), so this self-
    consistency check is the sharp gate the golden can't provide.

    Noise calibration is empirical: two independent rr=0.1 renders (seeds
    0/1) estimate the per-pixel noise floor; the cross-estimator MSE must
    sit at that floor, not above it. A missing/incorrect 1/rr_prob
    compensation shifts indirect light by ~10x and fails by orders of
    magnitude.
    """
    import dataclasses

    from pathtracer_tpu.ops.tonemap import tonemap_reference

    scene, camera = cornell_box_scene()
    base = RenderSettings(
        width=32, height=32, max_depth=17, scheduler="regen",
    )
    lo1 = dataclasses.replace(base, rr_prob=0.1, samples_per_pixel=1024, seed=0)
    lo2 = dataclasses.replace(base, rr_prob=0.1, samples_per_pixel=1024, seed=1)
    hi = dataclasses.replace(base, rr_prob=0.9, samples_per_pixel=256, seed=2)

    img_lo1 = np.asarray(tonemap_reference(jnp.asarray(render(scene, camera, lo1))))
    img_lo2 = np.asarray(tonemap_reference(jnp.asarray(render(scene, camera, lo2))))
    img_hi = np.asarray(tonemap_reference(jnp.asarray(render(scene, camera, hi))))

    mean_lo = 0.5 * (img_lo1 + img_lo2)
    noise_lo = float(np.mean((img_lo1 - img_lo2) ** 2))  # ~2 * var(lo@1024)
    cross = float(np.mean((mean_lo - img_hi) ** 2))
    # E[cross] = var(lo)/2048 + var(hi)/256 ~ noise_lo/4 + small; a bias
    # delta adds delta^2. Gate at 1.5x the measured noise estimate plus an
    # absolute floor so the test can't pass vacuously on a black image.
    assert mean_lo.mean() > 0.02, "render came out black — not a valid oracle"
    assert cross < 1.5 * noise_lo + 1e-5, (
        f"rr=0.1 disagrees with rr=0.9 beyond noise: cross-MSE {cross:.3e} "
        f"vs noise floor {noise_lo:.3e} — RR compensation is biased"
    )
