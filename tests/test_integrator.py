"""Integrator correctness: determinism, estimator sanity, intersector
equivalence, analytic primitives (SURVEY.md §4 test pyramid)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.models.procedural import cornell_box_scene
from pathtracer_tpu.models.scene import RenderSettings
from pathtracer_tpu.ops import rng
from pathtracer_tpu.ops.camera_rays import generate_rays
from pathtracer_tpu.ops.integrator import radiance_batch
from pathtracer_tpu.ops.intersect import closest_tri_brute, intersect


@pytest.fixture(scope="module")
def box():
    scene, camera = cornell_box_scene()
    return scene, camera


def _rays(camera, settings, n, sample=0):
    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    pixel_ids = jnp.arange(n, dtype=jnp.uint32)
    sample_ids = jnp.full((n,), sample, dtype=jnp.uint32)
    jitter = rng.pixel_jitter_hash(pixel_ids, sample_ids)
    o, d = generate_rays(frame, settings.width, settings.height, pixel_ids, jitter)
    return o, d, pixel_ids, sample_ids


SMALL = RenderSettings(width=16, height=16, samples_per_pixel=1, max_depth=4)


class TestRng:
    def test_hash_uniformity(self):
        ids = jnp.arange(1 << 16, dtype=jnp.uint32)
        u = rng.hash_uniform(ids, ids * 0, 3)
        u = np.asarray(u)
        assert abs(u.mean() - 0.5) < 0.01
        assert abs(u.var() - 1.0 / 12.0) < 0.01
        # Neighboring counters decorrelated.
        v = np.asarray(rng.hash_uniform(ids, ids * 0, 4))
        assert abs(np.corrcoef(u, v)[0, 1]) < 0.02

    def test_hash_distinct_across_samples(self):
        ids = jnp.arange(1024, dtype=jnp.uint32)
        a = np.asarray(rng.hash_uniform(ids, ids * 0, 0))
        b = np.asarray(rng.hash_uniform(ids, ids * 0 + 1, 0))
        assert not np.allclose(a, b)

    def test_range(self):
        ids = jnp.arange(4096, dtype=jnp.uint32)
        u = np.asarray(rng.bounce_uniforms_hash(ids, ids, jnp.int32(5)))
        assert (u >= 0).all() and (u < 1).all()


class TestIntersect:
    def test_brute_matches_bruteforce_numpy(self, box, rng_np):
        scene, _ = box
        n = 64
        o = jnp.asarray(rng_np.uniform(-0.9, 0.9, (n, 3)) * [1, 0, 1] + [0, 1, 0])
        d = jnp.asarray(rng_np.normal(size=(n, 3)))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        t, tid = closest_tri_brute(scene, o, d)
        t = np.asarray(t)
        tid = np.asarray(tid)
        # The box is open at the front (like CornellBox-Original), so only
        # most rays hit; every reported hit must be a valid triangle.
        hit = np.isfinite(t)
        assert hit.mean() > 0.7
        assert (tid[hit] >= 0).all()
        assert (tid[hit] < scene.num_tris).all()
        assert (t[hit] > 0).all()

    def test_analytic_sphere_closed_form(self):
        from pathtracer_tpu.models.obj import ObjMaterial
        from pathtracer_tpu.models.pack import pack_scene
        from pathtracer_tpu.models.scene import _to_device
        from pathtracer_tpu.utils.math import mat4_translate

        packed = pack_scene(
            None,
            analytic=[("sphere", mat4_translate(0, 0, -3), ObjMaterial(Kd=(1, 0, 0)))],
        )
        scene = _to_device(packed)
        o = jnp.array([[0.0, 0.0, 0.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        hit = intersect(scene, o, d, SMALL)
        assert bool(hit.hit[0])
        np.testing.assert_allclose(float(hit.t[0]), 2.5, rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(hit.normal[0]), [0, 0, 1], atol=1e-5
        )

    def test_analytic_cube_closed_form(self):
        from pathtracer_tpu.models.obj import ObjMaterial
        from pathtracer_tpu.models.pack import pack_scene
        from pathtracer_tpu.models.scene import _to_device
        from pathtracer_tpu.utils.math import mat4_translate

        packed = pack_scene(
            None,
            analytic=[("cube", mat4_translate(0, 0, -2), ObjMaterial(Kd=(1, 0, 0)))],
        )
        scene = _to_device(packed)
        o = jnp.array([[0.0, 0.0, 0.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        hit = intersect(scene, o, d, SMALL)
        assert bool(hit.hit[0])
        np.testing.assert_allclose(float(hit.t[0]), 1.5, rtol=1e-5)


class TestRadiance:
    def test_finite_and_deterministic(self, box):
        scene, camera = box
        o, d, pids, sids = _rays(camera, SMALL, 256)
        r1 = radiance_batch(scene, SMALL, o, d, pids, sids)
        r2 = radiance_batch(scene, SMALL, o, d, pids, sids)
        r1, r2 = np.asarray(r1), np.asarray(r2)
        assert np.isfinite(r1).all()
        np.testing.assert_array_equal(r1, r2)

    def test_chunking_invariance(self, box):
        """Half-batch renders must equal the full-batch render exactly —
        the counter-based RNG guarantees placement independence."""
        scene, camera = box
        o, d, pids, sids = _rays(camera, SMALL, 256)
        full = np.asarray(radiance_batch(scene, SMALL, o, d, pids, sids))
        lo = np.asarray(radiance_batch(scene, SMALL, o[:128], d[:128], pids[:128], sids[:128]))
        hi = np.asarray(radiance_batch(scene, SMALL, o[128:], d[128:], pids[128:], sids[128:]))
        np.testing.assert_array_equal(full, np.concatenate([lo, hi]))

    def test_emissive_hit_at_depth0(self, box):
        """A ray straight at the light returns its Ke (depth-0 emissive add,
        program-raymarch.wgsl:136-141) plus possible NEE extras; radiance
        must be at least Ke for the primary hit."""
        scene, camera = box
        o = jnp.array([[0.0, 1.0, 0.0]])
        d = jnp.array([[0.0, 1.0, 0.0]])  # straight up at the light quad
        pids = jnp.zeros((1,), jnp.uint32)
        sids = jnp.zeros((1,), jnp.uint32)
        r = np.asarray(radiance_batch(scene, SMALL, o, d, pids, sids))[0]
        np.testing.assert_allclose(r, [17.0, 12.0, 4.0], rtol=1e-5)

    def test_direct_only_darker_than_full(self, box):
        scene, camera = box
        settings_full = RenderSettings(width=16, height=16, max_depth=6)
        settings_direct = RenderSettings(
            width=16, height=16, max_depth=6, direct_lighting_only=True
        )
        full, direct = 0.0, 0.0
        for s in range(4):  # average a few samples — single waves are noisy
            o, d, pids, sids = _rays(camera, settings_full, 256, sample=s)
            full += float(
                np.maximum(
                    np.asarray(radiance_batch(scene, settings_full, o, d, pids, sids)), 0
                ).mean()
            )
            direct += float(
                np.maximum(
                    np.asarray(
                        radiance_batch(scene, settings_direct, o, d, pids, sids)
                    ),
                    0,
                ).mean()
            )
        assert direct < full
        assert direct > 0.0

    def test_shadow_modes_agree(self, box):
        """fast (t-only occlusion) vs closest (full closest-hit, reference
        semantics): identical on single-light scenes like the CornellBox
        up to the analytic-vs-hit light attributes (float-level)."""
        scene, camera = box
        fast = RenderSettings(width=16, height=16, max_depth=5)
        slow = RenderSettings(
            width=16, height=16, max_depth=5, shadow_mode="closest"
        )
        o, d, pids, sids = _rays(camera, fast, 256)
        rf = np.maximum(np.asarray(radiance_batch(scene, fast, o, d, pids, sids)), 0)
        rc = np.maximum(np.asarray(radiance_batch(scene, slow, o, d, pids, sids)), 0)
        np.testing.assert_allclose(rf, rc, rtol=2e-3, atol=2e-3)

    def test_beckmann_glossy_runs(self, box):
        scene, camera = box
        settings = RenderSettings(
            width=16, height=16, max_depth=4, glossy_brdf="beckmann"
        )
        o, d, pids, sids = _rays(camera, settings, 256)
        r = np.asarray(radiance_batch(scene, settings, o, d, pids, sids))
        assert np.isfinite(r).all()
        assert np.maximum(r, 0.0).mean() > 0.0

    def test_beckmann_brdf_properties(self):
        """Reciprocity-ish sanity: above-horizon, finite, scales with Ks,
        peaks toward the mirror direction."""
        from pathtracer_tpu.ops.bsdf import eval_beckmann

        n = jnp.tile(jnp.array([[0.0, 0.0, 1.0]]), (3, 1))
        w_in = jnp.tile(
            jnp.array([[0.6, 0.0, -0.8]]), (3, 1)
        )  # incoming, into surface
        mirror = jnp.array([[0.6, 0.0, 0.8]])
        off = jnp.array([[0.0, 0.6, 0.8]])
        below = jnp.array([[0.6, 0.0, -0.8]])
        w_out = jnp.concatenate([mirror, off, below])
        ks = jnp.ones((3, 3))
        ns = jnp.full((3,), 40.0)
        f = np.asarray(eval_beckmann(ks, ns, w_in, w_out, n))
        assert np.isfinite(f).all()
        assert (f >= 0).all()
        assert f[0, 0] > f[1, 0]  # mirror direction beats off-specular
        assert f[2, 0] == 0.0  # below horizon -> zero
        f2 = np.asarray(eval_beckmann(2.0 * ks, ns, w_in, w_out, n))
        np.testing.assert_allclose(f2, 2.0 * f, rtol=1e-6)

    def test_threefry_mode_runs(self, box):
        scene, camera = box
        settings = RenderSettings(width=8, height=8, max_depth=3, rng="threefry")
        o, d, pids, sids = _rays(camera, settings, 64)
        r = np.asarray(radiance_batch(scene, settings, o, d, pids, sids))
        assert np.isfinite(r).all()
        # Raw radiance may be negative (unclamped NEE cos terms, clamped at
        # accumulation like the reference) — check the clamped mean.
        assert np.maximum(r, 0.0).mean() > 0.0


class TestGradients:
    def test_grad_matches_finite_difference(self, box):
        """Path-replay gradients vs central finite differences on the white
        wall albedo (BASELINE.json config 5 gate)."""
        scene, camera = box
        settings = RenderSettings(width=8, height=8, max_depth=3)
        o, d, pids, sids = _rays(camera, settings, 64)

        def loss(kd):
            s = scene.replace(mat_Kd=kd)
            r = radiance_batch(s, settings, o, d, pids, sids)
            return jnp.mean(r)

        kd0 = scene.mat_Kd
        g = jax.grad(loss)(kd0)
        eps = 1e-3
        for idx in [(0, 0), (1, 1), (3, 2)]:
            e = jnp.zeros_like(kd0).at[idx].set(eps)
            fd = (loss(kd0 + e) - loss(kd0 - e)) / (2 * eps)
            assert abs(float(g[idx]) - float(fd)) < 5e-3 + 0.05 * abs(float(fd)), (
                idx, float(g[idx]), float(fd)
            )

    def test_emission_grad_nonzero(self, box):
        scene, camera = box
        settings = RenderSettings(width=8, height=8, max_depth=3)
        o, d, pids, sids = _rays(camera, settings, 64)

        def loss(ke):
            s = scene.replace(mat_Ke=ke)
            return jnp.mean(radiance_batch(s, settings, o, d, pids, sids))

        g = jax.grad(loss)(scene.mat_Ke)
        # Light material (row 3) must receive gradient.
        assert float(jnp.abs(g[3]).sum()) > 0.0
