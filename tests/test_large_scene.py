"""Large-mesh tests (MedievalBoat, 12.5k triangles).

BASELINE.json config 4 names MedievalBoat.xml as the large-scene stressor
(reference: scene_assets/MedievalBoat.xml, 15216 v / 12571 f). Covers an
end-to-end tiny render (parse -> BVH pack -> wavefront integrate, finite
and non-trivial) and exact cross-intersector agreement on boat rays
(brute sweep vs BVH traversal vs block-shortlist).
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def boat(reference_root):
    from pathtracer_tpu.models.scene import scene_from_graph
    from pathtracer_tpu.models.scenegraph import load_scenegraph

    graph = load_scenegraph(str(reference_root / "scene_assets/MedievalBoat.xml"))
    scene, camera = scene_from_graph(
        graph, str(reference_root / "scene_assets")
    )
    return scene, camera


def test_boat_packs(boat):
    scene, _ = boat
    assert scene.num_tris > 12000
    assert scene.padded_tris % 128 == 0


def test_boat_renders(boat):
    from pathtracer_tpu.models.scene import RenderSettings
    from pathtracer_tpu.render import render_image

    scene, camera = boat
    settings = RenderSettings(
        width=24, height=24, samples_per_pixel=1, max_depth=3
    )
    img = np.asarray(render_image(scene, camera, settings))
    assert img.shape == (24, 24, 3)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.0


def test_boat_intersectors_agree(boat, rng_np):
    """brute / bvh closest-hit agree on boat rays."""
    import jax.numpy as jnp

    from pathtracer_tpu.ops.bvh_traverse import closest_tri_bvh
    from pathtracer_tpu.ops.intersect import closest_tri_brute

    scene, camera = boat
    o = jnp.asarray(
        np.broadcast_to(np.asarray(camera.pos, np.float32), (128, 3)).copy()
    )
    d = rng_np.normal(size=(128, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d.astype(np.float32))

    t0, id0 = (np.asarray(a) for a in closest_tri_brute(scene, o, d))
    t1, id1 = (np.asarray(a) for a in closest_tri_bvh(scene, o, d))
    hit = np.isfinite(t0)
    assert hit.any(), "no boat hits sampled"
    assert np.array_equal(hit, np.isfinite(t1))
    assert np.allclose(t0[hit], t1[hit], rtol=1e-5, atol=1e-6)
    assert np.array_equal(id0[hit], id1[hit])


def test_boat_shortlist_agrees_exactly(boat, rng_np):
    """shortlist closest-hit == brute bit-for-bit on mixed boat rays.

    The shortlist (ops.intersect_shortlist) is the production large-scene
    intersector (`auto` above SHORTLIST_MIN_T); exactness vs brute is its
    correctness contract — same Moller-Trumbore math, different visit order
    only for provably non-improving clusters.
    """
    import jax.numpy as jnp

    from pathtracer_tpu.ops.intersect import closest_tri_brute
    from pathtracer_tpu.ops.intersect_shortlist import closest_tri_shortlist

    scene, camera = boat
    b = 1024
    o = np.broadcast_to(np.asarray(camera.pos, np.float32), (b, 3)).copy()
    o += rng_np.normal(size=(b, 3)).astype(np.float32) * 0.4
    d = rng_np.normal(size=(b, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d.astype(np.float32))

    t0, id0 = (np.asarray(a) for a in closest_tri_brute(scene, o, d))
    hit = np.isfinite(t0)
    assert hit.any()
    for block, k, cluster in ((256, 16, 32), (512, 8, 64), (1024, 8, 128)):
        t1, id1 = (
            np.asarray(a)
            for a in closest_tri_shortlist(
                scene, o, d, block=block, k=k, cluster=cluster
            )
        )
        assert np.array_equal(t0, t1), (block, k, cluster)
        assert np.array_equal(id0[hit], id1[hit]), (block, k, cluster)


def test_boat_shortlist_occlusion_agrees(boat, rng_np):
    """occluded_tri_shortlist == brute occlusion for random cutoffs."""
    import jax.numpy as jnp

    from pathtracer_tpu.ops.intersect import closest_tri_brute
    from pathtracer_tpu.ops.intersect_shortlist import occluded_tri_shortlist

    scene, camera = boat
    b = 1024
    o = np.broadcast_to(np.asarray(camera.pos, np.float32), (b, 3)).copy()
    o += rng_np.normal(size=(b, 3)).astype(np.float32) * 0.4
    d = rng_np.normal(size=(b, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d.astype(np.float32))
    t_cut = jnp.asarray(rng_np.uniform(0.5, 30.0, size=b).astype(np.float32))

    t0, _ = closest_tri_brute(scene, o, d)
    expected = np.asarray(t0 < t_cut)
    got = np.asarray(occluded_tri_shortlist(scene, o, d, t_cut))
    assert np.array_equal(expected, got)


def test_boat_two_stage_extraction(boat, rng_np):
    """closest_hit's large-T winner extraction == direct numpy gathers.

    T > ONEHOT_MAX_T routes attribute extraction through the two-stage
    cluster one-hot (ops.intersect._two_stage_extract); winners' normals,
    material ids, and materials must equal a plain gather by tri_id.
    """
    import jax.numpy as jnp

    from pathtracer_tpu.models.scene import RenderSettings
    from pathtracer_tpu.ops.intersect import ONEHOT_MAX_T, closest_hit

    scene, camera = boat
    assert scene.padded_tris > ONEHOT_MAX_T
    b = 512
    o = np.broadcast_to(np.asarray(camera.pos, np.float32), (b, 3)).copy()
    d = rng_np.normal(size=(b, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d.astype(np.float32))

    for use_vn in (False, True):
        settings = RenderSettings(use_vertex_normals=use_vn)
        hit, mat = closest_hit(scene, o, d, settings)
        hitm = np.asarray(hit.hit)
        assert hitm.any()
        tid = np.asarray(hit.tri_id)[hitm]
        np.testing.assert_array_equal(
            np.asarray(hit.mat_id)[hitm], np.asarray(scene.tri_mat)[tid]
        )
        np.testing.assert_allclose(
            np.asarray(hit.normal)[hitm], np.asarray(scene.tri_n)[tid],
            rtol=0, atol=0,
        )
        np.testing.assert_allclose(
            np.asarray(mat["Kd"])[hitm],
            np.asarray(scene.mat_Kd)[np.asarray(scene.tri_mat)[tid]],
            rtol=0, atol=0,
        )
        if use_vn:
            ns = np.asarray(hit.normal_shade)[hitm]
            assert np.isfinite(ns).all()
            np.testing.assert_allclose(
                np.linalg.norm(ns, axis=1), 1.0, rtol=1e-5
            )
