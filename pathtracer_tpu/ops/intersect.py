"""Closest-hit intersection (jnp reference paths).

Re-design of the reference's device intersection tier:

- ``src/wgsl-util/ray-triangle-intersection.wgsl`` (Moller-Trumbore, eps 1e-8)
- ``src/wgsl-util/intersection-logic.wgsl`` (per-thread stack BVH walk)
- ``src/primitive.wgsl`` (analytic unit sphere/cube — dead in the reference's
  final path, resurrected here as live primitives)

Instead of a divergent per-ray traversal, the baseline intersector here is a
**vectorized masked sweep**: every ray tests every (padded) triangle, tiled
through a ``lax.scan`` carrying a running (t, id) minimum so the [B, T]
intermediate never materializes beyond one tile. On a GPU, small scenes
sweep in one Triton kernel (``ops.sweep_triton``); the block-shortlist
(``ops.intersect_shortlist``) and the masked-stack BVH walk
(``ops.bvh_traverse``) are alternatives and oracles. All share this module's ``Hit``
record so they are interchangeable test oracles for one another.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pathtracer_tpu.utils.pytree import pytree_node

EPS_TRI = 1e-8  # ray-triangle-intersection.wgsl:5
INF = jnp.inf


@pytree_node
class Hit:
    """SoA hit record for a ray batch (cf. ``Intersection``, data-structs.wgsl:32)."""

    hit: jax.Array  # [B] bool
    t: jax.Array  # [B] f32 (inf on miss)
    point: jax.Array  # [B, 3] f32
    normal: jax.Array  # [B, 3] f32 geometric normal
    normal_shade: jax.Array  # [B, 3] f32 shading normal
    mat_id: jax.Array  # [B] i32
    tri_id: jax.Array  # [B] i32 (-1 for miss / analytic prim)


def _moller_trumbore(o, d, v0, e1, e2, valid):
    """Batched MT: rays [B, 3] x triangle tile [T, 3] -> (t [B, T], ok [B, T]).

    Same math and epsilon as the reference kernel
    (ray-triangle-intersection.wgsl:1-42), vectorized over the full
    ray-x-triangle tile with masks in place of branches.

    Layout note: every intermediate is a *componentwise* [B, T] array, so
    the whole test is one dense elementwise pass that XLA fuses with the
    reduction; a [B, T, 3] cross-product layout would make a size-3 axis
    minor and waste most of every vector.
    """
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]  # [B, 1]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    v0x, v0y, v0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]  # [1, T]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]

    # pvec = d x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / jnp.where(jnp.abs(det) > EPS_TRI, det, 1.0)
    # s = o - v0
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    # qvec = s x e1
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (
        (jnp.abs(det) > EPS_TRI)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS_TRI)
        & valid[None, :]
    )
    return jnp.where(ok, t, INF), ok


# Scenes whose 8-rounded triangle count is at or below this sweep in the
# transposed [T, B] layout: rays on the minor axis, triangles padded only to
# a multiple of 8 (40 rows for the 36-tri CornellBox, against the 128 rows
# of the [B, T] layout's padding).
TMAJOR_MAX_T = 256


def _tri_comps_tmajor(scene):
    """Triangle component columns [T8, 1] for the transposed sweep."""
    t8 = (scene.num_tris + 7) // 8 * 8
    v0, e1, e2 = scene.tri_v0[:t8], scene.tri_e1[:t8], scene.tri_e2[:t8]
    return (
        (v0[:, 0:1], v0[:, 1:2], v0[:, 2:3]),
        (e1[:, 0:1], e1[:, 1:2], e1[:, 2:3]),
        (e2[:, 0:1], e2[:, 1:2], e2[:, 2:3]),
        scene.tri_valid[:t8],
    )


def _moller_trumbore_tmajor(scene, o, d):
    """Transposed MT sweep -> (t [T8, B], ok [T8, B]).

    Same math/epsilon as ``_moller_trumbore`` but rays ride the minor axis
    and triangles the (8-padded) major one.
    """
    (v0x, v0y, v0z), (e1x, e1y, e1z), (e2x, e2y, e2z), valid = (
        _tri_comps_tmajor(scene)
    )
    ox, oy, oz = o[None, :, 0], o[None, :, 1], o[None, :, 2]  # [1, B]
    dx, dy, dz = d[None, :, 0], d[None, :, 1], d[None, :, 2]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / jnp.where(jnp.abs(det) > EPS_TRI, det, 1.0)
    sx, sy, sz = ox - v0x, oy - v0y, oz - v0z
    u = (sx * px + sy * py + sz * pz) * inv_det
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = (
        (jnp.abs(det) > EPS_TRI)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS_TRI)
        & valid[:, None]
    )
    return jnp.where(ok, t, INF), ok


def _closest_tri_tmajor(scene, o, d):
    zero = (o[:, 0] + d[:, 0]) * 0.0
    if scene.num_tris == 0:
        return zero + INF, zero.astype(jnp.int32) - 1
    t, _ = _moller_trumbore_tmajor(scene, o, d)
    best_t = jnp.min(t, axis=0) + zero
    best_id = jnp.argmin(t, axis=0).astype(jnp.int32)
    return best_t, jnp.where(jnp.isfinite(best_t), best_id, -1)


def _pick_tile(tp: int, want: int = 512) -> int:
    """Sweep tile size for a padded triangle count (multiple of 128).

    Avoids 128: with one narrow tile per scan step, the per-step
    broadcast/reduce overhead swamps the tests. Small scenes sweep in a
    single tile; otherwise the largest divisor of ``tp`` in [256, 2048]
    (preferring close to ``want``), falling back to 128-wide tiles when
    ``tp`` has no such divisor (tp = 128 * prime).
    """
    if tp <= 2048:
        return tp
    for t in (want, *range(2048, 255, -128)):
        if 256 <= t <= tp and tp % t == 0:
            return t
    # Unreachable for packer-produced scenes (pack.py pads tp > 2048 to a
    # multiple of 512); for hand-built scenes with tp = 128 * prime, prefer
    # the slow-but-bounded 128-wide tile over a single full-width sweep
    # whose fused [B, tp] buffers can blow HBM at B = 262k.
    return 128


def closest_tri_brute(scene, o, d, tile: int = 512):
    """Closest triangle hit by masked sweep -> (t [B], tri_id [B]).

    Small scenes use the transposed [T, B] layout (see TMAJOR_MAX_T);
    otherwise tiles the triangle axis through ``lax.scan`` so peak memory
    is O(B * tile); XLA fuses the per-tile elementwise+reduce into one pass.
    """
    if (scene.num_tris + 7) // 8 * 8 <= TMAJOR_MAX_T:
        return _closest_tri_tmajor(scene, o, d)
    tp = scene.padded_tris
    tile = _pick_tile(tp, want=tile)
    n_tiles = tp // tile
    v0 = scene.tri_v0.reshape(n_tiles, tile, 3)
    e1 = scene.tri_e1.reshape(n_tiles, tile, 3)
    e2 = scene.tri_e2.reshape(n_tiles, tile, 3)
    valid = scene.tri_valid.reshape(n_tiles, tile)

    b = o.shape[0]

    def body(carry, tile_data):
        best_t, best_id = carry
        tv0, te1, te2, tvalid, tile_idx = tile_data
        t, _ = _moller_trumbore(o, d, tv0, te1, te2, tvalid)
        tile_t = jnp.min(t, axis=1)
        tile_arg = jnp.argmin(t, axis=1).astype(jnp.int32) + tile_idx * tile
        better = tile_t < best_t
        return (
            jnp.where(better, tile_t, best_t),
            jnp.where(better, tile_arg, best_id),
        ), None

    # Inits must be *data-dependent* on the ray arrays so they inherit any
    # shard_map varying-axis annotation (scan carry in/out types must match;
    # full_like/zeros_like constant-fold and lose the axis).
    zero = (o[:, 0] + d[:, 0]) * 0.0
    init = (zero + INF, zero.astype(jnp.int32) - 1)
    tiles = (v0, e1, e2, valid, jnp.arange(n_tiles, dtype=jnp.int32))
    (best_t, best_id), _ = jax.lax.scan(body, init, tiles)
    return best_t, best_id


# `auto` switches from the brute sweep to the block-shortlist intersector at
# this padded triangle count. Measured end to end on one H100 (700 W),
# 512x512, 4 spp, seeded mesh scenes: brute 0.120 / 0.183 / 0.801 s against
# shortlist 0.343 / 0.500 / 43.3 s at 1152 / 2560 / 12800 padded triangles.
# Brute wins at every measured size, so there is no crossover to route by:
# auto keeps brute until a faster large-mesh path exists (ROADMAP R3).
SHORTLIST_MIN_T = 1 << 31


# Profiler scopes of the triangle sweeps (utils.profiling attributes device
# time to them): the closest-hit sweep (not its attribute extraction) and
# the shadow-ray occlusion sweep.
CLOSEST_SCOPE = "closest_hit_sweep"
SHADOW_SCOPE = "shadow_sweep"


def resolve_intersector(settings, scene) -> str:
    """Concrete intersector for ``settings.intersector`` (resolving "auto").

    ``auto`` routes by what it observes, the backend and the padded
    triangle count: the XLA block-shortlist at or above SHORTLIST_MIN_T;
    on a GPU, scenes of at most TMAJOR_MAX_T triangles to the Triton
    ``sweep`` kernel; everything else to the XLA ``brute`` sweep (the
    [T, B] transposed sweep up to TMAJOR_MAX_T, tiled [B, T] above).
    """
    if settings.intersector != "auto":
        return settings.intersector
    if scene.padded_tris >= SHORTLIST_MIN_T:
        return "shortlist"
    # The Triton kernel (ops.sweep_triton) takes the CornellBox final frame
    # from 0.0943 to 0.0793 s end to end on one H100 (700 W); it needs a GPU.
    small = (scene.num_tris + 7) // 8 * 8 <= TMAJOR_MAX_T
    if small and jax.default_backend() == "gpu":
        return "sweep"
    return "brute"


def _closest_tri(method: str, scene, o, d):
    """Triangle closest hit by the named method -> (t [B], tri_id [B])."""
    if method == "brute":
        return closest_tri_brute(scene, o, d)
    if method == "shortlist":
        from pathtracer_tpu.ops.intersect_shortlist import closest_tri_shortlist

        return closest_tri_shortlist(scene, o, d)
    if method == "bvh":
        from pathtracer_tpu.ops.bvh_traverse import closest_tri_bvh

        return closest_tri_bvh(scene, o, d)
    if method == "sweep":
        import functools

        from pathtracer_tpu.ops.sweep_triton import closest_tri_sweep

        # The kernel lowers for CUDA; on any other platform the same kernel
        # runs in interpret mode. Chosen when lowering, so a computation
        # placed on the CPU in a GPU process works too.
        return jax.lax.platform_dependent(
            scene, o, d,
            cuda=closest_tri_sweep,
            default=functools.partial(closest_tri_sweep, interpret=True),
        )
    raise ValueError(f"unknown intersector {method!r}")


def _occluded_brute(scene, o, d, t_cut):
    """Brute occlusion sweep -> (occluded [B], hit_any [B])."""
    zero = (o[:, 0] + d[:, 0]) * 0.0
    if scene.num_tris == 0:
        return zero != 0.0, zero != 0.0
    if (scene.num_tris + 7) // 8 * 8 <= TMAJOR_MAX_T:
        t, ok = _moller_trumbore_tmajor(scene, o, d)
        return jnp.any(ok & (t < t_cut[None, :]), axis=0), jnp.any(ok, axis=0)
    tp = scene.padded_tris
    tile = _pick_tile(tp)
    n_tiles = tp // tile
    v0 = scene.tri_v0.reshape(n_tiles, tile, 3)
    e1 = scene.tri_e1.reshape(n_tiles, tile, 3)
    e2 = scene.tri_e2.reshape(n_tiles, tile, 3)
    valid = scene.tri_valid.reshape(n_tiles, tile)

    def body(carry, tile_data):
        occ, any_hit = carry
        tv0, te1, te2, tvalid = tile_data
        t, ok = _moller_trumbore(o, d, tv0, te1, te2, tvalid)
        occ = occ | jnp.any(ok & (t < t_cut[:, None]), axis=1)
        any_hit = any_hit | jnp.any(ok, axis=1)
        return (occ, any_hit), None

    init = (zero != 0.0, zero != 0.0)
    (occ, any_hit), _ = jax.lax.scan(body, init, (v0, e1, e2, valid))
    return occ, any_hit


def occluded_before(scene, o, d, t_max, settings, rel_eps: float = 1e-3):
    """Shadow visibility sweep -> (occluded [B] bool, hit_any [B] bool).

    ``occluded``: some surface lies strictly before ``t_max * (1 - rel_eps)``
    along the ray; ``hit_any``: the ray hits anything at all (the reference's
    ``directLightingOnly`` break keys on this, program-raymarch.wgsl:184-186).

    This is the t-only half of the closest-hit sweep: same Moller-Trumbore
    tiles, but no argmin bookkeeping and no winner-attribute extraction —
    the NEE caller already knows the sampled light point's own attributes
    (ops.lights.sample_area_lights_detailed).
    """
    t_cut = t_max * (1.0 - rel_eps)
    method = resolve_intersector(settings, scene)
    with jax.named_scope(SHADOW_SCOPE):
        if method == "brute":
            occ, any_hit = _occluded_brute(scene, o, d, t_cut)
        elif method == "shortlist" and not settings.direct_lighting_only:
            # Occlusion-only shortlist: best_t starts at the cutoff, so
            # clusters beyond the light sample are never swept. ``hit_any``
            # is consumed only on the directLightingOnly path (the
            # closest-hit branch below), so here it aliases ``occ`` rather
            # than paying for an unbounded sweep.
            from pathtracer_tpu.ops.intersect_shortlist import (
                occluded_tri_shortlist,
            )

            occ = any_hit = occluded_tri_shortlist(scene, o, d, t_cut)
        else:
            # The sweep kernel, BVH and shortlist+DLO reuse their
            # closest-hit core (still skipping the attribute extraction).
            t_tri, _ = _closest_tri(method, scene, o, d)
            occ = t_tri < t_cut
            any_hit = jnp.isfinite(t_tri)

    if scene.num_analytic > 0:
        t_a, _, _, _ = intersect_analytic(scene, o, d)
        occ = occ | (t_a < t_cut)
        any_hit = any_hit | jnp.isfinite(t_a)
    return occ, any_hit


# Full-f32 products wherever exactness is claimed (one-hot selection,
# analytic transforms): the default may run in TF32 on tensor cores.
_MATMUL_EXACT = jax.lax.Precision.HIGHEST


def intersect_analytic(scene, o, d):
    """Closest analytic sphere/cube hit -> (t [B], point, normal, mat [B]).

    Correct re-implementation of ``primitive.wgsl:18-142`` (the reference
    version reports phantom hits when both sphere roots are negative).
    Rays transform into object space by the primitive's inverse CTM; normals
    return by inverse-transpose. Object space: sphere radius 0.5, cube ±0.5.
    """
    zero3 = (o + d) * 0.0
    zero = zero3[:, 0]
    best = (zero + INF, zero3, zero3, zero.astype(jnp.int32))
    if scene.num_analytic == 0:
        return best

    eps = 1e-6

    def one_prim(best, idx):
        best_t, best_p, best_n, best_m = best
        inv = scene.prim_ctm_inv[idx]
        # HIGHEST: a default-precision f32 product may run in reduced
        # precision (TF32) on tensor-core hardware.
        oo = jnp.matmul(o, inv[:3, :3].T, precision=_MATMUL_EXACT) + inv[:3, 3]
        # Unnormalized: object t == world t.
        od = jnp.matmul(d, inv[:3, :3].T, precision=_MATMUL_EXACT)

        # Unit sphere (radius 0.5).
        a = jnp.sum(od * od, axis=-1)
        bq = 2.0 * jnp.sum(od * oo, axis=-1)
        c = jnp.sum(oo * oo, axis=-1) - 0.25
        discr = bq * bq - 4.0 * a * c
        sq = jnp.sqrt(jnp.maximum(discr, 0.0))
        t1 = (-bq - sq) / (2.0 * a)
        t2 = (-bq + sq) / (2.0 * a)
        t_sph = jnp.where(t1 > eps, t1, jnp.where(t2 > eps, t2, INF))
        t_sph = jnp.where(discr >= 0.0, t_sph, INF)
        p_sph = oo + jnp.where(jnp.isfinite(t_sph), t_sph, 0.0)[:, None] * od
        n_sph = p_sph  # gradient of x^2+y^2+z^2, normalized later

        # Unit cube (slabs, face normals).
        safe_od = jnp.where(jnp.abs(od) > 1e-12, od, 1e-12)
        t_lo = (-0.5 - oo) / safe_od
        t_hi = (0.5 - oo) / safe_od
        t_near = jnp.max(jnp.minimum(t_lo, t_hi), axis=-1)
        t_far = jnp.min(jnp.maximum(t_lo, t_hi), axis=-1)
        hit_cube = (t_far >= t_near) & (t_far > eps)
        t_cube = jnp.where(hit_cube, jnp.where(t_near > eps, t_near, t_far), INF)
        p_cube = oo + jnp.where(jnp.isfinite(t_cube), t_cube, 0.0)[:, None] * od
        # Face normal: axis of the largest |coordinate|.
        ax = jnp.argmax(jnp.abs(p_cube), axis=-1)
        n_cube = jnp.sign(
            jnp.take_along_axis(p_cube, ax[:, None], axis=-1)
        ) * jax.nn.one_hot(ax, 3, dtype=o.dtype)

        is_sphere = scene.prim_kind[idx] == 0
        t_obj = jnp.where(is_sphere, t_sph, t_cube)
        n_obj = jnp.where(is_sphere, n_sph, n_cube)

        # Back to world space (miss lanes: finite placeholder, see above).
        t_w = jnp.where(jnp.isfinite(t_obj), t_obj, 0.0)
        p_w = o + t_w[:, None] * d
        # (ctm^-1)^T applied -> row-vector form.
        n_w = jnp.matmul(n_obj, inv[:3, :3], precision=_MATMUL_EXACT)
        n_w = n_w / jnp.maximum(jnp.linalg.norm(n_w, axis=-1, keepdims=True), 1e-20)

        better = t_obj < best_t
        return (
            jnp.where(better, t_obj, best_t),
            jnp.where(better[:, None], p_w, best_p),
            jnp.where(better[:, None], n_w, best_n),
            jnp.where(better, scene.prim_mat[idx], best_m),
        ), None

    best, _ = jax.lax.scan(
        one_prim, best, jnp.arange(scene.num_analytic, dtype=jnp.int32)
    )
    return best


# Above this triangle count, per-winner one-hot matmul extraction is
# replaced by the two-stage extraction: the [B, T] one-hot would cost
# O(B*T*C) flops.
ONEHOT_MAX_T = 2048


def _onehot_dot(onehot_f32, table):
    """[B, K] one-hot x [K, C] table -> [B, C], exact in f32."""
    return jax.lax.dot_general(
        onehot_f32, table, (((1,), (0,)), ((), ())), precision=_MATMUL_EXACT
    )


def _tri_attr_table(scene, want_vn: bool, rows: int | None = None):
    """Per-triangle attribute table [T, C] for one-hot winner extraction.

    Channels: n(0:3) Kd(3:6) Ks(6:9) Ke(9:12) Ns(12) Ni(13) illum(14)
    mat_id(15); with ``want_vn``: v0(16:19) e1(19:22) e2(22:25) vn(25:34).
    The per-triangle material gathers here are [T]-sized (tiny — T <=
    ONEHOT_MAX_T on this path) and their VJP scatter-adds straight into the
    differentiable material arrays. ``rows`` truncates to the first rows
    (the transposed-sweep path uses the 8-rounded count, not the 128 pad).
    """
    r = slice(None) if rows is None else slice(0, rows)
    tm = scene.tri_mat[r]
    cols = [
        scene.tri_n[r],
        scene.mat_Kd[tm],
        scene.mat_Ks[tm],
        scene.mat_Ke[tm],
        scene.mat_Ns[tm][:, None],
        scene.mat_Ni[tm][:, None],
        scene.mat_illum[tm][:, None],
        tm.astype(jnp.float32)[:, None],
    ]
    if want_vn:
        cols += [
            scene.tri_v0[r],
            scene.tri_e1[r],
            scene.tri_e2[r],
            scene.tri_vn[r].reshape(-1, 9),
        ]
    return jnp.concatenate(cols, axis=1)


def _material_table(scene):
    """[M, 12] material table: Kd Ks Ke Ns Ni illum."""
    return jnp.concatenate(
        [
            scene.mat_Kd,
            scene.mat_Ks,
            scene.mat_Ke,
            scene.mat_Ns[:, None],
            scene.mat_Ni[:, None],
            scene.mat_illum[:, None],
        ],
        axis=1,
    )


def _unpack_mat(a, off: int = 0):
    return {
        "Kd": a[:, off : off + 3],
        "Ks": a[:, off + 3 : off + 6],
        "Ke": a[:, off + 6 : off + 9],
        "Ns": a[:, off + 9],
        "Ni": a[:, off + 10],
        "illum": a[:, off + 11],
    }


def material_lookup(scene, mat_id):
    """Material record dict for [B] ids via an exact one-hot [B, M] @
    [M, 12] matmul (M = #materials, always small)."""
    m = scene.mat_Ns.shape[0]
    oh = (mat_id[:, None] == jnp.arange(m, dtype=mat_id.dtype)).astype(
        jnp.float32
    )
    return _unpack_mat(_onehot_dot(oh, _material_table(scene)))


def _vn_shading_normal(o, d, v0, e1, e2, vn, n_geo):
    """Barycentric-interpolated shading normal from extracted per-winner
    triangle data. Dots are elementwise multiply-and-sum, so no reduced-
    precision matmul path can touch them."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > EPS_TRI, det, 1.0)
    s = o - v0
    u = jnp.sum(s * pvec, axis=-1) * inv_det
    qvec = jnp.cross(s, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    n = (
        (1.0 - u - v)[:, None] * vn[:, 0:3]
        + u[:, None] * vn[:, 3:6]
        + v[:, None] * vn[:, 6:9]
    )
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-20)
    return jnp.where(norm > 1e-12, n, n_geo)


# Within-cluster width of the two-stage winner extraction.
EXTRACT_SUB = 128


def _two_stage_extract(scene, tri_id, want_vn: bool):
    """Winner attributes for [B] tri ids when T is too large for a direct
    [B, T] one-hot -> [B, ch] (ch = 4, or 22 with vertex normals).

    Channels: n(0:3) mat_id(3); with ``want_vn``: v0(4:7) e1(7:10) e2(10:13)
    vn(13:22). Two chained exact selections stand in for per-winner
    gathers:

      1. cluster one-hot  [B, C] @ [C, ch*SUB]  (HIGHEST — exact row copy;
         C = T/SUB so the operand never approaches the [B, T] blowup)
      2. within-cluster one-hot multiply+reduce over the SUB axis (fused:
         ``sum(stage1[B, ch, SUB] * onehot[B, 1, SUB], axis=2)``).

    Miss lanes (tri_id = -1) select no cluster row and return zeros; the
    caller sanitizes them. Material channels beyond mat_id come from
    ``material_lookup`` (a [B, M] one-hot — M is always small).
    """
    tp = scene.padded_tris
    sub = EXTRACT_SUB
    c = tp // sub
    cols = [scene.tri_n, scene.tri_mat.astype(jnp.float32)[:, None]]
    if want_vn:
        cols += [
            scene.tri_v0,
            scene.tri_e1,
            scene.tri_e2,
            scene.tri_vn.reshape(tp, 9),
        ]
    table = jnp.concatenate(cols, axis=1)  # [tp, ch]
    ch = table.shape[1]
    # Component-major cluster rows: ch blocks of SUB contiguous columns.
    tbl = table.reshape(c, sub, ch).transpose(0, 2, 1).reshape(c, ch * sub)

    hi = tri_id // sub  # -1 -> -1: selects no row, stage1 = 0
    lo = tri_id - hi * sub
    oh_hi = (hi[:, None] == jnp.arange(c, dtype=tri_id.dtype)).astype(
        jnp.float32
    )
    s1 = _onehot_dot(oh_hi, tbl).reshape(-1, ch, sub)
    oh_lo = (lo[:, None] == jnp.arange(sub, dtype=tri_id.dtype)).astype(
        jnp.float32
    )
    return jnp.sum(s1 * oh_lo[:, None, :], axis=2)  # [B, ch]


def closest_hit(scene, o, d, settings):
    """Fused scene closest-hit -> (Hit, material dict).

    One call produces both the geometric hit record and the winning lane's
    full material: winner attributes come from an exact one-hot
    [B, T] @ [T, C] matmul for small scenes, or the two-stage extraction
    plus a [B, M] material-table matmul otherwise. Miss lanes are sanitized
    (unit-z normal, Ni = 1) so downstream masked BSDF math stays NaN-free
    under reverse-mode AD.
    """
    method = resolve_intersector(settings, scene)
    with jax.named_scope(CLOSEST_SCOPE):
        t_tri, tri_id = _closest_tri(method, scene, o, d)

    t_pad = scene.padded_tris
    # Miss lanes keep t = inf but must not produce inf/NaN coordinates:
    # 0 * inf = NaN would poison reverse-mode AD even through masked lanes.
    t_pt = jnp.where(jnp.isfinite(t_tri), t_tri, 0.0)
    point = o + t_pt[:, None] * d

    t8 = (scene.num_tris + 7) // 8 * 8
    if method in ("brute", "sweep") and t8 <= TMAJOR_MAX_T:
        # Transposed extraction to match the [T, B] sweep layout: the
        # winner one-hot is [T8, B] (T8 << the 128-padded t_pad — for the
        # 36-tri Cornell this is 40 vs 128 rows of [B] traffic, and the
        # one-hot is the extraction's dominant cost), contracted as
        # [ch, T8] @ [T8, B] and transposed back ([ch, B] is small).
        table = _tri_attr_table(scene, settings.use_vertex_normals, rows=t8)
        oh_t = (
            jnp.arange(t8, dtype=tri_id.dtype)[:, None] == tri_id[None, :]
        ).astype(jnp.float32)
        a = _onehot_dot(table.T, oh_t).T
    elif t_pad <= ONEHOT_MAX_T:
        table = _tri_attr_table(scene, settings.use_vertex_normals)
        oh = (
            tri_id[:, None] == jnp.arange(t_pad, dtype=tri_id.dtype)
        ).astype(jnp.float32)
        a = _onehot_dot(oh, table)
    else:
        a = None  # two-stage extraction below

    if a is not None:
        n_geo = a[:, 0:3]
        mat = _unpack_mat(a, off=3)
        mat_id = a[:, 15].astype(jnp.int32)
        if settings.use_vertex_normals:
            n_shade = _vn_shading_normal(
                o, d, a[:, 16:19], a[:, 19:22], a[:, 22:25], a[:, 25:34], n_geo
            )
        else:
            n_shade = n_geo
    else:
        a = _two_stage_extract(scene, tri_id, settings.use_vertex_normals)
        n_geo = a[:, 0:3]
        mat_id = a[:, 3].astype(jnp.int32)
        mat = material_lookup(scene, mat_id)
        if settings.use_vertex_normals:
            n_shade = _vn_shading_normal(
                o, d, a[:, 4:7], a[:, 7:10], a[:, 10:13], a[:, 13:22], n_geo
            )
        else:
            n_shade = n_geo

    if scene.num_analytic > 0:
        t_a, p_a, n_a, m_a = intersect_analytic(scene, o, d)
        use_a = t_a < t_tri
        t_tri = jnp.where(use_a, t_a, t_tri)
        point = jnp.where(use_a[:, None], p_a, point)
        n_geo = jnp.where(use_a[:, None], n_a, n_geo)
        n_shade = jnp.where(use_a[:, None], n_a, n_shade)
        mat_id = jnp.where(use_a, m_a, mat_id)
        tri_id = jnp.where(use_a, -1, tri_id)
        mat_a = material_lookup(scene, m_a)
        mat = {
            k: jnp.where(
                use_a[:, None] if mat[k].ndim == 2 else use_a, mat_a[k], mat[k]
            )
            for k in mat
        }

    hit = jnp.isfinite(t_tri)
    # Sanitize miss lanes (see docstring).
    unit_z = jnp.zeros_like(n_geo).at[:, 2].set(1.0)
    n_geo = jnp.where(hit[:, None], n_geo, unit_z)
    n_shade = jnp.where(hit[:, None], n_shade, unit_z)
    mat["Ni"] = jnp.where(hit, mat["Ni"], 1.0)

    return (
        Hit(
            hit=hit,
            t=t_tri,
            point=point,
            normal=n_geo,
            normal_shade=n_shade,
            mat_id=mat_id.astype(jnp.int32),
            tri_id=tri_id,
        ),
        mat,
    )


def intersect(scene, o, d, settings) -> Hit:
    """Scene closest-hit: triangles + analytic primitives, merged by t."""
    return closest_hit(scene, o, d, settings)[0]
