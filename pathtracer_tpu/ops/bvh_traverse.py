"""BVH-guided closest-hit traversal (vectorized masked stacks).

Re-design of the reference's per-thread stack walk
(``src/wgsl-util/intersection-logic.wgsl:1-215``). The reference keeps a
64-slot stack per GPU thread with divergent control flow; here every lane of
a flat [B] ray batch carries its own small stack *as data* ([B, S] arrays,
S = tree depth + 2), and one ``lax.while_loop`` iteration pops one node for
every still-traversing lane simultaneously:

- both child AABBs load from the parent record (the layout the reference
  proves out, kept index-based/SoA by ``models.bvh``);
- slab tests use the reference's entry-or-exit distance semantics plus its
  distance cull ``child_dist > closest_t`` (intersection-logic.wgsl:178-181);
- leaf children test their <= max_leaf_size contiguous triangles in a
  *static unrolled* loop (leaf ranges index the BVH-reordered triangle SoA,
  so the gathers are short and dense);
- internal children push by writing ``stack[lane, sp]`` via a lane-local
  one-hot select (no scatters).

The loop runs until every lane's stack empties (worst lane bounds the
iteration count). Outputs carry ``stop_gradient``: traversal is
control-flow-dependent and ``while_loop`` is not reverse-differentiable —
material gradients never flow through hit *geometry* anyway, so the
differentiable render path is unaffected (geometry gradients are out of
scope for path-replay; SURVEY.md §7).

Cost model: O(visited nodes) gathers instead of O(T) triangle tests — wins
when T >> typical visit count (MedievalBoat: 12.5k tris vs ~40-80 visits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pathtracer_tpu.ops.intersect import EPS_TRI, INF


def _slab(o, inv_d, lo, hi):
    """Ray-AABB slab test -> (hit [B], entry distance [B], 0 if inside).

    Cf. the reference's ray-bbox-intersection.wgsl, with two corrections
    noted inline.
    """
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    # Inclusive comparison: the reference's strict `tmax > max(tmin, 0)`
    # misses zero-thickness AABBs (leaves of coplanar axis-aligned quads) —
    # the root of its documented "triangles sometimes missing" bug
    # (submission-final.md:96). A small epsilon also guards fp cancellation.
    hit = tmax >= jnp.maximum(tmin, 0.0) - 1e-6
    # Cull distance = *entry* distance (0 when the origin is inside). The
    # reference culls on the exit distance for inside-origin boxes
    # (ray-bbox-intersection.wgsl returns tmax there), wrongly skipping
    # boxes that still contain closer geometry.
    return hit, jnp.maximum(tmin, 0.0)


def _mt_single(o, d, v0, e1, e2):
    """Moller-Trumbore for one gathered triangle per lane -> (t [B], ok [B])."""
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > EPS_TRI, det, 1.0)
    s = o - v0
    u = jnp.sum(s * pvec, axis=-1) * inv_det
    qvec = jnp.cross(s, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    ok = (
        (jnp.abs(det) > EPS_TRI)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS_TRI)
    )
    return jnp.where(ok, t, INF), ok


def closest_tri_bvh(scene, o, d):
    """Closest triangle hit -> (t [B] — inf on miss, tri_id [B] — -1 on miss)."""
    b = o.shape[0]
    s_cap = scene.bvh_depth + 2
    max_leaf = scene.max_leaf_size

    inv_d = 1.0 / jnp.where(jnp.abs(d) > 1e-12, d, 1e-12)

    zero = (o[:, 0] + d[:, 0]) * 0.0  # varying-axis-aware zeros
    izero = zero.astype(jnp.int32)
    state = dict(
        stack=jnp.zeros((b, s_cap), jnp.int32) + izero[:, None],  # root = 0
        sp=izero + 1,
        best_t=zero + INF,
        best_id=izero - 1,
    )

    lane_slot = jnp.arange(s_cap, dtype=jnp.int32)[None, :]

    def cond(st):
        return jnp.any(st["sp"] > 0)

    def body(st):
        active = st["sp"] > 0
        sp = jnp.maximum(st["sp"] - 1, 0)
        node = jnp.take_along_axis(st["stack"], sp[:, None], axis=1)[:, 0]
        best_t, best_id = st["best_t"], st["best_id"]

        new_stack, new_sp = st["stack"], sp
        for slot in range(2):
            lo = scene.bvh_lo[node, slot]  # [B, 3] gather
            hi = scene.bvh_hi[node, slot]
            box_hit, entry = _slab(o, inv_d, lo, hi)
            # Distance cull (cf. intersection-logic.wgsl:178-181, corrected
            # to the entry distance — see _slab).
            hit_box = active & box_hit & (entry <= best_t)

            child = scene.bvh_child[node, slot]
            start = scene.bvh_leaf_start[node, slot]
            count = scene.bvh_leaf_count[node, slot]
            is_leaf = child < 0

            # Leaf: static unrolled triangle tests over the contiguous range.
            leaf_act = hit_box & is_leaf
            for k in range(max_leaf):
                tri = start + k
                tri_ok = leaf_act & (k < count)
                safe = jnp.where(tri_ok, tri, 0)
                t, ok = _mt_single(
                    o,
                    d,
                    scene.tri_v0[safe],
                    scene.tri_e1[safe],
                    scene.tri_e2[safe],
                )
                better = tri_ok & ok & (t < best_t)
                best_t = jnp.where(better, t, best_t)
                best_id = jnp.where(better, safe, best_id)

            # Internal: push the child node.
            push = hit_box & ~is_leaf
            write = (lane_slot == new_sp[:, None]) & push[:, None]
            new_stack = jnp.where(write, child[:, None], new_stack)
            new_sp = new_sp + push.astype(jnp.int32)

        return dict(stack=new_stack, sp=new_sp, best_t=best_t, best_id=best_id)

    state = jax.lax.while_loop(cond, body, state)
    t = jax.lax.stop_gradient(state["best_t"])
    tri_id = jax.lax.stop_gradient(state["best_id"])
    return jnp.where(jnp.isfinite(t), t, jnp.inf), tri_id
