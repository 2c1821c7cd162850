"""Closest-hit sweep over a small triangle table as one Pallas Triton kernel.

The XLA ``brute`` sweep for small scenes (``ops.intersect``, at most
TMAJOR_MAX_T triangles) materializes nothing, but its [T8, B] fusions run
far below the card's float32 rate. Here one program takes a block of rays,
keeps their (best t, best id) in registers, and walks the triangle table
(at most 256 rows, a few KB, read through the cache) once. It serves both
sweeps of a bounce: the closest hit, and the shadow test, whose
``occluded`` is ``best_t < t_cut`` and whose ``hit_any`` is
``isfinite(best_t)``.

Same Moller-Trumbore math, epsilon and tie rule (first triangle wins) as
``intersect._moller_trumbore_tmajor``. The route is named (``triton``);
``interpret=True`` runs it on the CPU for tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

EPS_TRI = 1e-8  # ray-triangle-intersection.wgsl:5
BLOCK = 256  # rays per program


def _kernel(tri_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            t_ref, id_ref, *, n_tris: int):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]

    def body(i, carry):
        best_t, best_id = carry
        v0x, v0y, v0z = tri_ref[0, i], tri_ref[1, i], tri_ref[2, i]
        e1x, e1y, e1z = tri_ref[3, i], tri_ref[4, i], tri_ref[5, i]
        e2x, e2y, e2z = tri_ref[6, i], tri_ref[7, i], tri_ref[8, i]
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
        )
        better = ok & (t < best_t)
        return jnp.where(better, t, best_t), jnp.where(better, i, best_id)

    init = (jnp.full(ox.shape, jnp.inf, jnp.float32),
            jnp.full(ox.shape, -1, jnp.int32))
    best_t, best_id = jax.lax.fori_loop(0, n_tris, body, init)
    t_ref[...] = best_t
    id_ref[...] = best_id


@functools.partial(jax.jit, static_argnames=("n_tris", "interpret"))
def _sweep(table, o, d, n_tris: int, interpret: bool = False):
    b = o.shape[0]
    bp = -(-b // BLOCK) * BLOCK
    cols = [jnp.pad(o[:, k], (0, bp - b)) for k in range(3)]
    cols += [jnp.pad(d[:, k], (0, bp - b), constant_values=1.0)
             for k in range(3)]
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    # Under shard_map the outputs vary over the mesh axes the rays do.
    vma = jax.typeof(cols[0]).vma
    t, tid = pl.pallas_call(
        functools.partial(_kernel, n_tris=n_tris),
        out_shape=(jax.ShapeDtypeStruct((bp,), jnp.float32, vma=vma),
                   jax.ShapeDtypeStruct((bp,), jnp.int32, vma=vma)),
        grid=(bp // BLOCK,),
        in_specs=[pl.BlockSpec(table.shape, lambda i: (0, 0))] + [ray_spec] * 6,
        out_specs=(ray_spec, ray_spec),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="small_scene_sweep",
    )(table, *cols)
    return t[:b], tid[:b]


def sweep_table(scene):
    """[9, T8p] component rows (v0, e1, e2) of the first T8 triangles, T8p
    the next power of two. Invalid and padding triangles get zero edges,
    which the ``|det| > eps`` test rejects."""
    t8 = (scene.num_tris + 7) // 8 * 8
    valid = scene.tri_valid[:t8, None]
    table = jnp.concatenate(
        [scene.tri_v0[:t8],
         jnp.where(valid, scene.tri_e1[:t8], 0.0),
         jnp.where(valid, scene.tri_e2[:t8], 0.0)], axis=1,
    ).T
    t8p = max(8, pl.next_power_of_2(t8))
    return jnp.pad(table, ((0, 0), (0, t8p - t8))), t8


def closest_tri_sweep(scene, o, d, interpret: bool = False):
    """(t [B] — inf on miss, tri_id [B] — -1 on miss) for a small scene.

    The outputs carry no gradient (the kernel has no derivative rule):
    differentiable rendering fits materials, and the paths' geometry —
    which triangle each ray hits, and where — is held fixed, as in the
    traversal oracle (ops.bvh_traverse).
    """
    table, n = sweep_table(scene)
    sg = jax.lax.stop_gradient
    return _sweep(sg(table), sg(o), sg(d), n_tris=n, interpret=interpret)
