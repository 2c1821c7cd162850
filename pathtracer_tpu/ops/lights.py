"""Emissive-area-light sampling for next-event estimation.

Equivalent of ``sample_area_lights``
(``src/wgsl-util/intersection-logic.wgsl:217-285``). The reference reads up
to four (start, end) emissive index ranges from its packed-buffer header and
picks a triangle uniformly *by count*; here the emissive table is a flat
index list of any length (``models.pack``), and two estimators are provided:

- ``count`` (compat): weight = 1 / num_emissive_triangles, no area term —
  reproduces the reference estimator and hence its golden images;
- ``area``: proper area-weighted triangle selection via the emissive-area
  CDF, weight = total_area (solid-angle conversion stays at the call site's
  cos.cos/d^2 factors, turning the estimator into the standard area-form NEE).
"""

from __future__ import annotations

import jax.numpy as jnp


def sample_triangle_barycentric(u1, u2):
    """Uniform barycentrics via (1 - sqrt(u), v sqrt(u)) (samplers.wgsl:70-79)."""
    su = jnp.sqrt(u1)
    b0 = 1.0 - su
    b1 = u2 * su
    return b0, b1


def sample_area_lights(scene, x, u_choice, u1, u2, compat_count_pdf: bool):
    """Sample a point on the emissive set for each shading point x [B, 3].

    Returns (direction [B, 3], weight [B]) where the NEE contribution is
    ``beta * Ke_hit * brdf * cos_l * cos_s / d^2 * weight`` — matching the
    reference call site (program-raymarch.wgsl:146-182).
    """
    # count mode: uniform by count (intersection-logic.wgsl:238-257);
    # area mode: invert the emissive-area CDF, weight = total area.
    j, weight = _choose_emissive(scene, x, u_choice, compat_count_pdf)

    tri = scene.emissive_tri[j]
    v0 = scene.tri_v0[tri]
    p1 = v0 + scene.tri_e1[tri]
    p2 = v0 + scene.tri_e2[tri]

    b0, b1 = sample_triangle_barycentric(u1, u2)
    # Reference maps (b0, b1) onto (p0, p1) with remainder on p2
    # (samplers.wgsl:76-78).
    p = b0[:, None] * v0 + b1[:, None] * p1 + (1.0 - b0 - b1)[:, None] * p2

    direction = p - x
    direction = direction / jnp.maximum(
        jnp.linalg.norm(direction, axis=-1, keepdims=True), 1e-20
    )
    return direction, weight


def _choose_emissive(scene, x, u_choice, compat_count_pdf: bool):
    """Pick an emissive-table index per lane -> (j [B] i32, weight [B])."""
    e_pad = scene.emissive_tri.shape[0]
    n_emissive = jnp.maximum(scene.num_emissive, 1)
    if compat_count_pdf:
        j = jnp.minimum(
            (u_choice * n_emissive).astype(jnp.int32), n_emissive - 1
        )
        weight = jnp.full(x.shape[0], 1.0, dtype=x.dtype) / n_emissive.astype(
            x.dtype
        )
    else:
        idx_valid = jnp.arange(e_pad) < scene.num_emissive
        areas = jnp.where(idx_valid, scene.emissive_area, 0.0)
        total = jnp.maximum(jnp.sum(areas), 1e-20)
        cdf = jnp.cumsum(areas) / total
        j = jnp.searchsorted(cdf, u_choice, side="right").astype(jnp.int32)
        j = jnp.minimum(j, n_emissive - 1)
        weight = jnp.full(x.shape[0], 1.0, dtype=x.dtype) * total
    return j, weight


def sample_area_lights_detailed(scene, x, u_choice, u1, u2,
                                compat_count_pdf: bool):
    """Light sample carrying the sampled point's own attributes.

    Returns (direction [B, 3], weight [B], point [B, 3], normal [B, 3],
    Ke [B, 3], t_target [B]). The fast-shadow NEE path (ops.integrator)
    uses these *analytically known* light attributes instead of re-deriving
    them from a full closest-hit on the shadow ray — the occlusion test then
    only needs a t-only sweep (no argmin, no attribute extraction).

    Per-lane attributes come from one exact one-hot [B, E] @ [E, 15]
    matmul over the (tiny, padded) emissive table; whether a plain gather
    is faster is ROADMAP S4.
    """
    from pathtracer_tpu.ops.intersect import _onehot_dot

    j, weight = _choose_emissive(scene, x, u_choice, compat_count_pdf)

    # [E, 15] table: v0, p1, p2, n_geo, Ke per emissive triangle. The [E]
    # gathers building it are tiny (E = padded emissive count); their VJPs
    # scatter straight into the differentiable material arrays.
    et = scene.emissive_tri
    v0_t = scene.tri_v0[et]
    table = jnp.concatenate(
        [
            v0_t,
            v0_t + scene.tri_e1[et],
            v0_t + scene.tri_e2[et],
            scene.tri_n[et],
            scene.mat_Ke[scene.tri_mat[et]],
        ],
        axis=1,
    )
    e_pad = et.shape[0]
    oh = (j[:, None] == jnp.arange(e_pad, dtype=j.dtype)).astype(jnp.float32)
    a = _onehot_dot(oh, table)
    v0, p1, p2, n_l, ke = a[:, 0:3], a[:, 3:6], a[:, 6:9], a[:, 9:12], a[:, 12:15]

    b0, b1 = sample_triangle_barycentric(u1, u2)
    p = b0[:, None] * v0 + b1[:, None] * p1 + (1.0 - b0 - b1)[:, None] * p2

    to_p = p - x
    t_target = jnp.linalg.norm(to_p, axis=-1)
    direction = to_p / jnp.maximum(t_target, 1e-20)[:, None]
    return direction, weight, p, n_l, ke, t_target
