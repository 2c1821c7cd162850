"""Wavefront path-tracing integrator.

Re-design of the reference megakernel ``radiance``
(``src/program-raymarch.wgsl:104-303``). The reference runs one divergent
``while(depth <= 16)`` loop per pixel-thread; here a flat SoA batch of rays
advances through a bounded ``lax.scan`` over bounces with *masked lanes*:
dead rays keep their state and contribute nothing, every lane executes every
lobe, and ``jnp.where`` selects — no divergence anywhere.

Per bounce (mirroring the reference's order of operations exactly):
  1. closest-hit intersect            (intersection-logic.wgsl:1-215)
  2. emissive add at depth 0 / after specular, then terminate  (:136-141)
  3. NEE: sample area light, shadow intersect, add contribution (:146-187)
  4. ``directLightingOnly`` break when the shadow ray hit       (:184-186)
  5. Russian roulette                                            (:190-193)
  6. BSDF select + sample: dielectric / mirror / glossy / diffuse (:199-297)

The scan is wrapped in ``jax.checkpoint`` so reverse-mode AD re-plays each
bounce from its carry instead of storing every intermediate — this *is*
path-replay backpropagation: the RNG is counter-based (ops.rng) so the
replayed bounce regenerates the identical sample decisions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pathtracer_tpu.ops import rng
from pathtracer_tpu.ops.bsdf import (
    dielectric_directions,
    eval_beckmann,
    eval_phong,
    eval_phong_bounce,
    reflect,
    sample_cosine_hemisphere,
)
from pathtracer_tpu.ops.intersect import closest_hit, occluded_before
from pathtracer_tpu.ops.lights import (
    sample_area_lights,
    sample_area_lights_detailed,
)

PI = jnp.pi
NEE_OFFSET = 1.0e-4  # program-raymarch.wgsl:146
RAY_OFFSET = 1.0e-3  # ray_with_epsilon, data-structs.wgsl:58-60

# Dead lanes are re-aimed ("parked") at this far-outside origin pointing
# +x before intersection: a guaranteed miss with moderate finite values
# (no fake hits, no inf/NaN under reverse-mode AD). Masked lanes would be
# ignored anyway, but parking lets block-granular intersectors
# (ops.intersect_shortlist) skip dead lanes' stale rays instead of letting
# them pollute the block's cluster shortlist. Shipped scenes span ~|20|.
_PARK_POS = 1.0e6


def _park_rays(o, d, live):
    dead = ~live
    o = jnp.where(dead[:, None], _PARK_POS, o)
    d = jnp.where(
        dead[:, None], jnp.asarray([1.0, 0.0, 0.0], o.dtype)[None, :], d
    )
    return o, d


def _nee(scene, settings, hit, mat, d, beta, u, active):
    """Next-event estimation; returns (contribution [B, 3], shadow_hit [B]).

    Two shadow strategies (``RenderSettings.shadow_mode``):

    - ``fast`` (default): the light sample carries its own point/normal/Ke
      (ops.lights.sample_area_lights_detailed), so visibility is a t-only
      occlusion sweep — no argmin, no winner-attribute extraction.
    - ``closest``: full closest-hit on the shadow ray and the *hit*'s
      attributes drive the contribution — the reference's exact semantics
      (program-raymarch.wgsl:146-187), where a shadow ray reaching a
      *different* emissive than sampled still contributes. Oracle for the
      fast path (they differ only on overlapping-light geometries).

    Shading uses ``hit.normal_shade`` (barycentric-interpolated vertex
    normals when ``settings.use_vertex_normals``; equal to the geometric
    normal otherwise) — the feature the reference parsed out and abandoned
    (parse-obj.ts:41-55, intersection-logic.wgsl:81-108). The NEE origin
    offset stays on the *geometric* normal to avoid shadow acne from
    shading/geometric disagreement at silhouettes.
    """
    n = hit.normal_shade
    offset_pt = hit.point + hit.normal * NEE_OFFSET

    contrib = jnp.zeros_like(beta)
    shadow_any = jnp.zeros(beta.shape[0], dtype=bool)
    for s in range(settings.num_direct_lighting_samples):
        # Extra light samples draw from purpose slots past STRIDE (the
        # reference parses numDirectLightingSamples but always takes one;
        # honored here per SURVEY.md's deviation list).
        i_choice = rng.LIGHT_CHOICE if s == 0 else rng.STRIDE + 3 * (s - 1)
        i_bary = rng.LIGHT_BARY if s == 0 else i_choice + 1
        uc, u1, u2 = u[:, i_choice], u[:, i_bary], u[:, i_bary + 1]

        if settings.shadow_mode == "fast":
            ldir, weight, l_pt, l_n, s_mat_ke, t_target = (
                sample_area_lights_detailed(
                    scene, offset_pt, uc, u1, u2,
                    settings.compat_count_light_pdf,
                )
            )
            s_o, s_d = _park_rays(offset_pt, ldir, active)
            occluded, s_hit_any = occluded_before(
                scene, s_o, s_d, jnp.where(active, t_target, 0.0), settings
            )
            s_emissive = ~occluded & (jnp.sum(s_mat_ke, axis=-1) > 0.0)
            d2 = jnp.sum((hit.point - l_pt) ** 2, axis=-1)
            cos_l = jnp.sum(l_n * (-ldir), axis=-1)
        else:
            ldir, weight = sample_area_lights(
                scene, offset_pt, uc, u1, u2, settings.compat_count_light_pdf
            )
            s_o, s_d = _park_rays(offset_pt, ldir, active)
            shadow, s_mat = closest_hit(scene, s_o, s_d, settings)
            s_mat_ke = s_mat["Ke"]
            s_emissive = shadow.hit & (jnp.sum(s_mat_ke, axis=-1) > 0.0)
            s_hit_any = shadow.hit
            d2 = jnp.sum((hit.point - shadow.point) ** 2, axis=-1)
            cos_l = jnp.sum(shadow.normal * (-ldir), axis=-1)

        if settings.compat_count_light_pdf:
            # Reference quirk: Phong NEE brdf keyed on Ns == 40 exactly
            # (program-raymarch.wgsl:160).
            phong_lane = mat["Ns"] == 40.0
        else:
            phong_lane = jnp.sum(mat["Ks"], axis=-1) > 0.0
        if settings.glossy_brdf == "beckmann":
            brdf_gloss = eval_beckmann(
                mat["Ks"], mat["Ns"], d, ldir, n, settings.beckmann_alpha
            )
        else:
            brdf_gloss = eval_phong(
                mat["Ks"], mat["Ns"], d, ldir, n, mat["Kd"]
            )
        brdf_diff = mat["Kd"] / PI
        brdf = jnp.where(phong_lane[:, None], brdf_gloss, brdf_diff)

        cos_s = jnp.sum(n * ldir, axis=-1)
        term = (
            beta
            * s_mat_ke
            * brdf
            * (cos_l * cos_s / jnp.maximum(d2, 1e-20) * weight)[:, None]
        )
        contrib = contrib + jnp.where((active & s_emissive)[:, None], term, 0.0)
        shadow_any = shadow_any | s_hit_any
    scale = 1.0 / settings.num_direct_lighting_samples
    return contrib * scale, shadow_any


def bounce_core(scene, settings, o, d, beta, radiance, alive, spec,
                pixel_ids, sample_ids, depth):
    """One masked wavefront bounce over [B] lanes.

    ``depth`` may be a scalar (fixed-depth scan integrator) or a per-lane
    [B] array (regenerative wavefront, where each lane is at its own bounce
    depth). Returns the updated lane state plus the number of rays traced.
    """
    # Slots 0..6 are consumed below (BSDF_DIR + 2 = 7); extra NEE samples
    # index columns past STRIDE, so only then is the full stride needed.
    if settings.num_direct_lighting_samples == 1:
        n_uniforms = rng.BSDF_DIR + 2
    else:
        n_uniforms = rng.STRIDE + 3 * (settings.num_direct_lighting_samples - 1)
    u = _uniforms(settings, pixel_ids, sample_ids, depth, n_uniforms)

    # Live closest-hit rays this bounce (shadow rays counted below).
    n_rays = jnp.sum(alive.astype(jnp.float32))

    q_o, q_d = _park_rays(o, d, alive)
    hit, mat = closest_hit(scene, q_o, q_d, settings)
    # Shading normal: interpolated vertex normals when enabled (equal to the
    # geometric normal otherwise) — drives all BSDF eval/sampling below.
    n = hit.normal_shade

    active = alive & hit.hit
    emissive = jnp.sum(mat["Ke"], axis=-1) > 0.0

    # -- emissive termination (program-raymarch.wgsl:136-141)
    add_mask = active & emissive & (spec | (depth == 0))
    radiance = radiance + jnp.where(add_mask[:, None], beta * mat["Ke"], 0.0)
    alive = active & ~add_mask

    # -- NEE (program-raymarch.wgsl:146-187)
    n_rays = n_rays + jnp.sum(alive.astype(jnp.float32)) * (
        settings.num_direct_lighting_samples
    )
    contrib, shadow_hit = _nee(scene, settings, hit, mat, d, beta, u, alive)
    radiance = radiance + contrib
    if settings.direct_lighting_only:
        # INVARIANT: ``shadow_hit`` ("the shadow ray hit *anything*") is only
        # trustworthy here because occluded_before's shortlist fast path —
        # which aliases hit_any to occluded-before-cutoff — is gated to
        # ``not direct_lighting_only`` (ops/intersect.py, method ==
        # "shortlist" branch). Any new consumer of hit_any outside this DLO
        # block must widen that gate or compute hit_any for real.
        alive = alive & ~shadow_hit

    # -- Russian roulette (program-raymarch.wgsl:190-193)
    alive = alive & (u[:, rng.RR] <= settings.rr_prob)
    inv_rr = 1.0 / settings.rr_prob

    # -- BSDF select (program-raymarch.wgsl:199-297)
    is_dielectric = mat["illum"] == 7.0
    r_theta, refr_dir, tir = dielectric_directions(
        d, n, mat["Ni"], settings.compat_fixed_eta
    )
    chose_reflect = u[:, rng.FRESNEL] < r_theta
    if not settings.compat_fixed_eta:
        # Corrected mode: total internal reflection reflects instead of
        # following the reference's clamped pseudo-refraction.
        chose_reflect = chose_reflect | tir
    refract_lane = is_dielectric & ~chose_reflect
    mirror_lane = (mat["Ns"] > 500.0) | (is_dielectric & chose_reflect)
    specular_lane = refract_lane | mirror_lane

    samp_dir, pdf = sample_cosine_hemisphere(
        n, u[:, rng.BSDF_DIR], u[:, rng.BSDF_DIR + 1]
    )
    glossy_lane = (jnp.sum(mat["Ks"], axis=-1) > 0.0) & ~specular_lane
    if settings.glossy_brdf == "beckmann":
        brdf_gloss = eval_beckmann(
            mat["Ks"], mat["Ns"], d, samp_dir, n, settings.beckmann_alpha
        )
        q = jnp.sum(reflect(d, n) * samp_dir, axis=-1)
    else:
        brdf_gloss, q = eval_phong_bounce(mat["Ks"], mat["Ns"], d, samp_dir, n)
    brdf_diff = mat["Kd"] / PI
    brdf = jnp.where(glossy_lane[:, None], brdf_gloss, brdf_diff)

    new_d = jnp.where(
        specular_lane[:, None],
        jnp.where(refract_lane[:, None], refr_dir, reflect(d, n)),
        samp_dir,
    )
    new_o = hit.point + RAY_OFFSET * new_d

    cos_t = jnp.sum(samp_dir * n, axis=-1)
    diffuse_scale = brdf * (cos_t / jnp.maximum(pdf, 1e-20) * inv_rr)[:, None]
    new_beta = beta * jnp.where(
        specular_lane[:, None], inv_rr, diffuse_scale
    )

    bounce_spec = specular_lane | (glossy_lane & (depth == 0) & (q >= 0.0))
    if settings.compat_sticky_specular:
        # Reference quirk: hit_specular is never reset within a path.
        new_spec = spec | (alive & bounce_spec)
    else:
        new_spec = alive & specular_lane

    live = alive[:, None]
    o = jnp.where(live, new_o, o)
    d = jnp.where(live, new_d, d)
    beta = jnp.where(live, new_beta, beta)
    spec = jnp.where(alive, new_spec, spec)
    return o, d, beta, radiance, alive, spec, n_rays


def make_bounce_step(scene, settings):
    """Scan-compatible wrapper around ``bounce_core`` (fixed-depth scan)."""

    def step(carry, depth):
        o, d, beta, radiance, alive, spec, pixel_ids, sample_ids, n_rays = carry
        o, d, beta, radiance, alive, spec, dn = bounce_core(
            scene, settings, o, d, beta, radiance, alive, spec,
            pixel_ids, sample_ids, depth,
        )
        return (
            o, d, beta, radiance, alive, spec, pixel_ids, sample_ids,
            n_rays + dn,
        ), None

    return step


def _uniforms(settings, pixel_ids, sample_ids, depth, n):
    """[B, n] per-bounce uniforms via the configured generator (ops.rng).

    ``depth`` may be a scalar or a per-lane [B] array.
    """
    if settings.rng == "threefry":
        keys = rng.ray_keys(
            jax.random.PRNGKey(settings.seed), pixel_ids, sample_ids
        )
        depth_arr = jnp.broadcast_to(
            jnp.asarray(depth, dtype=jnp.uint32), pixel_ids.shape
        )
        folded = jax.vmap(jax.random.fold_in)(keys, depth_arr)
        return jax.vmap(lambda k: jax.random.uniform(k, (n,)))(folded)
    return rng.bounce_uniforms_hash(
        pixel_ids, sample_ids, depth, n, seed=settings.seed
    )


def radiance_batch_stats(scene, settings, o, d, pixel_ids, sample_ids):
    """Radiance [B, 3] plus the number of rays actually traced (scalar).

    The ray count is live closest-hit rays + live shadow rays summed over
    bounces — the real work metric behind the rays/s benchmark
    (SURVEY.md §5: rays/sec/chip as a first-class counter).
    """
    # Inits must be *data-dependent* on the ray arrays so they inherit any
    # shard_map varying-axis annotation (scan carry in/out types must match;
    # ones_like/zeros_like constant-fold and lose the axis).
    zero3 = (o + d) * 0.0
    zero = zero3[:, 0]
    beta = zero3 + 1.0
    radiance = zero3
    alive = zero == 0.0
    spec = zero != 0.0
    n_rays = jnp.sum(zero)

    step = jax.checkpoint(make_bounce_step(scene, settings))
    carry = (o, d, beta, radiance, alive, spec, pixel_ids, sample_ids, n_rays)
    carry, _ = jax.lax.scan(
        step, carry, jnp.arange(settings.max_depth, dtype=jnp.int32)
    )
    return carry[3], carry[8]


def radiance_batch(scene, settings, o, d, pixel_ids, sample_ids):
    """Estimate radiance for a ray batch -> [B, 3].

    ``pixel_ids``/``sample_ids``: [B] u32 counters identifying each ray; all
    randomness derives from them (ops.rng), so results are placement- and
    chunking-independent. The bounce step is rematerialized
    (``jax.checkpoint``) so the backward pass replays paths instead of
    storing per-bounce intermediates (path-replay backprop).
    """
    return radiance_batch_stats(scene, settings, o, d, pixel_ids, sample_ids)[0]
