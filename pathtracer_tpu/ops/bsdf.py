"""BSDF evaluation and sampling (masked, branch-free).

Re-design of the reference's per-thread BSDF branches
(``src/program-raymarch.wgsl:199-295``) and samplers
(``src/wgsl-util/samplers.wgsl``). Every lobe is evaluated for every lane and
combined with ``jnp.where`` masks — the idiomatic mapping of the reference's
divergent ``if illum==7 / Ns>500 / Ks>0`` chain onto dense arrays.

Lobe semantics (matching the reference exactly in compat mode):
- dielectric (illum == 7): Schlick-Fresnel reflect-or-refract, eta from Ni
  (hardcoded 2.5 in compat, program-raymarch.wgsl:206);
- mirror (Ns > 500): perfect reflection;
- glossy (any Ks > 0): cosine-sampled direction scored by a Phong lobe
  (Ns exponent), zero below the reflection horizon;
- diffuse: Lambertian Kd / pi, cosine-weighted sampling.
"""

from __future__ import annotations

import jax.numpy as jnp

PI = jnp.pi


def reflect(d, n):
    """Mirror reflection of direction d about normal n (w - 2(w.n)n)."""
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def tangent_frame(n):
    """Branchless orthonormal frame from normals [B, 3] (Duff et al.),
    identical to the reference's construction (samplers.wgsl:29-39)."""
    s = jnp.where(n[:, 2] < 0.0, -1.0, 1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = jnp.stack(
        [1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], axis=-1
    )
    bt = jnp.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], axis=-1)
    return t, bt


def sample_cosine_hemisphere(n, u1, u2):
    """Cosine-weighted hemisphere sample about normals [B, 3].

    theta = acos(sqrt(xi2)), phi = 2 pi xi1; pdf = cos(theta) / pi
    (samplers.wgsl:15-46). Returns (direction [B, 3], pdf [B]).
    """
    phi = 2.0 * PI * u1
    cos_t = jnp.sqrt(u2)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - u2, 0.0))
    local = jnp.stack(
        [jnp.cos(phi) * sin_t, jnp.sin(phi) * sin_t, cos_t], axis=-1
    )
    t, bt = tangent_frame(n)
    d = local[:, 0:1] * t + local[:, 1:2] * bt + local[:, 2:3] * n
    pdf = cos_t / PI
    return d, pdf


def eval_phong(ks, ns, w_in, w_out, n, kd):
    """Reference Phong lobe used for NEE (program-raymarch.wgsl:156-182):
    q = reflect(w_in).w_out; q < 0 -> -q * Kd / pi; else Ks (n+2)/(2 pi) q^n.

    w_in is the incoming ray direction (pointing into the surface).
    """
    refl = reflect(w_in, n)
    q = jnp.sum(refl * w_out, axis=-1)
    spec = ks * ((ns + 2.0) / (2.0 * PI) * jnp.power(jnp.maximum(q, 1e-20), ns))[
        :, None
    ]
    diff = (-q)[:, None] * kd / PI
    return jnp.where((q < 0.0)[:, None], diff, spec)


def eval_phong_bounce(ks, ns, w_in, w_out, n):
    """Phong lobe as used for the sampled bounce (program-raymarch.wgsl:262-278):
    zero below the horizon (q < 0) instead of the diffuse fallback."""
    refl = reflect(w_in, n)
    q = jnp.sum(refl * w_out, axis=-1)
    spec = ks * ((ns + 2.0) / (2.0 * PI) * jnp.power(jnp.maximum(q, 1e-20), ns))[
        :, None
    ]
    return jnp.where((q < 0.0)[:, None], 0.0, spec), q


def eval_beckmann(ks, ns, w_in, w_out, n, alpha_override: float = 0.0):
    """Beckmann microfacet BRDF for glossy lanes (opt-in).

    The reference carries a *disabled* Beckmann branch
    (program-raymarch.wgsl:281-290, ``enable_beckmann=false``) whose dead
    code builds the half-vector from the surface normal instead of the
    outgoing direction and skips the Fresnel/geometry terms. This is the
    corrected version: h = normalize(-w_in + w_out), Beckmann NDF D(h),
    Smith G1*G1 shadowing, f = Ks * D * G / (4 cos_i cos_o). Roughness
    comes from the Phong exponent (alpha = sqrt(2 / (Ns + 2))) unless
    ``alpha_override`` > 0.

    w_in points into the surface; returns [B, 3] (zero below the horizon).
    """
    s = -w_in
    cos_i = jnp.sum(s * n, axis=-1)
    cos_o = jnp.sum(w_out * n, axis=-1)
    h = s + w_out
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), 1e-20)
    cos_h = jnp.clip(jnp.sum(h * n, axis=-1), 1e-6, 1.0)

    if alpha_override > 0.0:
        alpha = jnp.full_like(cos_h, alpha_override)
    else:
        alpha = jnp.sqrt(2.0 / (ns + 2.0))
    a2 = alpha * alpha

    cos2 = cos_h * cos_h
    tan2 = (1.0 - cos2) / cos2
    d_ndf = jnp.exp(-tan2 / a2) / (PI * a2 * cos2 * cos2)

    def g1(cos_v):
        cv = jnp.clip(jnp.abs(cos_v), 1e-6, 1.0)
        a = cv / (alpha * jnp.sqrt(jnp.maximum(1.0 - cv * cv, 1e-12)))
        # Walter et al. rational approximation of the Beckmann G1.
        g = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
        return jnp.where(a < 1.6, g, 1.0)

    g = g1(cos_i) * g1(cos_o)
    denom = jnp.maximum(4.0 * jnp.abs(cos_i) * jnp.abs(cos_o), 1e-6)
    f = (d_ndf * g / denom)[:, None] * ks
    above = (cos_i > 0.0) & (cos_o > 0.0)
    return jnp.where(above[:, None], f, 0.0)


def fresnel_schlick(cos_i, eta_i, eta_t):
    """Schlick's approximation (program-raymarch.wgsl:209-211)."""
    r0 = ((eta_i - eta_t) / (eta_i + eta_t)) ** 2
    return r0 + (1.0 - r0) * jnp.power(1.0 - cos_i, 5.0)


def dielectric_directions(d, n, eta_mat, compat_fixed_eta: bool):
    """Refraction bookkeeping for illum==7 lanes (program-raymarch.wgsl:201-238).

    Returns (r_theta [B], refract_dir [B, 3], tir [B]) where r_theta is the
    Schlick reflection probability and tir marks total-internal-reflection
    lanes (k < 0). d: incoming direction, n: geometric normal, eta_mat:
    material Ni gathered per lane.
    """
    eta = jnp.where(compat_fixed_eta, 2.5, eta_mat)
    cos_raw = jnp.clip(jnp.sum(d * n, axis=-1), -1.0, 1.0)
    entering = cos_raw < 0.0
    cos_i = jnp.abs(cos_raw)
    eta_i = jnp.where(entering, 1.0, eta)
    eta_t = jnp.where(entering, eta, 1.0)
    # Refraction normal points against the ray (flipped when exiting).
    n_ref = jnp.where(entering[:, None], n, -n)

    r_theta = fresnel_schlick(cos_i, eta_i, eta_t)
    ratio = eta_i / eta_t
    k = 1.0 - ratio * ratio * (1.0 - cos_i * cos_i)
    # The reference clamps k into [0, 1] instead of treating k<0 as total
    # internal reflection (program-raymarch.wgsl:230, acknowledged TODO),
    # which yields a direction of magnitude ~ratio. We keep the clamped
    # *direction* for parity but renormalize it — the reference's non-unit
    # d silently corrupts later dot products (and explodes Phong powers).
    refr = (
        ratio[:, None] * d
        + (ratio * cos_i - jnp.sqrt(jnp.clip(k, 0.0, 1.0)))[:, None] * n_ref
    )
    refr = refr / jnp.maximum(jnp.linalg.norm(refr, axis=-1, keepdims=True), 1e-20)
    tir = k < 0.0
    return r_theta, refr, tir
