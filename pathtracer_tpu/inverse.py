"""Inverse rendering: differentiable loss + sharded training step.

The reference has no differentiability anywhere; this implements the
BASELINE.json north star: pixel gradients w.r.t. material arrays
(albedo Kd / emission Ke / specular Ks) via **path-replay backprop** — the
integrator's bounce step is `jax.checkpoint`-ed (ops.integrator) so the
backward pass replays each bounce from its carry, regenerating the identical
RNG decisions from counter-based keys instead of storing them.

Discrete path structure (hit ids, RR survival, lobe choices, sampled
directions) receives no gradient — standard for path-replay estimators;
gradients flow through the BSDF/emission *values* along the fixed paths.

Scaling: the pixel batch shards over the ``rays`` mesh axis, parameters
replicate, and per-shard gradients are ``psum``-reduced — the
gradient all-reduce happens inside the same jitted step as the backward
replay, so XLA overlaps the two.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pathtracer_tpu.ops import rng
from pathtracer_tpu.ops.camera_rays import generate_rays
from pathtracer_tpu.ops.integrator import radiance_batch
from pathtracer_tpu.parallel.mesh import RAY_AXIS

# Differentiable material arrays. ``mat_Ns`` (Phong roughness exponent) is
# optimizable too — fit it with ``compat_count_light_pdf=False`` (or the
# Beckmann lobe), since the compat NEE keys the glossy lobe on Ns == 40.0
# *exactly* (program-raymarch.wgsl:160), which makes the loss discontinuous
# in Ns; the corrected estimator keys on Ks > 0 and is smooth in Ns.
PARAM_FIELDS = ("mat_Kd", "mat_Ke", "mat_Ks", "mat_Ns")


def material_params(scene, fields=PARAM_FIELDS) -> dict:
    """Extract the differentiable material arrays from a Scene.

    ``fields`` restricts which arrays are optimized (e.g. ``("mat_Kd",)``
    to fit albedo with known emission); unlisted fields stay frozen at the
    scene's values.
    """
    return {f: getattr(scene, f) for f in fields}


def with_material_params(scene, params: dict):
    """Scene with its material arrays replaced by ``params``."""
    return scene.replace(**params)


def _render_rows(params, scene, settings, frame, pixel_ids, sample_ids):
    """Radiance for a pixel subset [b] under the given material params."""
    scene = with_material_params(scene, params)
    jitter = rng.pixel_jitter(settings, pixel_ids, sample_ids)
    o, d = generate_rays(frame, settings.width, settings.height, pixel_ids, jitter)
    return jnp.maximum(
        radiance_batch(scene, settings, o, d, pixel_ids, sample_ids), 0.0
    )


def pixel_loss(params, scene, settings, frame, target_rows, pixel_ids, sample_ids):
    """MSE between rendered radiance and target rows for a pixel subset."""
    rad = _render_rows(params, scene, settings, frame, pixel_ids, sample_ids)
    return jnp.mean((rad - target_rows) ** 2)


def _paired_objective(
    params, scene, settings, frame, target_rows, pixel_ids, ids_a, ids_b
):
    """Surrogate whose gradient is an *unbiased* estimate of d MSE(E[X], t).

    A naive MSE on a Monte Carlo render is biased: E[(X - t)^2] =
    (E[X] - t)^2 + Var(X), so gradient descent trades brightness for lower
    path variance (renders drift dark). The standard fix is two independent
    sample waves with cross stop-gradients:

        d/dθ mean[ sg(X_a - t)·X_b + sg(X_b - t)·X_a ]
          = E[(X_a - t)]·dE[X_b] + E[(X_b - t)]·dE[X_a]
          = 2 (E[X] - t)·dE[X]  =  d/dθ (E[X] - t)^2,

    because X_a ⟂ X_b. With ids_a == ids_b this reduces exactly to the
    plain per-wave MSE gradient. Returns (surrogate, monitoring MSE of the
    2-wave mean estimate).
    """
    rad_a = _render_rows(params, scene, settings, frame, pixel_ids, ids_a)
    rad_b = _render_rows(params, scene, settings, frame, pixel_ids, ids_b)
    resid_a = jax.lax.stop_gradient(rad_a) - target_rows
    resid_b = jax.lax.stop_gradient(rad_b) - target_rows
    surrogate = jnp.mean(resid_a * rad_b + resid_b * rad_a)
    monitor = jnp.mean((0.5 * (rad_a + rad_b) - target_rows) ** 2)
    return surrogate, monitor


def _paired_objective_tonemapped(
    params, scene, settings, frame, target_rows, pixel_ids, ids_a, ids_b
):
    """Paired surrogate for a loss in *display* space: MSE(f(E[X]), t)
    with f = the reference tonemap (ops.tonemap.tonemap_reference).

    Fitting against a real PNG (the reference's ground-truth images are
    8-bit display-space files, submission-final.md:20-27) means the loss
    sits behind the tonemap. Chain rule: dL/dθ = w · dE[X]/dθ with
    w = 2 (f(m) - t) f'(m) evaluated at m = E[X]. The weight is estimated
    from one wave (stop-gradient) and the unbiased dE[X] factor from the
    *other*, symmetrized — the same decoupling as ``_paired_objective``.

    Residual bias, documented: the weight uses f at a one-wave estimate of
    m, so f's curvature leaks a Jensen-gap term of order Var(X)·f''. The
    reference tonemap is nearly linear (a ``lum_o**0.01`` scale), so this
    is second-order small; it vanishes as spp grows.
    """
    from pathtracer_tpu.ops.tonemap import tonemap_reference

    def display_loss(rows):
        return jnp.mean((tonemap_reference(rows) - target_rows) ** 2)

    rad_a = _render_rows(params, scene, settings, frame, pixel_ids, ids_a)
    rad_b = _render_rows(params, scene, settings, frame, pixel_ids, ids_b)
    w_a = jax.grad(display_loss)(jax.lax.stop_gradient(rad_a))
    w_b = jax.grad(display_loss)(jax.lax.stop_gradient(rad_b))
    surrogate = 0.5 * jnp.sum(w_a * rad_b + w_b * rad_a)
    monitor = display_loss(0.5 * (rad_a + rad_b))
    return surrogate, monitor


_OBJECTIVES = {
    "radiance": _paired_objective,
    "display": _paired_objective_tonemapped,
}


def make_train_step(settings, optimizer, mesh=None, loss_space="radiance"):
    """Jitted SGD/Adam step over material params.

    The step takes TWO sample-id arrays (independent waves) for the
    unbiased paired gradient (``_paired_objective``); pass the same array
    twice for the plain biased-MSE gradient. ``loss_space``: "radiance"
    fits pre-tonemap radiance; "display" fits through the reference
    tonemap against display-space targets (real PNGs).

    With ``mesh``: pixels shard over the ``rays`` axis via ``shard_map``,
    per-shard loss/grads are ``psum``-averaged,
    and the optimizer update runs on replicated params — the full
    data-parallel training step the driver's multichip dryrun exercises.
    """

    objective = _OBJECTIVES[loss_space]

    def loss_and_grad_local(
        params, scene, frame, target_rows, pixel_ids, ids_a, ids_b
    ):
        (_, loss), grads = jax.value_and_grad(objective, has_aux=True)(
            params, scene, settings, frame, target_rows, pixel_ids, ids_a, ids_b
        )
        if mesh is not None:
            # Equal-sized shards: global mean = mean of shard means. The
            # cotangent of a *replicated* (P()) input is already psum'd by
            # the shard_map transpose, so grads only need the 1/n rescale —
            # an extra psum would double-count by the shard count.
            n = jax.lax.psum(jnp.ones(()), RAY_AXIS)
            loss = jax.lax.psum(loss, RAY_AXIS) / n
            grads = jax.tree.map(lambda g: g / n, grads)
        return loss, grads

    if mesh is not None:
        loss_and_grad = jax.shard_map(
            loss_and_grad_local,
            mesh=mesh,
            in_specs=(
                P(), P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS),
                P(RAY_AXIS),
            ),
            out_specs=(P(), P()),
        )
    else:
        loss_and_grad = loss_and_grad_local

    @jax.jit
    def train_step(
        params, opt_state, scene, frame, target_rows, pixel_ids,
        sample_ids_a, sample_ids_b,
    ):
        loss, grads = loss_and_grad(
            params, scene, frame, target_rows, pixel_ids, sample_ids_a,
            sample_ids_b,
        )
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        # Project onto the physical range: albedo/specular in [0, 1],
        # emission >= 0, Phong exponent in [1, 499] (the mirror lane gates
        # on Ns > 500, ops/integrator.py — crossing it would flip the lobe
        # discontinuously). Bounds the Adam random walk on parameters with
        # weak pixel coverage (Adam rescales even noise-dominated
        # gradients to full lr-sized steps).
        clips = {
            "mat_Kd": (0.0, 1.0),
            "mat_Ks": (0.0, 1.0),
            "mat_Ke": (0.0, None),
            "mat_Ns": (1.0, 499.0),
        }
        params = {
            k: jnp.clip(v, *clips[k]) if k in clips else v
            for k, v in params.items()
        }
        return params, opt_state, loss

    return train_step


def recover_materials(
    scene,
    camera,
    settings,
    target_image,
    steps: int = 100,
    learning_rate: float = 5e-2,
    init_params: dict | None = None,
    mesh=None,
    callback=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    fields=PARAM_FIELDS,
    stop_after: int | None = None,
    loss_space: str = "radiance",
    samples_per_step: int = 1,
    optimizer=None,
):
    """Gradient-descent recovery of material arrays from a target render.

    ``target_image``: [H, W, 3] mean radiance (pre-tonemap), or — with
    ``loss_space="display"`` — a display-space [0, 1] image (e.g. a
    decoded ground-truth PNG) fit through the reference tonemap. Returns
    (recovered params, list of losses). BASELINE.json config 5.

    ``checkpoint_path``: persist (params, optimizer state, step) every
    ``checkpoint_every`` steps via ``utils.checkpoint.save_pytree`` and
    resume from it when present. Sample ids derive from the step index, so
    a resumed run is bit-identical to one that ran straight through.

    ``samples_per_step``: paths per pixel per wave per step. Adam
    normalizes even noise-dominated gradients to full lr-sized steps, so a
    parameter whose signal is far below the 1-sample gradient noise (e.g.
    the Phong exponent's highlight-shape signal) drifts at ~lr * SNR per
    step; raising this multiplies the SNR by sqrt(samples_per_step).

    ``optimizer``: optax transformation override. The default
    adam+cosine(lr) follows the *normalized* gradient, whose drift
    direction is the gradient's median-ish sign — wrong for heavy-tailed
    Monte Carlo gradients (measured on the Phong exponent: mean -2.9e-5
    pulling toward the optimum, but 56% of 1-sample steps positive). For
    such parameters pass adam with a long first-moment window (b1 ~ 0.98),
    which tracks the gradient *mean* across steps.
    """
    import os

    import optax

    from pathtracer_tpu.utils.checkpoint import load_pytree, save_pytree

    # Adam moves each parameter ~lr per step regardless of scale, so the
    # peak lr must cover the largest parameter excursion (emission is
    # O(10)); cosine decay then polishes the O(1) albedos. Adam's
    # per-parameter normalization handles the 20x Kd-vs-Ke scale spread.
    if optimizer is None:
        optimizer = optax.adam(
            optax.cosine_decay_schedule(learning_rate, max(steps, 1))
        )
    params = init_params or material_params(scene, fields)
    opt_state = optimizer.init(params)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        params, opt_state, start_arr = load_pytree(
            checkpoint_path, (params, opt_state, jnp.int32(0))
        )
        start = int(start_arr)
    train_step = make_train_step(
        settings, optimizer, mesh=mesh, loss_space=loss_space
    )

    frame = {
        k: jnp.asarray(v)
        for k, v in camera.ray_frame(settings.width, settings.height).items()
    }
    n_pixels = settings.width * settings.height
    k = max(1, samples_per_step)
    pixel_ids = jnp.tile(jnp.arange(n_pixels, dtype=jnp.uint32), k)
    target_rows = jnp.asarray(target_image).reshape(n_pixels, 3)
    if k > 1:
        target_rows = jnp.tile(target_rows, (k, 1))
    sub = jnp.repeat(jnp.arange(k, dtype=jnp.uint32), n_pixels)

    # ``stop_after`` bounds this run's steps while keeping the lr schedule
    # on the full ``steps`` horizon — a later resumed run is then
    # bit-identical to one that ran straight through.
    end = steps if stop_after is None else min(steps, start + stop_after)
    losses = []
    for step_idx in range(start, end):
        # Two fresh independent waves per step (see _paired_objective);
        # each wave draws k samples per pixel from disjoint id ranges.
        ids_a = jnp.uint32(2 * step_idx * k) + sub
        ids_b = jnp.uint32((2 * step_idx + 1) * k) + sub
        params, opt_state, loss = train_step(
            params, opt_state, scene, frame, target_rows, pixel_ids,
            ids_a, ids_b,
        )
        losses.append(float(loss))
        if callback is not None:
            callback(step_idx, losses[-1], params)
        if checkpoint_path and (
            (step_idx + 1) % checkpoint_every == 0 or step_idx + 1 == end
        ):
            save_pytree(
                checkpoint_path, (params, opt_state, jnp.int32(step_idx + 1))
            )
    return params, losses


def downsample_display(img, factor: int):
    """Box-average a display-space [H, W, 3] image by ``factor``.

    Matching resolutions this way (fit at H/f x W/f against the averaged
    PNG) is the standard trick for cheap fits against a full-res target;
    the tonemap and the box filter do not exactly commute, but the
    reference tonemap is nearly linear so the gap is far below the
    cross-renderer noise floor.
    """
    h, w, c = img.shape
    return (
        img.reshape(h // factor, factor, w // factor, factor, c)
        .mean(axis=(1, 3))
    )


def recover_from_ground_truth(
    ini_path: str,
    target_png: str,
    fit_size: int = 64,
    steps: int = 120,
    learning_rate: float = 5e-2,
    fields=("mat_Kd",),
    perturb: float = 0.5,
    samples_per_pixel: int = 8,
    max_depth: int = 9,
    scene_override=None,
):
    """BASELINE.json config 5, verbatim: recover CornellBox materials from
    the reference's actual ground-truth PNG (display space).

    Loads the scene from ``ini_path``, perturbs the chosen material fields
    by ``perturb``, and fits them against the decoded ``target_png``
    through the reference tonemap at ``fit_size`` (the 512x512 PNG is
    box-averaged down to match). Returns (true scene, perturbed scene,
    recovered params, losses).
    """
    from pathtracer_tpu.models.scene import load_scene
    from pathtracer_tpu.utils.image import read_png

    scene, camera, settings, _ = load_scene(
        ini_path,
        width=fit_size,
        height=fit_size,
        samples_per_pixel=samples_per_pixel,
        max_depth=max_depth,
        scheduler="scan",
    )
    if scene_override is not None:
        scene = scene_override(scene)
    target = read_png(target_png)
    factor = target.shape[0] // fit_size
    target = downsample_display(target, factor)

    pert = scene.replace(
        **{f: getattr(scene, f) * perturb for f in fields}
    )
    params, losses = recover_materials(
        pert, camera, settings, target,
        steps=steps, learning_rate=learning_rate, fields=fields,
        loss_space="display",
    )
    return scene, pert, params, losses
