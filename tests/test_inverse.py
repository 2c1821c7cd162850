"""Inverse rendering closes the loop (BASELINE.json config 5).

Perturb the procedural Cornell box's materials, render a target with the
true materials, and verify gradient descent actually recovers them — not
just that one train step runs. Gradients are the unbiased paired-wave
path-replay estimator (inverse._paired_objective).

Notes on what is recoverable at test scale:
- albedo (Kd) and emission (Ke) each recover tightly when fit alone;
- fitting both jointly is gauge-ambiguous on a mostly-diffuse box (pixel
  brightness ~ Ke * Kd along the light path; only the handful of pixels
  that see the emitter directly pin Ke), so the joint test asserts on the
  *relit image*, not on individual parameters;
- the light's own Kd is invisible to the camera and legitimately stays
  unconstrained — assertions cover the wall/box materials (ids 0..2).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer_tpu.inverse import material_params, recover_materials
from pathtracer_tpu.models.procedural import cornell_box_scene
from pathtracer_tpu.models.scene import RenderSettings
from pathtracer_tpu.render import render
from pathtracer_tpu.utils.image import mse


SETTINGS = RenderSettings(
    width=24, height=24, samples_per_pixel=16, max_depth=4, scheduler="scan"
)


@pytest.fixture(scope="module")
def problem():
    """(true scene, camera, target image, true params)."""
    scene, camera = cornell_box_scene()
    true_params = material_params(scene)
    target = jnp.asarray(render(scene, camera, SETTINGS))
    return scene, camera, target, true_params


def test_recover_albedo_converges(problem):
    scene, camera, target, true_params = problem
    pert = scene.replace(mat_Kd=scene.mat_Kd * 0.5)
    params, _ = recover_materials(
        pert, camera, SETTINGS, target, steps=100, learning_rate=0.05,
        fields=("mat_Kd",),
    )
    kd = np.asarray(params["mat_Kd"])
    kd_true = np.asarray(true_params["mat_Kd"])
    # White walls/boxes, red wall, green wall all land on the truth.
    err = np.abs(kd - kd_true).max(axis=1)
    assert (err[:3] < 0.08).all(), f"per-material Kd error {err}"


def test_recover_emission_converges(problem):
    scene, camera, target, true_params = problem
    pert = scene.replace(mat_Ke=scene.mat_Ke * 0.5)
    params, _ = recover_materials(
        pert, camera, SETTINGS, target, steps=150, learning_rate=0.5,
        fields=("mat_Ke",),
    )
    ke = np.asarray(params["mat_Ke"])
    ke_true = np.asarray(true_params["mat_Ke"])
    emitter = ke_true.sum(axis=1) > 0
    np.testing.assert_allclose(ke[emitter], ke_true[emitter], atol=1.5)


def test_recover_joint_relights_the_scene(problem):
    """Joint Kd+Ke fit: individual parameters are gauge-ambiguous, but the
    relit image must land on the target."""
    scene, camera, target, _ = problem
    pert = scene.replace(mat_Kd=scene.mat_Kd * 0.5, mat_Ke=scene.mat_Ke * 0.6)
    init_mse = mse(np.asarray(render(pert, camera, SETTINGS)), np.asarray(target))
    params, _ = recover_materials(
        pert, camera, SETTINGS, target, steps=150, learning_rate=0.15
    )
    relit = render(pert.replace(**params), camera, SETTINGS)
    final_mse = mse(np.asarray(relit), np.asarray(target))
    assert final_mse < 0.25 * init_mse, (init_mse, final_mse)


def test_recover_materials_sharded_mesh(problem):
    """Albedo recovery with the pixel batch sharded over the 8-device mesh
    (psum'd paired gradients)."""
    from pathtracer_tpu.parallel.mesh import make_mesh

    scene, camera, target, true_params = problem
    pert = scene.replace(mat_Kd=scene.mat_Kd * 0.5)
    params, _ = recover_materials(
        pert, camera, SETTINGS, target, steps=60, learning_rate=0.05,
        fields=("mat_Kd",), mesh=make_mesh(),
    )
    err = np.abs(
        np.asarray(params["mat_Kd"]) - np.asarray(true_params["mat_Kd"])
    ).max(axis=1)
    assert (err[:3] < 0.15).all(), f"per-material Kd error {err}"


def test_recover_checkpoint_resume_identical(problem, tmp_path):
    """Stop after 10 steps, resume from the saved optimizer state, and land
    bit-identically on the straight-through 20-step result."""
    scene, camera, target, _ = problem
    pert = scene.replace(mat_Kd=scene.mat_Kd * 0.5)
    straight, _ = recover_materials(
        pert, camera, SETTINGS, target, steps=20, learning_rate=0.05
    )

    ckpt = str(tmp_path / "opt.npz")
    recover_materials(
        pert, camera, SETTINGS, target, steps=20, learning_rate=0.05,
        checkpoint_path=ckpt, checkpoint_every=5, stop_after=10,
    )
    resumed, losses = recover_materials(
        pert, camera, SETTINGS, target, steps=20, learning_rate=0.05,
        checkpoint_path=ckpt, checkpoint_every=5,
    )
    assert len(losses) == 10  # only the remaining steps ran
    for k in straight:
        np.testing.assert_array_equal(
            np.asarray(straight[k]), np.asarray(resumed[k])
        )


def test_recover_albedo_from_reference_ground_truth_png(reference_root):
    """BASELINE.json config 5 verbatim: start from perturbed materials and
    recover CornellBox albedo against the reference's *actual* ground-truth
    PNG (display space, through the reference tonemap).

    Residual bias, measured and documented: the dominant gap is NOT the
    tonemap (nearly linear) but the instructor-vs-reference renderer
    difference — the instructor's GT is ~1.9x brighter in blue and ~0.88x
    in red than a reference-faithful render with the true MTL materials
    (this repo matches the reference's own student_outputs to ratio
    1.00/0.98/0.93 per channel). A fit against GT therefore legitimately
    inflates blue albedo to absorb that gap, so the gates are:

    1. the fitted materials explain the GT image at least as well as the
       *true* MTL materials do (the fit recovers the full signal), and
       far better than the perturbed start;
    2. red/green albedos (where the renderers agree) land near MTL truth
       (within 0.30 — the perturbed start is ~0.40 off; the white
       floor/ceiling/backWall triplet is partially gauge-coupled through
       indirect light, so individual whites carry the largest residual).
    """
    import jax.numpy as jnp

    from pathtracer_tpu.inverse import (
        downsample_display, recover_from_ground_truth,
    )
    from pathtracer_tpu.models.scene import load_scene
    from pathtracer_tpu.ops.tonemap import tonemap_reference
    from pathtracer_tpu.utils.image import read_png

    ini = str(reference_root / "scene_files/final/cornell_box_full_lighting.ini")
    png = str(
        reference_root
        / "scene_assets/ground_truth/final/cornell_box_full_lighting.png"
    )
    scene, pert, params, losses = recover_from_ground_truth(
        ini, png, fit_size=32, steps=100, learning_rate=4e-2,
        fields=("mat_Kd",), perturb=0.45, samples_per_pixel=4, max_depth=17,
    )

    # Clean evaluation renders (same estimator, higher spp).
    _, camera, ev, _ = load_scene(
        ini, width=32, height=32, samples_per_pixel=32, max_depth=17,
        scheduler="scan",
    )
    gt = downsample_display(read_png(png), 512 // 32)

    def display_mse(s):
        img = tonemap_reference(jnp.asarray(render(s, camera, ev)))
        return float(np.mean((np.asarray(img) - gt) ** 2))

    mse_true = display_mse(scene)
    mse_pert = display_mse(pert)
    mse_fit = display_mse(pert.replace(**params))
    # Gate 1: fit explains GT at least as well as the true materials
    # (it may do better — it absorbs the cross-renderer gap) and far
    # better than the perturbed start.
    assert mse_fit < 0.5 * mse_pert, (mse_pert, mse_fit)
    assert mse_fit < 1.15 * mse_true, (mse_true, mse_fit)
    # Gate 2: R/G albedo near MTL truth. The colored walls are pinned
    # individually; the five white surfaces are gauge-coupled through
    # indirect light (and absorb the red-channel renderer gap), so they
    # are gated on their set mean plus a loose individual bound.
    kd = np.asarray(params["mat_Kd"])
    kd_true = np.asarray(scene.mat_Kd)
    visible = np.asarray(scene.mat_Ke).sum(axis=1) == 0.0
    colored = visible & (np.ptp(kd_true, axis=1) > 0.2)
    white = visible & ~colored & (kd_true.sum(axis=1) > 0.5)
    err_rg = np.abs(kd - kd_true)[:, :2].max(axis=1)
    assert (err_rg[colored] < 0.25).all(), f"colored-wall error {err_rg[colored]}"
    assert err_rg[white].mean() < 0.25, f"white-set mean error {err_rg[white]}"
    assert (err_rg[visible] < 0.40).all(), f"worst-case error {err_rg[visible]}"
