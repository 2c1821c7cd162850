"""chip_smoke.py: refuses to run without a GPU, and its phases (imported,
not through ``main``) pass at a tiny size on the CPU."""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs a gpu device" in proc.stderr


def test_phase_device_refuses_cpu(smoke):
    with pytest.raises(SystemExit):
        smoke.phase_device("gpu")
    assert smoke.phase_device("cpu")["platform"] == "cpu"


def test_image_agreement_tolerance(smoke):
    ref = np.full((100, 100, 3), 0.5)
    out = smoke.image_agreement(ref * (1 + 1e-6), ref)
    assert out["pixels_within"] == 1.0
    few = ref.copy()
    few[0, :5] = 0.6  # 5 of 10^4 pixels: 0.05% off, mean moves 5e-6 rel.
    few[0, 5:10] = 0.4
    smoke.image_agreement(few, ref)
    many = ref.copy()
    many[:2] = 0.6  # 2% of pixels
    with pytest.raises(AssertionError):
        smoke.image_agreement(many, ref)
    with pytest.raises(AssertionError):
        smoke.image_agreement(ref * np.nan, ref)


def _parse(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("PHASE ")]
    assert len(lines) == 1
    return json.loads(lines[0][len("PHASE "):])


def test_phase_final_frame_tiny(smoke, capsys, tmp_path):
    rec = smoke.phase_final_frame("cpu", size=16, spp=2, depth=3,
                                  trace_dir=str(tmp_path / "trace"))
    assert _parse(capsys)["phase"] == "final_frame"
    assert rec["intersector"] == "brute"  # "sweep" on a GPU
    assert rec["pixels_within"] >= smoke.PIXEL_FRAC
    assert (tmp_path / "trace" / "summary.json").exists()


def test_phase_large_mesh_tiny(smoke, capsys):
    rec = smoke.phase_large_mesh("cpu", size=16, spp=1, n_tris=2400,
                                 n_rays=1024, sort_size=16)
    assert _parse(capsys)["intersector"] == "brute"
    assert rec["t_mismatches"] == rec["occlusion_mismatches"] == 0


def test_phase_inverse_tiny(smoke, capsys):
    rec = smoke.phase_inverse("cpu", size=16, depth=3, steps=3, grad_size=8,
                              samples_per_step=1)
    assert _parse(capsys)["phase"] == "inverse"
    assert rec["eval_loss_start_end"][1] < rec["eval_loss_start_end"][0]
    assert rec["grad_rel_err_vs_cpu"] <= smoke.GRAD_RTOL


def test_phase_sharded_tiny(smoke, capsys):
    rec = smoke.phase_sharded("cpu", 4, size=16, spp=4, train_size=8)
    assert _parse(capsys)["phase"] == "sharded"
    assert rec["train_loss_rel_err"] <= smoke.LOSS_RTOL
