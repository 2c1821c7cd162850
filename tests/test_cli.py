"""CLI smoke tests: INI in, PNG out."""

import os

import numpy as np
import pytest

from pathtracer_tpu.cli import main
from pathtracer_tpu.utils.image import read_png


def test_cli_renders_png(reference_root, tmp_path):
    ini = str(reference_root / "scene_files/final/cornell_box_full_lighting.ini")
    out = str(tmp_path / "cli_out.png")
    rc = main([ini, "--size", "32", "--spp", "2", "--out", out])
    assert rc == 0
    assert os.path.exists(out)
    img = read_png(out)
    assert img.shape == (32, 32, 3)
    assert img.mean() > 0.01  # lit, not black


def test_cli_seed_changes_noise(reference_root, tmp_path):
    ini = str(reference_root / "scene_files/final/cornell_box_full_lighting.ini")
    out_a = str(tmp_path / "a.png")
    out_b = str(tmp_path / "b.png")
    out_a2 = str(tmp_path / "a2.png")
    base = [ini, "--size", "24", "--spp", "2"]
    assert main(base + ["--out", out_a, "--seed", "0"]) == 0
    assert main(base + ["--out", out_b, "--seed", "7"]) == 0
    assert main(base + ["--out", out_a2, "--seed", "0"]) == 0
    a, b, a2 = read_png(out_a), read_png(out_b), read_png(out_a2)
    assert not np.array_equal(a, b), "seed had no effect"
    np.testing.assert_array_equal(a, a2)  # same seed reproduces exactly


def test_cli_sharded_scan(reference_root, tmp_path):
    """--sharded with the scan scheduler writes the same image as the
    single-device render (bit-identical counter RNG)."""
    ini = str(reference_root / "scene_files/final/cornell_box_full_lighting.ini")
    out_s = str(tmp_path / "sharded.png")
    out_1 = str(tmp_path / "single.png")
    base = [ini, "--size", "24", "--spp", "2", "--scheduler", "scan"]
    assert main(base + ["--out", out_s, "--sharded"]) == 0
    assert main(base + ["--out", out_1]) == 0
    np.testing.assert_array_equal(read_png(out_s), read_png(out_1))


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
def test_cli_preview_png(reference_root, tmp_path, scheduler):
    """--preview-png N writes tonemapped partials every N samples and the
    final image equals a non-preview render.
    """
    ini = str(reference_root / "scene_files/final/cornell_box_full_lighting.ini")
    out_p = str(tmp_path / "prev.png")
    out_n = str(tmp_path / "plain.png")
    base = [ini, "--size", "24", "--spp", "6", "--scheduler", scheduler]
    assert main(base + ["--out", out_p, "--preview-png", "2"]) == 0
    assert main(base + ["--out", out_n]) == 0

    previews = sorted(tmp_path.glob("prev.preview_*.png"))
    assert [p.name for p in previews] == [
        "prev.preview_0002.png", "prev.preview_0004.png"
    ]
    for p in previews:
        img = read_png(str(p))
        assert img.shape == (24, 24, 3)
        assert img.mean() > 0.01

    final_p, final_n = read_png(out_p), read_png(out_n)
    # Same paths either way (counter-based RNG); the pool path chunks the
    # accumulation so only float summation order may differ -> one 8-bit
    # quantization step of slack.
    assert np.abs(final_p.astype(np.float64) - final_n).max() <= (1.5 / 255.0)
