"""Intersector routing: ``auto`` picks by backend and triangle count, and
names of removed intersectors are refused, never rerouted."""

import types

import jax
import pytest

from pathtracer_tpu.cli import main
from pathtracer_tpu.models.scene import INTERSECTORS, RenderSettings
from pathtracer_tpu.ops.intersect import (
    SHORTLIST_MIN_T,
    TMAJOR_MAX_T,
    resolve_intersector,
)

REMOVED = ("small_pallas", "shortlist_pallas", "pallas", "cluster")


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
@pytest.mark.parametrize(
    "tris",
    [36, TMAJOR_MAX_T, TMAJOR_MAX_T + 1, 12_600, SHORTLIST_MIN_T],
)
def test_auto_routes_by_backend_and_triangle_count(monkeypatch, backend, tris):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    scene = types.SimpleNamespace(num_tris=tris, padded_tris=-(-tris // 128) * 128)
    if tris >= SHORTLIST_MIN_T:
        expected = "shortlist"
    elif tris <= TMAJOR_MAX_T and backend == "gpu":
        expected = "sweep"
    else:
        expected = "brute"
    assert resolve_intersector(RenderSettings(), scene) == expected


@pytest.mark.parametrize("name", ["brute", "sweep", "shortlist", "bvh"])
def test_explicit_intersector_passes_through(name):
    scene = types.SimpleNamespace(num_tris=100, padded_tris=128)
    assert resolve_intersector(RenderSettings(intersector=name), scene) == name


@pytest.mark.parametrize("surface", ["settings", "cli"])
@pytest.mark.parametrize("name", REMOVED)
def test_removed_intersector_is_refused(tmp_path, capsys, surface, name):
    if surface == "settings":
        with pytest.raises(ValueError, match="available: auto, brute, sweep"):
            RenderSettings(intersector=name)
        return
    with pytest.raises(SystemExit) as exc:
        main([str(tmp_path / "scene.ini"), "--intersector", name])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"invalid choice: '{name}'" in err
    assert all(n in err for n in INTERSECTORS)
