"""Trace reduction (utils.profiling): busy/idle share and per-scope device
time from a small recorded trace."""

import jax
import jax.numpy as jnp
import pytest

from pathtracer_tpu.utils.profiling import (
    _union_ns,
    hlo_op_names,
    latest_xplane,
    trace,
    trace_summary,
)


def test_union_of_intervals():
    assert _union_ns([(0, 10), (5, 15), (20, 25)]) == 20
    assert _union_ns([(20, 25), (0, 10), (2, 3)]) == 15
    assert _union_ns([]) == 0


def test_hlo_op_names_reads_scopes():
    @jax.jit
    def f(x):
        with jax.named_scope("alpha"):
            return jnp.sin(x) * 2.0

    names = hlo_op_names(f.lower(jnp.ones(8)).compile().as_text())
    assert any("alpha" in v for v in names.values())


def test_trace_summary_on_recorded_trace(tmp_path):
    @jax.jit
    def f(x):
        with jax.named_scope("closest_hit_sweep"):
            y = jnp.sin(x) @ x
        with jax.named_scope("shadow_sweep"):
            return jnp.cos(y).sum()

    x = jnp.ones((128, 128))
    names = hlo_op_names(f.lower(x).compile().as_text())
    f(x).block_until_ready()
    with trace(str(tmp_path)):
        for _ in range(2):
            f(x).block_until_ready()
    s = trace_summary(latest_xplane(str(tmp_path)), names,
                      scopes=("closest_hit_sweep", "shadow_sweep", "absent"))
    assert s["n_events"] > 0
    assert 0.0 < s["busy_ns"] <= s["window_ns"]
    assert 0.0 <= s["idle_share"] < 1.0
    assert s["scope_ns"]["closest_hit_sweep"] > 0
    assert s["scope_ns"]["shadow_sweep"] > 0
    assert s["scope_ns"]["absent"] == 0
    assert sum(s["scope_share"].values()) <= 1.0 + 1e-9
    assert s["top"][0]["ns"] >= s["top"][-1]["ns"]


def test_latest_xplane_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        latest_xplane(str(tmp_path))
