"""Profiling and observability.

The reference's only instrumentation is a per-frame console log
(``program-raymarch.ts:323``) and a triangle-test counter that is never read
out (``intersection-logic.wgsl:18``). Here rays/sec is a first-class counter
(the integrator reports real live-lane ray counts — ops.integrator), plus:

- ``timed``: wall-clock block timer with ``block_until_ready`` semantics;
- ``trace``: context manager around ``jax.profiler`` for device traces
  viewable in TensorBoard/XProf;
- ``trace_summary``: device busy/idle share and per-scope device time from
  such a trace;
- ``RenderStats``: rays/paths/iterations throughput record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import re
import time


@dataclasses.dataclass
class RenderStats:
    wall_s: float
    rays: float
    paths: float
    iterations: int = 0

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def paths_per_sec(self) -> float:
        return self.paths / self.wall_s if self.wall_s > 0 else 0.0

    def __str__(self) -> str:
        return (
            f"{self.rays_per_sec / 1e6:.2f} Mrays/s "
            f"({self.paths_per_sec / 1e6:.2f} Mpaths/s, "
            f"{self.wall_s:.3f}s wall, {self.iterations} iters)"
        )


@contextlib.contextmanager
def timed(result: dict, key: str = "wall_s"):
    """Time a block, blocking on any jax.Array placed in result['block_on']."""
    import jax

    t0 = time.perf_counter()
    yield result
    if "block_on" in result:
        jax.block_until_ready(result.pop("block_on"))
    result[key] = time.perf_counter() - t0


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace (jax.profiler) around the block."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_HLO_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=")
_HLO_COMP = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_op_names(hlo_text: str) -> dict:
    """{HLO instruction name: op_names} of a compiled module's text
    (``jax.jit(f).lower(...).compile().as_text()``), "|"-joined.

    A fusion gets its own op_name and those of every instruction in the
    computation it calls, so a sweep fused under a consumer (whose op_name
    is the fusion root's) is still found by its ``jax.named_scope``.
    """
    own, calls, comp_names = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = _HLO_INSTR.match(line)
        if m is None:
            c = _HLO_COMP.match(line)
            if c:
                comp = c.group(1)
            continue
        names = _OP_NAME.findall(line)
        own[m.group(1)] = names
        if comp is not None:
            comp_names.setdefault(comp, []).extend(names)
        cm = _CALLS.search(line)
        if cm and "fusion(" in line:
            calls[m.group(1)] = cm.group(1)
    out = {}
    for instr, names in own.items():
        names = names + comp_names.get(calls.get(instr), [])
        if names:
            out[instr] = "|".join(dict.fromkeys(names))
    return out


def _union_ns(intervals) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def latest_xplane(logdir: str) -> str:
    """Newest ``*.xplane.pb`` that ``trace(logdir)`` wrote."""
    paths = glob.glob(os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no xplane trace under {logdir!r}")
    return max(paths, key=os.path.getmtime)


def trace_summary(xplane_path: str, op_names: dict | None = None,
                  scopes=(), top: int = 15) -> dict:
    """Device time summary of one profiler trace.

    Device events are those on ``/device:*`` planes (kernels and copies on
    the GPU's streams); where a trace has none (the CPU backend), the host
    events that carry an ``hlo_op`` stat stand in, so the reduction can be
    tested without a card. ``window_ns`` spans the first event's start to
    the last event's end; ``busy_ns`` is the union of event intervals, and
    ``idle_share`` is 1 - busy / window. ``scope_ns[s]`` sums the device
    time of events whose HLO instruction's op_name (``op_names``, from
    ``hlo_op_names``) contains the named scope ``s``. ``top`` lists the
    heaviest HLO instructions with their op_names.
    """
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    planes = [p for p in pd.planes if p.name.startswith("/device:")]
    events = []
    for plane in planes:
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                events.append((ev.start_ns, ev.duration_ns, dict(ev.stats)))
    if not events:
        for plane in pd.planes:
            for line in plane.lines:
                for ev in line.events:
                    st = dict(ev.stats)
                    if "hlo_op" in st:
                        events.append((ev.start_ns, ev.duration_ns, st))
    if not events:
        raise ValueError(f"no device events in {xplane_path!r}")

    intervals = [(s, s + d) for s, d, _ in events]
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = _union_ns(intervals)
    op_names = op_names or {}
    per_op: dict = {}
    scope_ns = {sc: 0.0 for sc in scopes}
    for _, dur, st in events:
        op = str(st.get("hlo_op", ""))
        tot, cnt = per_op.get(op, (0.0, 0))
        per_op[op] = (tot + dur, cnt + 1)
        name = op_names.get(op, str(st.get("tf_op", "")))
        for sc in scopes:
            if sc in name:
                scope_ns[sc] += dur
    kernel_ns = sum(t for t, _ in per_op.values())
    heavy = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "window_ns": float(window),
        "busy_ns": float(busy),
        "idle_share": 1.0 - busy / window if window > 0 else 0.0,
        "n_events": len(events),
        "kernel_ns": float(kernel_ns),
        "scope_ns": scope_ns,
        "scope_share": {
            sc: (ns / kernel_ns if kernel_ns else 0.0)
            for sc, ns in scope_ns.items()
        },
        "top": [
            {"hlo_op": op, "ns": float(t), "count": c,
             "op_name": op_names.get(op, "")}
            for op, (t, c) in heavy
        ],
    }
