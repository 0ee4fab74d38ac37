"""The program's own spans in a traced window, and the device's idle time
split by them.

The port wraps each phase of its host loop in a ``gfdm.*`` span
(``gfdm_tpu_torch.utils.profiling.span``), which is a user annotation in the
profiler's Chrome trace while a profiler records. ``reduce(events)`` gives,
for the window annotation named ``window`` (``tracing.traced``'s
``bench_window``):

- ``spans``: each ``gfdm.*`` name's host seconds inside the window (each
  range clipped to it) and the number of ranges that overlap it;
- ``idle_s``: the device's idle time inside the window, the same device
  intervals and gaps as ``tracing.summarize``;
- ``idle_by_span``: that idle time split by the innermost ``gfdm.*`` range
  open at each microsecond of it (by overlap, so one gap that runs on
  through several ranges is shared among them), and ``unattributed`` where
  none is open.

Times in the trace are microseconds; everything returned is in seconds.
"""
from __future__ import annotations

from .tracing import DEVICE_CATS, _gaps

PREFIX = "gfdm."
UNATTRIBUTED = "unattributed"


def _innermost(ranges: list) -> list:
    """(start, end, name) ranges -> sorted, disjoint (start, end, name)
    pieces, each labelled with the innermost range open over it: the one
    that started last (on equal starts, the one that ends first)."""
    bounds = sorted({t for a, b, _ in ranges for t in (a, b)})
    ranges = sorted(ranges)
    pieces, open_, i = [], [], 0
    for lo, hi in zip(bounds, bounds[1:]):
        while i < len(ranges) and ranges[i][0] <= lo:
            open_.append(ranges[i])
            i += 1
        open_ = [r for r in open_ if r[1] > lo]
        if open_:
            name = max(open_, key=lambda r: (r[0], -r[1]))[2]
            pieces.append((lo, hi, name))
    return pieces


def _charge(gaps: list, pieces: list) -> dict:
    """Each gap's length split over the pieces it overlaps, the rest
    ``UNATTRIBUTED`` (both lists sorted and disjoint)."""
    out: dict = {}
    j = 0
    for a, b in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi, name = pieces[k]
            d = min(b, hi) - max(a, lo)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
                covered += d
            k += 1
        out[UNATTRIBUTED] = out.get(UNATTRIBUTED, 0.0) + (b - a - covered)
    return out


def reduce(events: list, window: str = "bench_window") -> dict:
    """The window's ``gfdm.*`` spans and the device's idle time split by
    them (see the module docstring); {} without the window."""
    win = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") == window]
    if not win:
        return {}
    lo = float(win[0]["ts"])
    hi = lo + float(win[0]["dur"])
    dev, ranges, spans = [], [], {}
    for e in events:
        if "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if e.get("cat") in DEVICE_CATS:
            dev.append((a, b))
        elif e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(PREFIX):
            ranges.append((a, b, e["name"]))
            s = spans.setdefault(e["name"], [0.0, 0])
            s[0] += (b - a) * 1e-6
            s[1] += 1
    gaps = _gaps(dev, lo, hi)
    idle = _charge(gaps, _innermost(ranges))
    return {
        "window_s": (hi - lo) * 1e-6,
        "idle_s": sum(b - a for a, b in gaps) * 1e-6,
        "spans": spans,
        "idle_by_span": {k: v * 1e-6 for k, v in
                         sorted(idle.items(), key=lambda kv: -kv[1])},
    }
