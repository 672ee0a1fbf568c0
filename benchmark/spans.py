"""The program's own spans in a traced window.

The port marks its phases with ``vmt.`` ranges (``videomamba_tpu_torch.
utils.profiling.annotate``): ``vmt.train.step`` and ``vmt.session.process``
around a step or a chunk call, phases inside them, and ``vmt.sync.<site>``
around each statement that blocks the host on the card. They are
``record_function`` ranges, so they sit in ``trace.Trace.ranges`` beside
the benchmark's own, on the clock of the device records. A program that
has none (an older commit) gives every reader here nothing: None.

Times are the trace's microseconds unless a name says otherwise.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "vmt."
SYNC = "vmt.sync."
STEP = "vmt.train.step"
PROCESS = "vmt.session.process"

Interval = Tuple[float, float]


def spans(trace, prefix: str, main_only: bool = True) -> List[Tuple[str, float, float]]:
    """(name, start, end) of the window's ranges whose name starts with
    ``prefix``, on the main thread (or on every thread), by start."""
    out = [(str(r["name"]), float(r["ts"]), float(r["ts"]) + float(r["dur"]))
           for r in trace.ranges
           if str(r.get("name", "")).startswith(prefix) and trace.t0 <= float(r["ts"]) <= trace.t1
           and (not main_only or r.get("tid") == trace.main_tid)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def calls(trace, name: str) -> List[Interval]:
    """The main thread's ``name`` spans in the window (a step or a call each)."""
    return [(lo, hi) for n, lo, hi in spans(trace, name) if n == name]


def _with_syncs(trace, name: str) -> List[Tuple[float, float, List[float]]]:
    """Each main-thread ``name`` span: (start, end, the durations of the
    ``vmt.sync.`` spans, on any thread, that start inside it)."""
    syncs = spans(trace, SYNC, main_only=False)
    return [(lo, hi, [b - a for _, a, b in syncs if lo <= a <= hi])
            for lo, hi in calls(trace, name)]


def syncs_per_call(trace, name: str) -> Optional[float]:
    """Host syncs a ``name`` span, over the window's spans of that name;
    None where the window has none."""
    outer = _with_syncs(trace, name)
    if not outer:
        return None
    return sum(len(waits) for _, _, waits in outer) / len(outer)


def issue_ms(trace, name: str) -> Optional[float]:
    """The median over the window's ``name`` spans of each one's duration
    less the time of the syncs inside it: the host's own time to issue it."""
    outer = _with_syncs(trace, name)
    if not outer:
        return None
    return statistics.median(hi - lo - sum(waits) for lo, hi, waits in outer) / 1e3


def idle_intervals(trace) -> List[Interval]:
    """The window's stretches with no kernel, memcpy or memset on the card."""
    gaps, prev = [], trace.t0
    for lo, hi in trace._intervals() + [(trace.t1, trace.t1)]:
        if lo > prev:
            gaps.append((prev, lo))
        prev = max(prev, hi)
    return gaps


def _overlap(a: List[Interval], b: List[Interval]) -> float:
    """Length of the intersection of two lists of disjoint sorted intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct_inside(trace, name: str) -> Optional[float]:
    """The share of the window, in %, in which the card is idle while the
    main thread is inside a ``name`` span; None without such spans or
    without device records."""
    outer = calls(trace, name)
    if not outer or trace.busy_s <= 0:
        return None
    clipped = [(max(lo, trace.t0), min(hi, trace.t1)) for lo, hi in outer]
    return 100.0 * _overlap(idle_intervals(trace), clipped) / (trace.t1 - trace.t0)


def idle_by_span(trace) -> Dict[str, float]:
    """Each idle stretch's seconds, put down to the innermost main-thread
    ``vmt.`` span open at that moment ("outside" where none is): where the
    host was when the card ran dry."""
    own = spans(trace, PREFIX)
    edges = sorted({t for _, lo, hi in own for t in (lo, hi)})
    out: Dict[str, float] = defaultdict(float)
    for lo, hi in idle_intervals(trace):
        cuts = [lo] + edges[bisect.bisect_right(edges, lo):bisect.bisect_left(edges, hi)] + [hi]
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = [(n, s, e) for n, s, e in own if s <= mid <= e]
            name = max(inner, key=lambda s: (s[1], -s[2]))[0] if inner else "outside"
            out[name] += (b - a) / 1e6
    return dict(out)
