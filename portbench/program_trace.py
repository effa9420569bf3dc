"""The port's own spans in the traced window.

While a profiler records, the port marks its host code with
``record_function`` spans (``blur_algorithms_tpu_torch/utils/trace.py``):

- ``api.blur_u8`` / ``api.blur``: the whole call of the public entry;
- ``api.route``: its checks and routing, before any data is touched;
- ``layout.to_planar`` / ``layout.from_planar``: the dispatch of the two
  layout copies;
- ``launch.<C entry>``: one launch of a kernel of the port's library, the
  wrapper's work on the CUDA path up to the return of the C entry.

``reduce`` reads them from the same Chrome trace as ``trace.reduce_chrome``,
over the same window (the first to the last ``portbench.call``), on the
call's thread, and gives:

- the host seconds inside each span name;
- each device op (kernel, copy, set) put down to the innermost span of the
  port's that launched it: by the ``correlation`` of its CUDA runtime or
  driver launch event; a kernel with no such event, by launch order within
  its call (one stream): the k-th such kernel of a call goes to the k-th
  ``launch.*`` span of the call that no correlated op claimed;
- each idle gap of the device put down to the innermost span of the port's
  that the host was in.

What falls in none of the port's spans counts under ``OUTSIDE``. A trace of
a program without these spans gives host times of none and every op and gap
under ``OUTSIDE``. ``trace.py`` and its readers do not see the spans.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import pathlib

from portbench.trace import CALL, DEVICE_CATS, _merge

__all__ = ["OUTSIDE", "PREFIXES", "Program", "reduce"]

PREFIXES = ("api.", "layout.", "launch.")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside the port"


@dataclasses.dataclass
class Program:
    """The port's spans in one traced window (times in seconds)."""

    calls: int  # profiled calls in the window
    host_s: dict  # span name -> host seconds inside its spans (inclusive)
    ops: list  # (op name, seconds, span that launched it or OUTSIDE, how: "correlation",
    #            "order" or None) of each device op that starts in the window
    idle_s: dict  # innermost span of the port's the host was in, or OUTSIDE -> idle seconds

    def host_in(self, prefix: str) -> float:
        """Host seconds in the spans whose names start with ``prefix``."""
        return sum(s for name, s in self.host_s.items() if name.startswith(prefix))

    def device_in(self, prefix: str) -> float:
        """Device seconds of the ops launched in spans named ``prefix...``."""
        return sum(d for _, d, span, _ in self.ops if span.startswith(prefix))

    def idle_in_port(self) -> float:
        """Idle seconds while the host was in one of the port's spans."""
        return sum(s for name, s in self.idle_s.items() if name != OUTSIDE)


def _pieces(spans):
    """The thread's time inside ``spans`` (``(name, start, end)``, nested as
    one thread's are) cut at every edge: sorted ``(start, end, index of the
    innermost span)``."""
    edges = []
    for k, (_, a, b) in enumerate(spans):
        # at one instant: ends before starts, the outer span opening first
        edges += [(a, 1, a - b, k), (b, 0, b - a, k)]
    edges.sort()
    pieces, stack, t_prev = [], [], None
    for t, starts, _, k in edges:
        if stack and t > t_prev:
            pieces.append((t_prev, t, stack[-1]))
        if starts:
            stack.append(k)
        else:
            stack.remove(k)
        t_prev = t
    return pieces


def _innermost(pieces, starts, t: float) -> int | None:
    i = bisect.bisect_right(starts, t) - 1
    return pieces[i][2] if i >= 0 and t < pieces[i][1] else None


def _attribute(gaps, pieces, spans) -> dict:
    """Seconds of the idle ``gaps`` (sorted ``(start, end)``, µs) by the
    innermost span the host was in during each part of them."""
    out: dict = {}
    k = 0
    for g0, g1 in gaps:
        while k < len(pieces) and pieces[k][1] <= g0:
            k += 1
        j, covered = k, 0.0
        while j < len(pieces) and pieces[j][0] < g1:
            a, b = max(g0, pieces[j][0]), min(g1, pieces[j][1])
            if b > a:
                name = spans[pieces[j][2]][0]
                out[name] = out.get(name, 0.0) + (b - a) * 1e-6
                covered += b - a
            j += 1
        if g1 - g0 > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (g1 - g0 - covered) * 1e-6
    return out


def _span_of(e) -> tuple:
    return e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])


def reduce(trace) -> Program | None:
    """Reduce a Chrome trace (a path or its parsed dict) to the port's
    spans; None where it holds no profiled call."""
    if not isinstance(trace, dict):
        trace = json.loads(pathlib.Path(trace).read_text())
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    calls = sorted(_span_of(e) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == CALL)
    if not calls:
        return None
    w0, w1 = calls[0][1], max(b for _, _, b in calls)
    tid = next(e.get("tid") for e in events
               if e.get("cat") == "user_annotation" and e.get("name") == CALL)
    spans = [_span_of(e) for e in events
             if e.get("cat") == "user_annotation" and e.get("tid") == tid
             and str(e.get("name", "")).startswith(PREFIXES)]
    pieces = _pieces(spans)
    starts = [p[0] for p in pieces]
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in LAUNCH_CATS and e.get("tid") == tid
                 and "correlation" in e.get("args", {})}
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) < w1),
                 key=lambda e: float(e["ts"]))

    ops, claimed, unmatched = [], set(), []
    for e in dev:
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        k = None if t is None else _innermost(pieces, starts, t)
        ops.append([e["name"], float(e["dur"]) * 1e-6, OUTSIDE if k is None else spans[k][0],
                    None if t is None else "correlation"])
        if t is None and e["cat"] == "kernel":
            unmatched.append((float(e["ts"]), len(ops) - 1))
        claimed.add(k)
    for _, c0, c1 in calls:
        free = sorted((a, name) for k, (name, a, b) in enumerate(spans)
                      if name.startswith("launch.") and k not in claimed and c0 <= a < c1)
        mine = [i for ts, i in unmatched if c0 <= ts < c1]
        for (_, name), i in zip(free, mine):
            ops[i][2:] = [name, "order"]

    host: dict = {}
    for name, a, b in spans:
        if min(b, w1) > max(a, w0):
            host[name] = host.get(name, 0.0) + (min(b, w1) - max(a, w0)) * 1e-6
    busy = _merge((float(e["ts"]), min(w1, float(e["ts"]) + float(e["dur"]))) for e in dev)
    idle, edge = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)
    return Program(calls=len(calls), host_s=host, ops=[tuple(o) for o in ops],
                   idle_s=_attribute(idle, pieces, spans))
