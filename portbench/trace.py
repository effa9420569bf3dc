"""The traced window: a ``torch.profiler`` Chrome trace reduced to what the
per-layer readers take.

The window runs from the start of the first profiled call's
``portbench.call`` span to the end of the last one's. Device time is the
union of the kernels, copies and sets that start in it. A kernel is the
port's own when its name holds, as a whole word, a ``__global__`` function
name of ``blur_algorithms_tpu_torch/csrc/*.cu``, read from the sources when
the run starts, so a renamed or new kernel is counted with no edit here.
Each idle gap is split by what the host was doing during it: the
benchmark's host span (``blur_u8``, ``sync`` or ``between calls``) and,
inside ``blur_u8``, the innermost PyTorch operation it was running.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re

__all__ = ["DEVICE_CATS", "Trace", "is_port_kernel", "kernel_names", "port_kernel_pattern",
           "reduce_chrome"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# BLUR spans the timed call whatever the traffic's entry (``blur_u8``, or
# ``blur`` and its backward); the name, and the breakdown's "blur_u8", stay
# as the first entry gave them, so that breakdowns compare across PRs
CALL, BLUR, SYNC = "portbench.call", "portbench.blur_u8", "portbench.sync"
_LAUNCH_BOUNDS = re.compile(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)")
_IDENT_CALL = re.compile(r"([A-Za-z_]\w*)\s*\(")


def kernel_names(csrc: pathlib.Path) -> set[str]:
    """The ``__global__`` function names of every ``*.cu`` under ``csrc``
    (top level: the kernels the package's library holds)."""
    names = set()
    for src in sorted(pathlib.Path(csrc).glob("*.cu")):
        text = src.read_text()
        for part in text.split("__global__")[1:]:
            head = _LAUNCH_BOUNDS.sub(" ", part.split("{", 1)[0].split(";", 1)[0])
            m = _IDENT_CALL.search(head)
            if m:
                names.add(m.group(1))
    return names


def port_kernel_pattern(names) -> re.Pattern | None:
    if not names:
        return None
    return re.compile(r"\b(?:" + "|".join(sorted(map(re.escape, names))) + r")\b")


def is_port_kernel(name: str, pattern: re.Pattern | None) -> bool:
    return bool(pattern and pattern.search(name))


@dataclasses.dataclass
class Trace:
    """What the readers take from one traced window (times in seconds)."""

    calls: int  # profiled calls in the window
    window_s: float
    busy_s: float  # union of device activity in the window
    kernels: list  # (name, seconds) of each kernel launch in the window
    others: list  # (name, seconds) of each copy and set in the window
    port_pattern: re.Pattern | None
    gaps: dict  # host context -> idle seconds

    def port_kernel_s(self) -> float:
        return sum(d for n, d in self.kernels if is_port_kernel(n, self.port_pattern))

    def torch_device_s(self) -> float:
        """Device time of every operation that is not one of the port's own
        kernels: PyTorch's kernels, copies and sets, cuFFT."""
        return (sum(d for n, d in self.kernels if not is_port_kernel(n, self.port_pattern))
                + sum(d for _, d in self.others))

    def top_device_ops(self, k: int = 10) -> list:
        total: dict = {}
        for n, d in self.kernels + self.others:
            total[n] = total.get(n, 0.0) + d
        return sorted(([n, s] for n, s in total.items()), key=lambda e: -e[1])[:k]

    def top_gaps(self, k: int = 10) -> list:
        return sorted(([n, s] for n, s in self.gaps.items()), key=lambda e: -e[1])[:k]


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _host_pieces(spans, ops):
    """The window cut at every host span and operation edge: ``(start, end,
    what the host was doing)``, in time order. Operations on one thread
    nest, so the innermost is the latest started of those still open."""
    edges = []
    for k, (_, a, b) in enumerate(spans):
        edges += [(a, 1, "span", k), (b, 0, "span", k)]
    for k, (_, a, b) in enumerate(ops):
        edges += [(a, 1, "op", k), (b, 0, "op", k)]
    edges.sort()
    open_span, open_ops, pieces = None, [], []
    t_prev = None
    for t, starts, kind, k in edges:
        if t_prev is not None and t > t_prev:
            pieces.append((t_prev, t, _context(open_span, open_ops, spans, ops)))
        if kind == "span":
            open_span = k if starts else (None if open_span == k else open_span)
        elif starts:
            open_ops.append(k)
        else:
            for i in range(len(open_ops) - 1, -1, -1):
                if open_ops[i] == k:
                    del open_ops[i]
                    break
        t_prev = t
    return pieces


def _context(open_span, open_ops, spans, ops) -> str:
    if open_span is None:
        return "between calls"
    if spans[open_span][0] != BLUR:
        return "sync"
    return f"blur_u8/{ops[open_ops[-1]][0]}" if open_ops else "blur_u8"


def _attribute(gaps_us, pieces) -> dict:
    """Seconds of the idle gaps ``gaps_us`` (sorted ``(start, end)``) by
    what the host was doing during each part of them."""
    out: dict = {}
    k = 0
    for g0, g1 in gaps_us:
        while k < len(pieces) and pieces[k][1] <= g0:
            k += 1
        j, covered = k, 0.0
        while j < len(pieces) and pieces[j][0] < g1:
            a, b = max(g0, pieces[j][0]), min(g1, pieces[j][1])
            if b > a:
                out[pieces[j][2]] = out.get(pieces[j][2], 0.0) + (b - a) * 1e-6
                covered += b - a
            j += 1
        if g1 - g0 > covered:
            out["between calls"] = out.get("between calls", 0.0) + (g1 - g0 - covered) * 1e-6
    return out


def reduce_chrome(trace, port_pattern: re.Pattern | None) -> Trace | None:
    """Reduce a Chrome trace (a path or its parsed dict) to a ``Trace``;
    None where it holds no profiled call."""
    if not isinstance(trace, dict):
        trace = json.loads(pathlib.Path(trace).read_text())
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    calls = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == CALL]
    if not calls:
        return None
    w0 = min(float(e["ts"]) for e in calls)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in calls)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) < w1]
    tid = calls[0].get("tid")
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in (BLUR, SYNC)
             and e.get("tid") == tid]
    ops = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("cat") == "cpu_op" and e.get("tid") == tid]
    busy = _merge((float(e["ts"]), min(w1, float(e["ts"]) + float(e["dur"]))) for e in dev)
    idle, edge = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)
    gaps = _attribute(idle, _host_pieces(spans, ops))
    return Trace(
        calls=len(calls),
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        kernels=[(e["name"], float(e["dur"]) * 1e-6) for e in dev if e["cat"] == "kernel"],
        others=[(e["name"], float(e["dur"]) * 1e-6) for e in dev if e["cat"] != "kernel"],
        port_pattern=port_pattern,
        gaps=gaps,
    )
