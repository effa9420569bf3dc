"""One run of one cell: set-up, the measured window, the traced part of it,
and the judgement of the sampled answers.

The loop is closed: one client, one call in flight. The traffic's ``entry``
says what a call is, on the next tensor of a pool made on the device from the
seed:

- ``blur_u8`` (the default): ``blur_u8(frames, sigma, engine=...)`` on uint8
  ``(B, H, W, C)`` frames;
- ``blur``: ``y = blur(planes, sigma, engine=...)`` on float32 ``(B, C, H, W)``
  planes and, with ``"backward": true``, ``torch.autograd.grad(y, planes, g)``
  with a cotangent ``g`` of the pool's, in the same call.

The client waits for its result (``torch.cuda.synchronize()``) before it
sends the next. Set-up loads the built library, makes the pool and makes the
warm-up calls at the cell's own shape; nothing else.

A reservoir drawn from the seed keeps a few of the window's answers alive
(their bytes are taken off the window's peak for ``peak_mem_gib``). Once the
window has closed and its peak has been read, the plain reference
(``reference.py``) judges each kept answer against the exact blur (and
adjoint) of the input that produced it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import pathlib
import random
import shutil
import statistics
import tempfile
import time

import torch

from portbench import frames as frames_mod
from portbench import program_trace, reference, trace as trace_mod
from portbench.manifest import Cell, Manifest

__all__ = ["ENTRIES", "Call", "Context", "Window", "entry_name", "make_entry", "p95",
           "port_function", "run_cell", "sigma_of"]

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "blur_algorithms_tpu_torch" / "csrc"


@dataclasses.dataclass
class Call:
    t_enter: float  # host clock, seconds
    t_return: float  # the entry (and, with a backward, the gradient) returned
    t_done: float  # the synchronize returned
    ok: bool
    profiled: bool = False


@dataclasses.dataclass
class Window:
    calls: list
    t_start: float
    t_end: float  # the last call's completion
    peak_bytes: int  # the process's peak over the window
    setup_s: float
    kept_bytes: int = 0  # of it, the answers the reservoir kept for the judgement

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass
class Context:
    """What a metric reader takes: the cell, its window, the reduced trace of
    its traced part and the port's spans in it (both None in a run without
    ``--trace 1``)."""

    cell: Cell
    sigma: float
    window: Window
    trace: trace_mod.Trace | None
    program: program_trace.Program | None = None

    @property
    def pixels_per_call(self) -> int:
        c = self.cell.config
        return c["batch"] * c["height"] * c["width"]

    @property
    def values_per_call(self) -> int:
        return self.pixels_per_call * self.cell.config["channels"]


def sigma_of(traffic: dict, config: dict) -> float:
    """The traffic's sigma: a number, or the upstream rule sigma = sqrt of
    the frame's width (``sqrt_width``; the upstream benchmark's sqrt(x) on
    frames x wide and y high)."""
    if "sigma" in traffic:
        return float(traffic["sigma"])
    rule = traffic["sigma_rule"]
    if rule == "sqrt_width":
        return math.sqrt(config["width"])
    raise ValueError(f"unknown sigma rule {rule!r}")


def p95(values) -> float:
    """The 95th percentile, interpolated between order statistics."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _Reservoir:
    """Keeps ``k`` of the window's answers, drawn uniformly by a seeded
    generator (reservoir sampling)."""

    def __init__(self, k: int, seed: int) -> None:
        self.k, self.rng, self.kept, self.seen = k, random.Random(seed), [], 0

    def offer(self, index: int, out) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((index, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = (index, out)


class _U8Entry:
    """``blur_u8`` on a pool of uint8 ``(B, H, W, C)`` frames."""

    def __init__(self, cell: Cell, sigma: float, engine: str, seed: int, device, fn) -> None:
        cfg = cell.config
        self.sigma, self.engine, self.fn = sigma, engine, fn
        self.pool = [frames_mod.make_frames(device, cfg["batch"], cfg["height"], cfg["width"],
                                            cfg["channels"], frames_mod.frame_seed(seed, k))
                     for k in range(int(cell.traffic["pool"]))]

    def call(self, i: int):
        return self.fn(self.pool[i % len(self.pool)], self.sigma, engine=self.engine)

    @staticmethod
    def kept_bytes(out) -> int:
        return _allocated_bytes(out)

    def judge(self, kept) -> tuple[int, dict]:
        """The values judged and the numbers of the kept ``(index, answer)``."""
        h, w = self.pool[0].shape[1:3]
        ops = reference.Operators(h, w, self.sigma, self.pool[0].device)
        judgement = reference.Judgement()
        for index, out in kept:
            reference.judge(out, self.pool[index % len(self.pool)], self.sigma, judgement, ops)
        return judgement.values, judgement.numbers()


class _FloatEntry:
    """``blur`` on a pool of float32 ``(B, C, H, W)`` planes; with a
    backward, each pool tensor has a cotangent of its own, and the answer of
    a call is ``(y, gx)``, else ``(y,)``."""

    def __init__(self, cell: Cell, sigma: float, engine: str, seed: int, device, fn) -> None:
        cfg = cell.config
        if cfg.get("layout") != "BCHW" or cfg.get("dtype") != "float32":
            raise ValueError("the blur entry takes a float32 BCHW configuration")
        self.sigma, self.engine, self.fn = sigma, engine, fn
        self.backward = bool(cell.traffic.get("backward", False))
        shape = (cfg["batch"], cfg["channels"], cfg["height"], cfg["width"])
        n = int(cell.traffic["pool"])
        self.pool = [frames_mod.make_planes(device, shape[0], shape[2], shape[3], shape[1],
                                            frames_mod.frame_seed(seed, k)) for k in range(n)]
        self.cotangents = [frames_mod.make_cotangent(device, shape,
                                                     frames_mod.frame_seed(seed, _COT + k))
                           for k in range(n)] if self.backward else [None] * n
        if self.backward:
            for x in self.pool:
                x.requires_grad_(True)

    def call(self, i: int):
        k = i % len(self.pool)
        x = self.pool[k]
        y = self.fn(x, self.sigma, engine=self.engine)
        if not self.backward:
            return (y,)
        (gx,) = torch.autograd.grad(y, x, self.cotangents[k])
        return (y.detach(), gx)

    @staticmethod
    def kept_bytes(answer) -> int:
        return sum(_allocated_bytes(t) for t in answer)

    def judge(self, kept) -> tuple[int, dict]:
        h, w = self.pool[0].shape[-2:]
        ops = reference.Operators(h, w, self.sigma, self.pool[0].device)
        judgement = reference.FloatJudgement(self.backward)
        for index, answer in kept:
            k = index % len(self.pool)
            reference.judge_float(answer, self.pool[k].detach(), self.cotangents[k], self.sigma,
                                  judgement, ops)
        return judgement.values, judgement.numbers()


# the traffic's entry (the port's function of that name) -> its pool and call
ENTRIES = {"blur_u8": _U8Entry, "blur": _FloatEntry}
# the cotangents' generator seeds: frame_seed(seed, _COT + k), apart from the pool's
_COT = 1 << 21


def entry_name(traffic: dict) -> str:
    name = traffic.get("entry", "blur_u8")
    if name not in ENTRIES:
        raise ValueError(f"unknown entry {name!r}: the harness drives {', '.join(ENTRIES)}")
    return name


def make_entry(cell: Cell, seed: int, device, fn=None):
    """The cell's entry with its pool made from ``seed`` on ``device``;
    ``fn`` in the port's function's place (the port's where None)."""
    name = entry_name(cell.traffic)
    return ENTRIES[name](cell, sigma_of(cell.traffic, cell.config),
                         cell.traffic.get("engine", "auto"), seed, device,
                         fn or port_function(name, torch.device(device).type == "cuda"))


def port_function(name: str, on_cuda: bool):
    """The port's public function ``name``, its library loaded first on a
    CUDA device."""
    if on_cuda:
        from blur_algorithms_tpu_torch.utils import build

        build.load_library()
    from blur_algorithms_tpu_torch import api

    return getattr(api, name)


def run_cell(manifest: Manifest, cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_process_start: float, fn=None) -> tuple[dict, list]:
    """Run ``cell`` once, with ``fn`` in the place of the port's function
    that the traffic's entry names, where given. Returns the result (without
    the ``checks`` key) and the numbers compared as ``(name, value, limit,
    passed)``."""
    traffic = cell.traffic
    sigma = sigma_of(traffic, cell.config)
    on_cuda = torch.device(device).type == "cuda"
    if traffic.get("loop", "closed") != "closed" or int(traffic.get("clients", 1)) != 1:
        raise ValueError("this harness drives a closed loop of one client")
    parts = {}  # where set-up goes, in seconds (reported beside the metrics)
    t_part = time.perf_counter()
    fn = fn or port_function(entry_name(traffic), on_cuda)
    parts["library_s"] = time.perf_counter() - t_part

    t_part = time.perf_counter()
    entry = make_entry(cell, seed, device, fn)
    _sync(device)
    parts["pool_s"] = time.perf_counter() - t_part  # the first device work: CUDA's context too
    warm_s = []
    for k in range(int(traffic["warmup_calls"])):
        t0 = time.perf_counter()
        out = entry.call(k)
        _sync(device)
        warm_s.append(time.perf_counter() - t0)
    del out
    parts["warmup_s"] = sum(warm_s)
    parts["warmup_calls_s"] = warm_s

    reservoir = _Reservoir(int(traffic["samples"]), frames_mod.frame_seed(seed, 1 << 20))
    trace_dir = tempfile.mkdtemp(prefix="portbench-trace-") if trace else None
    chrome = []
    prof = None
    steps = 0
    active = max(3, min(200, math.ceil(float(traffic["trace_seconds"]) / max(warm_s[-1], 1e-6))))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    calls, failed = [], 0
    try:
        if on_cuda:
            torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
        setup_s = t_start - t_process_start
        t_stop = t_start + seconds
        t_prof = t_start + seconds * float(traffic.get("trace_start", 1 / 3))
        i = 0
        while True:
            if trace and prof is None and steps == 0 and time.perf_counter() >= t_prof:
                prof = torch.profiler.profile(activities=acts)
                prof.__enter__()
            profiled = prof is not None
            # the first profiled call warms the profiler up and carries no
            # span: the traced window starts at the second
            span = torch.profiler.record_function if profiled and steps else _no_span
            t0 = time.perf_counter()
            ok, out = True, None
            with span(trace_mod.CALL):
                try:
                    with span(trace_mod.BLUR):
                        out = entry.call(i)
                    t1 = time.perf_counter()
                    with span(trace_mod.SYNC):
                        _sync(device)
                except (RuntimeError, ValueError, TypeError, NotImplementedError):
                    ok, out, t1 = False, None, time.perf_counter()
                    failed += 1
            t2 = time.perf_counter()
            calls.append(Call(t0, t1, t2, ok, profiled))
            if ok:
                reservoir.offer(i, out)
            del out
            if profiled:
                steps += 1
                if steps == active + 1:
                    chrome.append(_stop(prof, trace_dir))
                    prof = None
            i += 1
            # a traced run goes on until its profile is whole
            if t2 >= t_stop and (not trace or steps == active + 1):
                break
        peak = torch.cuda.max_memory_allocated() if on_cuda else 0
        window = Window(calls, t_start, calls[-1].t_done, peak, setup_s,
                        sum(entry.kept_bytes(out) for _, out in reservoir.kept))
        reduced = program = None
        if chrome:
            pattern = trace_mod.port_kernel_pattern(trace_mod.kernel_names(CSRC))
            reduced = trace_mod.reduce_chrome(chrome[0], pattern)
            program = program_trace.reduce(chrome[0])
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        if trace_dir:
            shutil.rmtree(trace_dir, ignore_errors=True)

    ctx = Context(cell, sigma, window, reduced, program)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the judgement, once the window's peak is read: the program's working
    # memory is freed first, the kept answers and their inputs stay
    if on_cuda:
        torch.cuda.empty_cache()
    values, numbers = entry.judge(reservoir.kept)
    compared = [(name, numbers[name], float(c["limit"]), numbers[name] <= float(c["limit"]))
                for name, c in cell.checks.items()]
    compared.append(("failed_calls", failed, 0, failed == 0))
    result = {
        "correct": all(c[3] for c in compared),
        "attempted": len(calls),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_cuda else "cpu", "count": cell.chips,
                   "memory_peak_bytes": int(window.peak_bytes)},
        "judged": {"calls": len(reservoir.kept), "values": values, "sigma": sigma, **numbers},
        "setup_parts": parts,
    }
    if trace:
        result["device"]["busy_s"] = reduced.busy_s if reduced else 0.0
        result["device"]["window_s"] = reduced.window_s if reduced else 0.0
        if reduced:
            result["breakdown"] = {"device_ops": reduced.top_device_ops(),
                                   "idle_gaps": reduced.top_gaps()}
    return result, compared


def _allocated_bytes(t: torch.Tensor) -> int:
    """The bytes the CUDA caching allocator counts for ``t``'s storage: its
    size rounded up to the allocator's 512-byte blocks."""
    return -(-t.untyped_storage().nbytes() // 512) * 512


@contextlib.contextmanager
def _no_span(_name):
    yield


def _stop(prof, trace_dir: str) -> pathlib.Path:
    """End the profile and write its Chrome trace under ``trace_dir``."""
    prof.__exit__(None, None, None)
    path = pathlib.Path(trace_dir) / "window.json"
    prof.export_chrome_trace(str(path))
    return path
