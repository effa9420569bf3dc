"""The reduction of the port's spans in a traced window
(``portbench/program_trace.py``) and the readers of its metrics, on
Chrome traces built by hand."""

import importlib.util
import pathlib
import types

import pytest

from blur_algorithms_tpu_torch.utils import trace as port_trace
from portbench import program_trace, trace as bench_trace
from portbench.program_trace import OUTSIDE

ROOT = pathlib.Path(__file__).resolve().parent.parent
METRICS = ("route_ms_per_call", "launch_host_ms_per_call", "layout_device_ms_per_call",
           "program_idle_ms_per_call", "port_kernels_bytes_pct")
TID = 7


def _x(cat, name, ts, dur, tid=TID, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _call(t0, correlate=True):
    """One profiled call at ``t0`` (µs), as the port on the card traces it:
    the benchmark's spans, the port's, the runtime's launch calls and the
    device ops (copy, K1, copy), with the launch events' correlations where
    ``correlate`` and none for K1 where it is not."""
    c = t0 // 100  # one correlation range a call
    kernel_args = {"correlation": 10 * c + 2} if correlate else {}
    return [
        _x("user_annotation", bench_trace.CALL, t0, 95),
        _x("user_annotation", bench_trace.BLUR, t0 + 1, 50),
        _x("user_annotation", "api.blur_u8", t0 + 2, 48),
        _x("user_annotation", "api.route", t0 + 3, 7),
        _x("user_annotation", "layout.to_planar", t0 + 10, 10),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 15, 2, correlation=10 * c + 1),
        _x("user_annotation", "launch.blur_fused_u8_k1", t0 + 20, 20),
        _x("cuda_driver", "cuLaunchKernelEx", t0 + 35, 2, correlation=10 * c + 2),
        _x("user_annotation", "layout.from_planar", t0 + 40, 8),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 45, 2, correlation=10 * c + 3),
        _x("kernel", "elementwise_copy", t0 + 16, 10, tid=0, correlation=10 * c + 1),
        _x("kernel", "k1_direct<1, true>", t0 + 36, 30, tid=0, **kernel_args),
        _x("kernel", "elementwise_copy", t0 + 66, 20, tid=0, correlation=10 * c + 3),
    ]


def _trace(*calls):
    return {"traceEvents": [e for t0, correlate in calls for e in _call(t0, correlate)]}


def test_ops_go_to_the_span_of_their_launch_by_correlation():
    program = program_trace.reduce(_trace((1000, True), (1100, True)))
    assert program.calls == 2
    assert [(op[2], op[3]) for op in program.ops[:3]] == [
        ("layout.to_planar", "correlation"), ("launch.blur_fused_u8_k1", "correlation"),
        ("layout.from_planar", "correlation")]
    assert program.device_in("layout.") == pytest.approx(2 * 30e-6)
    assert program.device_in("launch.") == pytest.approx(2 * 30e-6)
    assert program.host_in("api.route") == pytest.approx(2 * 7e-6)
    assert program.host_in("launch.") == pytest.approx(2 * 20e-6)


def test_a_kernel_without_a_launch_event_goes_by_launch_order():
    program = program_trace.reduce(_trace((1000, False), (1100, True), (1200, False)))
    k1 = [op for op in program.ops if op[0].startswith("k1_direct")]
    assert [(op[2], op[3]) for op in k1] == [("launch.blur_fused_u8_k1", "order"),
                                            ("launch.blur_fused_u8_k1", "correlation"),
                                            ("launch.blur_fused_u8_k1", "order")]
    # a PyTorch op without a launch event is the port's by no rule
    events = _trace((1000, True))
    events["traceEvents"].append(_x("gpu_memset", "Memset", 1090, 1, tid=0))
    assert program_trace.reduce(events).ops[-1][2:] == (OUTSIDE, None)


def test_idle_goes_to_the_innermost_span_the_host_was_in():
    program = program_trace.reduce(_trace((1000, True)))
    # the window 1000-1095; the device busy 1016-1026 and 1036-1086; the host
    # in api.blur_u8 1002-1050, and inside it route 1003-1010, to_planar
    # 1010-1020, K1's launch 1020-1040, from_planar 1040-1048
    want = {OUTSIDE: 2e-6 + 9e-6, "api.blur_u8": 1e-6, "api.route": 7e-6,
            "layout.to_planar": 6e-6, "launch.blur_fused_u8_k1": 10e-6}
    assert program.idle_s.keys() == want.keys()
    for name, s in want.items():
        assert program.idle_s[name] == pytest.approx(s), name
    assert program.idle_in_port() == pytest.approx(24e-6)


def test_the_window_runs_from_the_first_to_the_last_call():
    events = _trace((1000, True), (1100, True))
    # the profiler's first call carries the port's spans but no benchmark span
    events["traceEvents"] += [
        _x("user_annotation", "api.blur_u8", 900, 48),
        _x("user_annotation", "api.route", 901, 7),
        _x("user_annotation", "launch.blur_fused_u8_k1", 1190, 20),  # past the window's end
        _x("kernel", "k1_direct<1, true>", 960, 30, tid=0),
        _x("kernel", "k1_direct<1, true>", 1195, 30, tid=0),
    ]
    program = program_trace.reduce(events)
    assert program.calls == 2
    assert len(program.ops) == 6
    assert program.host_in("api.route") == pytest.approx(2 * 7e-6)
    assert program.host_in("launch.") == pytest.approx(2 * 20e-6 + 5e-6)  # 1190-1195


def test_a_trace_without_calls_reduces_to_none():
    assert program_trace.reduce({"traceEvents": []}) is None
    assert program_trace.reduce({"traceEvents": _call(1000)[1:]}) is None


def test_the_existing_reduction_reads_alike_with_and_without_the_port_spans():
    pattern = bench_trace.port_kernel_pattern({"k1_direct"})
    with_spans = _trace((1000, True), (1100, False))
    without = {"traceEvents": [e for e in with_spans["traceEvents"]
                               if not e["name"].startswith(program_trace.PREFIXES)]}
    assert len(without["traceEvents"]) < len(with_spans["traceEvents"])
    assert bench_trace.reduce_chrome(with_spans, pattern) == \
        bench_trace.reduce_chrome(without, pattern)
    assert program_trace.reduce(without).idle_s.keys() == {OUTSIDE}


def _reader(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("name", METRICS)
def test_the_readers_find_nothing_without_a_trace(name):
    assert _reader(name)(types.SimpleNamespace(trace=None)) is None


def test_the_span_readers_on_a_hand_built_trace():
    ctx = types.SimpleNamespace(program=program_trace.reduce(_trace((1000, True), (1100, True))))
    assert _reader("route_ms_per_call")(ctx) == pytest.approx(7e-3)
    assert _reader("launch_host_ms_per_call")(ctx) == pytest.approx(20e-3)
    assert _reader("layout_device_ms_per_call")(ctx) == pytest.approx(30e-3)
    assert _reader("program_idle_ms_per_call")(ctx) == pytest.approx(24e-3)


def test_port_bytes_share_reads_the_counters_over_the_port_kernels():
    port_trace.reset_counters()
    try:
        def wrapper():
            pass

        wrapper.launches = 0
        # 4 calls of one launch each: 3.35 GB a call is 1 ms at 3.35 TB/s
        for _ in range(4):
            port_trace.launched(wrapper, "blur_fused_u8_k1", int(3.35e9))
        reduced = bench_trace.Trace(calls=2, window_s=0.01, busy_s=0.008,
                                    kernels=[("k1_direct<1, true>", 4e-3)] * 2, others=[],
                                    port_pattern=bench_trace.port_kernel_pattern({"k1_direct"}),
                                    gaps={})
        ctx = types.SimpleNamespace(trace=reduced, cell=types.SimpleNamespace(
            traffic={"warmup_calls": 2}), window=types.SimpleNamespace(calls=[None, None]))
        assert _reader("port_kernels_bytes_pct")(ctx) == pytest.approx(25.0)
        port_trace.reset_counters()
        assert _reader("port_kernels_bytes_pct")(ctx) is None  # no bytes counted
    finally:
        port_trace.reset_counters()
