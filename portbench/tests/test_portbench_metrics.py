"""The metric readers' arithmetic on a synthetic window and trace, the
reduction of a Chrome trace, and the port's spans reaching their readers."""

from __future__ import annotations

import dataclasses
import pathlib
import statistics

import pytest

from portbench import harness, manifest as manifest_mod, peaks, program_trace
from portbench import trace as trace_mod

ROOT = pathlib.Path(__file__).resolve().parents[2]
MAN = manifest_mod.load()
CELL = MAN.cell("rgb4k-b32-s10")
K1 = "void (anonymous namespace)::k1_direct<1, true>((anonymous namespace)::K1Params)"
COPY = "void at::native::elementwise_kernel<128, 4, direct_copy_kernel_cuda>(int)"


def _window(times_ms, setup_s=9.0, peak=5 * 2**30, kept=0):
    calls, t = [], 100.0
    for ms in times_ms:
        calls.append(harness.Call(t, t + 0.0004, t + ms / 1e3, True))
        t += ms / 1e3
    return harness.Window(calls, calls[0].t_enter, calls[-1].t_done, peak, setup_s, kept)


def _ctx(window, trace=None, cell=CELL, program=None):
    return harness.Context(cell, 10.0, window, trace, program)


def test_mp_per_s_counts_every_call_over_the_window():
    w = _window([7.0] * 100)
    px = 32 * 2160 * 3840
    assert MAN.reader("mp_per_s")(_ctx(w)) == pytest.approx(100 * px / 1e6 / 0.7)


def test_call_ms_p95_over_every_call():
    times = [5.0 + 0.01 * k for k in range(200)]
    w = _window(times)
    got = MAN.reader("call_ms_p95")(_ctx(w))
    assert got == pytest.approx(statistics.quantiles(times, n=100, method="inclusive")[94])
    assert times[188] <= got <= times[190]


def test_peak_and_setup():
    w = _window([7.0] * 3, setup_s=8.5, peak=3 * 2**30)
    assert MAN.reader("peak_mem_gib")(_ctx(w)) == pytest.approx(3.0)
    assert MAN.reader("setup_s")(_ctx(w)) == 8.5
    # the answers kept for the judgement are the benchmark's, not the program's
    w = _window([7.0] * 3, peak=3 * 2**30, kept=2**29)
    assert MAN.reader("peak_mem_gib")(_ctx(w)) == pytest.approx(2.5)


def test_kept_bytes_follow_the_allocator_blocks():
    import torch

    assert harness._allocated_bytes(torch.empty(1000, dtype=torch.uint8)) == 1024
    assert harness._allocated_bytes(torch.empty(512, dtype=torch.uint8)) == 512


def test_sigma_rules():
    assert harness.sigma_of({"sigma": 10}, {"width": 3840}) == 10.0
    # the upstream's sqrt(x) takes the frame's width, whichever side is longer
    assert harness.sigma_of({"sigma_rule": "sqrt_width"},
                            {"height": 14500, "width": 24000}) == pytest.approx(154.9193338)
    assert harness.sigma_of({"sigma_rule": "sqrt_width"},
                            {"height": 4000, "width": 900}) == pytest.approx(30.0)
    with pytest.raises(ValueError):
        harness.sigma_of({"sigma_rule": "sqrt_long_side"}, {"height": 1, "width": 1})


def _chrome():
    """Two profiled calls of 7 ms (us): each a 1 ms host part with three
    kernels, then the sync; 0.5 ms of idle device at each call's start."""
    ev = []
    for k, t in enumerate((0.0, 7000.0)):
        ev += [
            {"ph": "X", "cat": "user_annotation", "name": trace_mod.CALL, "ts": t, "dur": 7000.0,
             "tid": 1},
            {"ph": "X", "cat": "user_annotation", "name": trace_mod.BLUR, "ts": t, "dur": 600.0,
             "tid": 1},
            {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": t + 100, "dur": 300.0,
             "tid": 1},
            {"ph": "X", "cat": "user_annotation", "name": trace_mod.SYNC, "ts": t + 600,
             "dur": 6400.0, "tid": 1},
            {"ph": "X", "cat": "kernel", "name": COPY, "ts": t + 500, "dur": 2000.0},
            {"ph": "X", "cat": "kernel", "name": K1, "ts": t + 2500, "dur": 2500.0},
            {"ph": "X", "cat": "kernel", "name": COPY, "ts": t + 5000, "dur": 2000.0},
        ]
    ev.append({"ph": "X", "cat": "kernel", "name": K1, "ts": 20000.0, "dur": 10.0})  # outside
    return {"traceEvents": ev}


def _trace():
    pattern = trace_mod.port_kernel_pattern({"k1_direct", "k1_strip"})
    return trace_mod.reduce_chrome(_chrome(), pattern)


def test_trace_reduction():
    t = _trace()
    assert t.calls == 2
    assert t.window_s == pytest.approx(0.014)
    assert t.busy_s == pytest.approx(0.013)
    assert len(t.kernels) == 6
    assert t.port_kernel_s() == pytest.approx(0.005)
    assert t.torch_device_s() == pytest.approx(0.008)
    # idle 0..500 us of each call: 100 us in blur_u8, 300 in its copy_, 100 after it
    assert t.gaps == pytest.approx({"blur_u8": 0.0004, "blur_u8/aten::copy_": 0.0006})
    assert t.top_device_ops()[0] == [COPY, pytest.approx(0.008)]


def test_device_readers_on_the_synthetic_trace():
    ctx = _ctx(_window([7.0, 7.0]), _trace())
    assert MAN.reader("device_idle_pct")(ctx) == pytest.approx(100 * (1 - 13 / 14))
    assert MAN.reader("kernels_per_call")(ctx) == pytest.approx(3.0)
    assert MAN.reader("port_kernels_ms_per_call")(ctx) == pytest.approx(2.5)
    assert MAN.reader("torch_kernels_ms_per_call")(ctx) == pytest.approx(4.0)
    least = 2 * 32 * 2160 * 3840 * 3 / peaks.HBM_BYTES_PER_S
    assert MAN.reader("device_bytes_pct")(ctx) == pytest.approx(100 * least / 0.0065)
    assert MAN.reader("host_ms_per_call")(ctx) == pytest.approx(0.4)


def test_device_readers_find_nothing_without_a_trace():
    ctx = _ctx(_window([7.0, 7.0]))
    for m in MAN.data["per_layer"]:
        assert MAN.reader(m["name"])(ctx) is None
    empty = dataclasses.replace(_trace(), kernels=[], others=[], busy_s=0.0)
    for m in MAN.data["per_layer"]:
        if m["source"] == "device_trace":
            assert MAN.reader(m["name"])(_ctx(_window([7.0]), empty)) is None


def test_kernel_names_read_from_the_port_sources():
    names = trace_mod.kernel_names(ROOT / "blur_algorithms_tpu_torch" / "csrc")
    assert {"k1_direct", "split_rows_int8_kernel", "split_cols_hybrid_kernel",
            "fft_conv_rows_cluster_kernel", "box_rows_kernel"} <= names
    assert "__launch_bounds__" not in names and "void" not in names
    pattern = trace_mod.port_kernel_pattern(names)
    assert trace_mod.is_port_kernel(K1, pattern)
    assert not trace_mod.is_port_kernel(COPY, pattern)


def test_device_bytes_of_a_float_cell_count_16_bytes_a_value_with_the_backward():
    cell = MAN.cell("float4k-b4-s10-fwdbwd")
    ctx = _ctx(_window([7.0, 7.0]), _trace(), cell)
    values = 4 * 3 * 2160 * 3840
    assert ctx.pixels_per_call == 4 * 2160 * 3840 and ctx.values_per_call == values
    assert peaks.blur_f32_least_bytes(values, True) == 16 * values
    assert peaks.blur_f32_least_bytes(values, False) == 8 * values
    least = 16 * values / peaks.HBM_BYTES_PER_S
    assert MAN.reader("device_bytes_pct")(ctx) == pytest.approx(100 * least / 0.0065)
    fwd = dataclasses.replace(cell, traffic=dict(cell.traffic, backward=False))
    assert MAN.reader("device_bytes_pct")(_ctx(_window([7.0, 7.0]), _trace(), fwd)) == \
        pytest.approx(50 * least / 0.0065)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": args}


def _port_call(t0, corr):
    """One profiled call as the port traces it since its layout moves are
    kernels: each move's kernel launched in ``launch.layout_*`` inside
    ``layout.*``; then a kernel launched on another thread (a backward)."""
    return [
        _x("user_annotation", trace_mod.CALL, t0, 95),
        _x("user_annotation", trace_mod.BLUR, t0 + 1, 50),
        _x("user_annotation", "api.blur_u8", t0 + 2, 48),
        _x("user_annotation", "api.route", t0 + 3, 7),
        _x("user_annotation", "layout.to_planar", t0 + 10, 10),
        _x("user_annotation", "launch.layout_to_planar_u8", t0 + 11, 8),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 12, 2, correlation=corr),
        _x("user_annotation", "launch.blur_fused_u8_k1", t0 + 20, 20),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 25, 2, correlation=corr + 1),
        _x("user_annotation", "layout.from_planar", t0 + 40, 8),
        _x("user_annotation", "launch.layout_from_planar_u8", t0 + 41, 6),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 42, 2, correlation=corr + 2),
        _x("cuda_runtime", "cudaLaunchKernel", t0 + 60, 2, tid=9, correlation=corr + 3),
        _x("kernel", "layout_u8_groups_kernel<false>", t0 + 14, 10, tid=0, correlation=corr),
        _x("kernel", K1, t0 + 27, 30, tid=0, correlation=corr + 1),
        _x("kernel", "layout_u8_groups_kernel<true>", t0 + 57, 12, tid=0,
           correlation=corr + 2),
        _x("kernel", "gemm_backward", t0 + 70, 20, tid=0, correlation=corr + 3),
    ]


def test_layout_reads_the_layout_kernels_and_a_backward_thread_is_outside():
    program = program_trace.reduce({"traceEvents": _port_call(1000, 10) + _port_call(1100, 20)})
    spans = {op[0]: op[2] for op in program.ops}
    assert spans["layout_u8_groups_kernel<false>"] == "launch.layout_to_planar_u8"
    assert spans["gemm_backward"] == program_trace.OUTSIDE
    assert [op[3] for op in program.ops] == ["correlation"] * 8
    ctx = _ctx(_window([7.0, 7.0]), _trace(), program=program)
    assert MAN.reader("layout_device_ms_per_call")(ctx) == pytest.approx(22e-3)
    assert MAN.reader("route_ms_per_call")(ctx) == pytest.approx(7e-3)
    assert MAN.reader("launch_host_ms_per_call")(ctx) == pytest.approx(34e-3)
    # a call that moves no layout (the float entry) has nothing to read there
    no_layout = {"traceEvents": [e for e in _port_call(1000, 10)
                                 if "layout" not in e["name"]]}
    ctx = _ctx(_window([7.0]), _trace(), program=program_trace.reduce(no_layout))
    assert MAN.reader("layout_device_ms_per_call")(ctx) is None
    assert MAN.reader("route_ms_per_call")(ctx) == pytest.approx(7e-3)


def test_a_traced_run_hands_the_port_spans_to_the_readers(monkeypatch):
    """``run_cell`` reduces the traced window's spans into
    ``Context.program`` before the trace is deleted, and every per-layer
    reader sees it; an untraced run passes None."""
    import time

    import torch

    seen = []
    real = harness.Context

    def spy(*args, **kwargs):
        ctx = real(*args, **kwargs)
        seen.append(ctx)
        return ctx

    monkeypatch.setattr(harness, "Context", spy)
    cell = MAN.cell("rgb4k-b32-s10")
    cell = dataclasses.replace(cell, config=dict(cell.config, batch=1, height=40, width=56),
                               traffic=dict(cell.traffic, trace_seconds=0.02))
    torch.set_num_threads(2)
    for trace in (True, False):
        harness.run_cell(MAN, cell, 3, 0.1, trace, "cpu", time.perf_counter())
    traced, untraced = seen
    assert isinstance(traced.program, program_trace.Program) and traced.program.calls >= 3
    assert traced.program.host_in("api.route") > 0
    assert untraced.program is None and untraced.trace is None
