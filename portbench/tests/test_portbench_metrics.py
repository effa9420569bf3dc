"""The metric readers' arithmetic on a synthetic window and trace, and the
reduction of a Chrome trace."""

from __future__ import annotations

import dataclasses
import pathlib
import statistics

import pytest

from portbench import harness, manifest as manifest_mod, peaks, trace as trace_mod

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


def _ctx(window, trace=None):
    return harness.Context(CELL, 10.0, window, trace)


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
