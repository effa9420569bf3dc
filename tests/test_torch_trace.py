"""The port's spans and launch counters (``utils/trace.py``).

The file imports no jax, so the test marked ``cuda`` also runs on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py -q
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu_torch import blur, blur_u8  # noqa: E402
from blur_algorithms_tpu_torch.utils import trace  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def clean_counters():
    trace.reset_counters()
    yield
    trace.reset_counters()


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))


def _user_spans(prof, tmp_path):
    """The ``record_function`` spans of a finished profile, in time order:
    ``(name, start, end)`` in µs."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                  key=lambda s: s[1])


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    assert trace.span("api.route") is trace.span("launch.blur_fused_u8_k1")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.span("api.route"):
        pass
    with pytest.raises(KeyError):  # the span suppresses no exception
        with trace.span("api.route"):
            raise KeyError("inside")
    out = blur_u8(_frames((1, 24, 40, 3), seed=1), 2.0)
    assert out.shape == (1, 24, 40, 3)


def _sorted_inside(spans, outer):
    (_, a, b), = [s for s in spans if s[0] == outer]
    return [s for s in spans if a <= s[1] and s[2] <= b and s[0] != outer]


def test_profiled_blur_u8_nests_route_and_layout_in_the_call(tmp_path):
    img = _frames((2, 40, 56, 3), seed=2)
    blur_u8(img, 3.0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        blur_u8(img, 3.0)
    spans = _user_spans(prof, tmp_path)
    inner = _sorted_inside(spans, "api.blur_u8")
    assert [s[0] for s in inner] == ["api.route", "layout.to_planar", "layout.from_planar"]
    for before, after in zip(inner, inner[1:]):
        assert before[2] <= after[1]
    assert len(spans) == 4  # on the CPU no kernel launches: no launch.* span


def test_profiled_blur_routes_inside_the_call(tmp_path):
    x = torch.from_numpy(np.random.default_rng(3).random((2, 40, 56), dtype=np.float32))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        blur(x, 3.0)
    spans = _user_spans(prof, tmp_path)
    assert [s[0] for s in _sorted_inside(spans, "api.blur")] == ["api.route"]


def test_launched_counts_on_the_wrapper_and_in_counters(clean_counters):
    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.cluster_launches = 0
    trace.launched(wrapper, "fft_conv_rows", 100)
    trace.launched(wrapper, "fft_conv_rows", 50, "cluster_launches")
    trace.launched(wrapper, "fft_conv_rows_staged", 7)
    assert (wrapper.launches, wrapper.cluster_launches) == (3, 1)
    got = trace.counters()
    assert got == {"fft_conv_rows": {"launches": 2, "bytes": 150},
                   "fft_conv_rows_staged": {"launches": 1, "bytes": 7}}
    got["fft_conv_rows"]["bytes"] = 0  # a copy: the counts stay
    assert trace.counters()["fft_conv_rows"]["bytes"] == 150
    trace.reset_counters()
    assert trace.counters() == {}
    assert wrapper.launches == 3


def test_nbytes_counts_each_tensor_once():
    a = torch.zeros((3, 5), dtype=torch.uint8)
    b = torch.zeros((4,), dtype=torch.float32)
    c = torch.zeros((2, 2), dtype=torch.int16)
    assert trace.nbytes(a, None, b, c) == 15 + 16 + 8
    assert trace.nbytes() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("sigma, bytes_per_value", [
    (10.0, {"blur_fused_u8_k1": 2}),  # K1: uint8 in, uint8 out
    # the split: uint8 in, int16 E out; E in, uint8 out
    (62.0, {"fused_split_rows_int8": 3, "fused_split_cols_hybrid": 3}),
])  # and the layout moves around them: uint8 in, uint8 out, no tables
def test_one_call_on_the_card_counts_its_launches_and_bytes(clean_counters, tmp_path, sigma,
                                                           bytes_per_value):
    from portbench import program_trace, trace as bench_trace

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # 4K frames, as the benchmark's: the route and K1's form are those of its cells
    g = torch.Generator(device="cuda").manual_seed(4)
    img = torch.randint(0, 256, (4, 2160, 3840, 3), dtype=torch.uint8, device="cuda",
                        generator=g)
    blur_u8(img, sigma)
    torch.cuda.synchronize()
    trace.reset_counters()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(bench_trace.CALL):
            blur_u8(img, sigma)
            torch.cuda.synchronize()
    got = trace.counters()
    layout = {"layout_to_planar_u8": 2, "layout_from_planar_u8": 2}
    assert set(got) == set(bytes_per_value) | set(layout)
    for name, per_value in bytes_per_value.items():
        assert got[name]["launches"] == 1
        tables = got[name]["bytes"] - per_value * img.numel()
        assert 0 < tables < 1 << 20, (name, tables)  # the tap tables
    for name, per_value in layout.items():
        assert got[name] == {"launches": 1, "bytes": per_value * img.numel()}

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    program = program_trace.reduce(path)
    pattern = bench_trace.port_kernel_pattern(
        bench_trace.kernel_names(ROOT / "blur_algorithms_tpu_torch" / "csrc"))
    ours = [op for op in program.ops if bench_trace.is_port_kernel(op[0], pattern)]
    assert len(ours) == sum(c["launches"] for c in got.values())
    assert {op[2] for op in ours} == {f"launch.{name}" for name in got}
    assert all(op[3] in ("correlation", "order") for op in ours)
    # the two layout moves: the port's kernels, launched inside layout.*
    assert program.device_in("launch.layout_") > 0
