"""B3, the loader fetch-rate probe: its geometry and what it stores.

The JAX probe's kernels are closures inside ``benchmarks/dma_fetch_rate.py:
main``, which also writes ``benchmarks/dma_fetch_rate.json``, so nothing here
calls it: its geometry is read from its source, and what its kernels store
(``out_ref[0] = win[slot][:8, :128]`` of the last window, ``buf[:8, :128]``
of the strip) is restated in NumPy. The port's plain versions must equal
that; K1's loaders' plain version must equal the NumPy reflect-101 window
and A5's padded frame where K1a reads it. The kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 17).
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.benchmarks import dma_fetch_rate as b3  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels.assemble import assemble_padded_ref  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels.fused_dma import k1_geometry  # noqa: E402

_JAX_PROBE = pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "dma_fetch_rate.py"


def _jax_geometry():
    """The names the JAX probe's main binds to constants (bc, hp, wp, th,
    tw, shp, swp, nbw), read from its source."""
    tree = ast.parse(_JAX_PROBE.read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    out = {}
    for node in main.body:
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        try:
            value = ast.literal_eval(node.value)
        except ValueError:
            continue
        names = [t.id for t in target.elts] if isinstance(target, ast.Tuple) else [target.id]
        values = value if isinstance(value, tuple) else (value,)
        out.update(zip(names, values))
    return out


def test_geometry_is_the_jax_probes():
    g = _jax_geometry()
    assert (b3.BC, b3.HP, b3.WP) == (g["bc"], g["hp"], g["wp"])
    assert (b3.TH, b3.TW) == (g["th"], g["tw"])
    assert (b3.SHP, b3.SWP, b3.NBW) == (g["shp"], g["swp"], g["nbw"])
    # the probe's byte counts: gb_win and gb_strip
    assert b3.window_bytes() == g["bc"] * g["nbw"] * g["shp"] * g["swp"]
    assert b3.window_bytes(b3.WP, 1, rows=b3.HP) == g["bc"] * g["shp"] * g["wp"]


def _frame(planes, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (planes, b3.HP, b3.WP), dtype=np.uint8)


def _numpy_stores(frame):
    """What the JAX kernels leave in out[c, :8, :128]: window j = nbw - 1 of
    plane c (columns j * tw .. j * tw + swp, rows 0 .. shp), its [:8, :128];
    and the strip's (columns 0 .. wp) [:8, :128]."""
    nbw, tw, shp, swp = b3.NBW, b3.TW, b3.SHP, b3.SWP
    windowed, strip = [], []
    for c in range(frame.shape[0]):
        win = frame[c, 0:shp, (nbw - 1) * tw:(nbw - 1) * tw + swp]
        windowed.append(win[:8, :128])
        strip.append(frame[c, 0:shp, 0:b3.WP][:8, :128])
    return np.stack(windowed), np.stack(strip)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_stores_are_what_the_jax_kernels_store(seed):
    frame = _frame(2, seed)
    windowed, strip = _numpy_stores(frame)
    x = torch.from_numpy(frame)
    before = dict(b3.fetch_windows.launches)
    assert torch.equal(b3.fetch_windows(x), torch.from_numpy(windowed))
    assert torch.equal(b3.fetch_windows(x, strip=True), torch.from_numpy(strip))
    assert torch.equal(b3.fetch_windows_ref(x), torch.from_numpy(windowed))
    assert b3.fetch_windows.launches == before
    with pytest.raises(ValueError, match="uint8 frame"):
        b3.fetch_windows(x[:, :100])


def _reflect101(i, n):
    i = np.abs(i)
    return np.where(i > n - 1, 2 * (n - 1) - i, i)


@pytest.mark.parametrize("shape, sigma, form", [
    ((2160, 3840), 10.0, "direct"),      # the probe's plan: th 240, tw 64, r 32
    ((2160, 3840), 10.0, "assembled"),
    ((301, 517), 10.0, "direct"),        # ragged last tiles
    ((301, 517), 25.0, "assembled"),
    ((541, 963), 10.0, "direct"),        # the last window past w + rw
    ((541, 963), 10.0, "assembled"),
])
def test_k1_loaders_plain_version_is_the_last_windows_corner(shape, sigma, form):
    plan = make_plan(shape, sigma)
    lo = b3.k1_loader(plan, form, torch.device("cpu"), planes=3)
    geo = k1_geometry(form, "hybrid", plan, 3)
    assert (lo.th, lo.tw, lo.smem, lo.slots, lo.xh, lo.xw) == (
        geo.th, geo.tw, geo.smem, geo.slots, geo.hp, geo.wp)
    h, w = shape
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    i0 = (-(-h // lo.th) - 1) * lo.th
    j0 = (-(-w // lo.tw) - 1) * lo.tw
    rows = _reflect101(i0 - lo.rh + np.arange(8), h)
    cols = _reflect101(j0 - lo.rw - lo.delta + np.arange(128), w)
    want = x[:, rows][:, :, cols]
    before = dict(b3.fetch_k1.launches)
    got = b3.fetch_k1(torch.from_numpy(x), lo)
    assert b3.fetch_k1.launches == before
    if form == "direct":
        assert torch.equal(got, torch.from_numpy(want))
        return
    # K1a reads A5's frame at (i0, j0): reflect-101 out to rw columns past
    # the edge (the columns K1's outputs need), zeros past them
    frame = assemble_padded_ref(torch.from_numpy(x), lo.rh, lo.rw, lo.rh, lo.rw, lo.xh, lo.xw)
    assert torch.equal(frame[:, i0:i0 + 8, j0:j0 + 128], got)
    inside = j0 - lo.rw + np.arange(128) < w + lo.rw
    assert torch.equal(got[..., inside], torch.from_numpy(want[..., inside]))
    assert not got[..., ~inside].any()


def test_k1_read_amplification_is_the_windows_over_the_tiles():
    plan = make_plan((2160, 3840), 10.0)
    lo = b3.k1_loader(plan, "direct", torch.device("cpu"))
    rows, row_bytes = lo.window
    # round16(th + 2rh) rows of tw - 16 + 32 k-steps of window bytes
    steps = -(-(lo.delta + 2 * lo.rw + 1 + 15) // 32)
    assert (rows, row_bytes) == (-(-(lo.th + 2 * lo.rh) // 16) * 16, lo.tw - 16 + 32 * steps)
    fetched = b3.k1_bytes(2160, 3840, lo, b3.BC)
    # 2160 / 240 and 3840 / 64 tiles exactly: (rows / th)(row bytes / tw)
    assert fetched / (b3.BC * 2160 * 3840) == pytest.approx(
        (rows / lo.th) * (row_bytes / lo.tw))


_CSRC = pathlib.Path(b3.__file__).resolve().parents[1] / "csrc"


def test_k1_loaders_probe_runs_fused_dma_cus_own_loaders():
    """The probe times K1's staging code, not a copy of it: it includes
    ``fused_dma.cu`` with its loaders alone (the guard opens after them and
    closes at the end), calls them, and defines none of its own; K1's
    direct and assembled forms call the same functions."""
    probe = (_CSRC / "probes" / "fetch_rate.cu").read_text()
    k1 = (_CSRC / "fused_dma.cu").read_text()
    assert '#define FUSED_DMA_LOADERS_ONLY\n#include "../fused_dma.cu"' in probe
    for fn in ("tc_layout(", "load_window(", "load_rect("):
        assert fn in probe
    for own in ("int reflect101(", "void cp_async16(", "kThreads =", "TcLayout tc_layout("):
        assert own not in probe
    guard = k1.index("#ifndef FUSED_DMA_LOADERS_ONLY")
    for fn in ("TcLayout tc_layout(", "void load_window(", "void load_rect(",
               "int reflect101("):
        assert k1.index(fn) < guard
    assert k1.index("// ---- the tensor-core bodies") > guard
    assert k1.rstrip().endswith("#endif  // FUSED_DMA_LOADERS_ONLY")
    staging = k1[k1.index("void rows_through_stage("):k1.index("bool vec_planes(")]
    assert "load_window(" in staging
    direct = k1[k1.index("k1_direct(K1Params p)"):k1.index("k1_strip(K1Params p)")]
    assert "rows_through_stage<B>(" in direct
    assembled = k1[k1.index("k1_assembled(K1Params p)"):k1.index("k1_resident(K1Params p)")]
    assert "load_rect(" in assembled and "convert(" not in assembled


def test_probe_library_is_keyed_by_the_sources_it_includes(monkeypatch):
    from blur_algorithms_tpu_torch.utils import build

    seen = {}

    def fake(sources, hashed, stem, record):
        seen.update(sources=[p.name for p in sources], hashed=[p.name for p in hashed])
        raise RuntimeError("not built here")

    monkeypatch.setattr(build, "_probe_lib", None)
    monkeypatch.setattr(build, "_build_and_load", fake)
    with pytest.raises(RuntimeError, match="not built here"):
        build.load_probe_library()
    assert seen["sources"] == ["fetch_rate.cu", "fft_ablation.cu", "mma_rate.cu"]
    assert {"fft4step.cu", "fused_dma.cu", *seen["sources"]} == set(seen["hashed"])


def test_launch_counters_are_per_form():
    assert set(b3.fetch_windows.launches) == {"windowed", "windowed_tma", "strip"}
    assert set(b3.fetch_k1.launches) == {"direct", "assembled"}
