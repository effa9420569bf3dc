"""K1, the fused int8 blur, against the JAX int8 DMA kernel.

The plain PyTorch version of K1 (``blur_fused_u8_dma_ref``, which the
wrapper runs for a CPU tensor) must be bit-identical to the JAX package's
``_blur_fused_dma_impl(..., "int8", direct=True)``, which runs the Pallas
kernel ``_kernel_direct`` in interpret mode on the CPU. The port's integer
operands must equal the JAX ``_band_operands``. The CUDA kernel itself runs
only on a card: its tests are in ``test_torch_cuda.py``.
"""

import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from blur_algorithms_tpu.ops.plan import make_plan as j_make_plan  # noqa: E402
from blur_algorithms_tpu.pallas_kernels import fused_dma as j_dma  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma as t_dma  # noqa: E402
from blur_algorithms_tpu_torch.ops.plan import make_custom_plan, make_plan  # noqa: E402

# (h, w), sigma, the JAX kernel's tile: the direct-form shapes of
# test_band_fused.py (single- and multi-strip, ragged, wide, anisotropic)
CASES = [
    ((48, 640), 3.0, (48, 256)),
    ((41, 899), 5.0, (48, 384)),
    ((40, 384), 25.0, (40, 256)),
    ((96, 256), 3.0, (48, 128)),
    ((100, 256), 2.0, (40, 128)),
    ((96, 556), 3.0, (48, 128)),
    ((96, 600), (2.0, 50.0), (48, 128)),
    ((80, 256), (6.3, 2.0), (16, 128)),
]


@pytest.mark.parametrize("shape, sigma, tile", CASES)
def test_plain_k1_bit_identical_to_jax_int8_kernel(shape, sigma, tile):
    """Every integer stage is exact in both, and the f32 epilogue rounds
    each product and sum once in the same order, so the outputs agree bit
    for bit (no tolerance)."""
    h, w = shape
    rng = np.random.default_rng(h * 1000 + w)
    x = (rng.random((2, h, w)) * 255).astype(np.uint8)
    want = np.asarray(j_dma._blur_fused_dma_impl(
        jnp.asarray(x), j_make_plan(shape, sigma), "int8", True,
        tile=tile, direct=True,
    ))
    got = t_dma.blur_fused_u8_dma_ref(torch.from_numpy(x), make_plan(shape, sigma))
    assert got.dtype == torch.uint8 and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_k1_extreme_content():
    """Saturated and constant frames: the DC-exact quantiser keeps a
    constant frame constant, and extremes stay in [0, 255]."""
    shape, sigma = (48, 300), 4.0
    plan, jplan = make_plan(shape, sigma), j_make_plan(shape, sigma)
    x = np.zeros((4, *shape), np.uint8)
    x[1] = 255
    x[2] = 77
    x[3, ::2] = 255  # stripes
    want = np.asarray(j_dma._blur_fused_dma_impl(
        jnp.asarray(x), jplan, "int8", True, tile=(48, 128), direct=True))
    got = t_dma.blur_fused_u8_dma_ref(torch.from_numpy(x), plan).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all() and (got[1] == 255).all() and (got[2] == 77).all()


@pytest.mark.parametrize("shape, sigma", [
    ((48, 640), 3.0), ((2160, 3840), 10.0), ((1080, 1920), (5.0, 11.0)),
    ((1300, 1400), 180.0), ((64, 40), 25.0),
])
@pytest.mark.parametrize("chunks", [(128, 24), (256, 40)])
def test_int8_operands_equal_jax_band_operands(shape, sigma, chunks):
    """Every column of the JAX int8 band operands holds the port's tap
    vector (hi and lo digits), shifted down by its column index."""
    cw, ch = chunks
    bw, bh, rows_shift, cols_scale = j_dma._band_operands(
        j_make_plan(shape, sigma), "int8", cw, ch)
    ops = t_dma.int8_operands(make_plan(shape, sigma))
    assert (rows_shift, cols_scale) == (ops.rows_shift, ops.cols_scale)
    for band, q, c in ((np.asarray(bw), ops.q_row, cw), (np.asarray(bh), ops.q_col, ch)):
        assert band.shape == (2, c + q.size - 1, c)
        digits = np.stack([q >> 7, q & 127]).astype(np.int8)
        for j in range(c):
            col = band[:, :, j]
            np.testing.assert_array_equal(col[:, j : j + q.size], digits)
            assert not col[:, :j].any() and not col[:, j + q.size :].any()


def test_epilogue_constants_are_the_jax_products():
    ops = t_dma.int8_operands(make_plan((48, 640), 3.0))
    inv = 1.0 / (127.0 * ops.cols_scale)
    c = ops.epilogue_constants()
    assert all(v.dtype == np.float32 for v in c)
    assert c == (np.float32(16384.0 * inv), np.float32(128.0 * inv), np.float32(inv))


def test_pack_int8_words_little_endian():
    words = t_dma._pack_int8_words(np.array([1, -2, 3, 4, 5], np.int8))
    assert words.dtype == np.int32 and words.size == 2
    assert [(int(words[0]) >> (8 * u)) & 255 for u in range(4)] == [1, 254, 3, 4]
    assert int(words[1]) == 5


def test_wrapper_on_cpu_runs_plain_version_and_counts_no_launch():
    plan = make_plan((24, 40), 2.0)
    x = torch.from_numpy(
        (np.random.default_rng(5).random((3, 24, 40)) * 255).astype(np.uint8))
    before = t_dma.blur_fused_u8_dma.launches
    out = t_dma.blur_fused_u8_dma(x, plan)
    assert t_dma.blur_fused_u8_dma.launches == before
    assert out.device == x.device
    assert torch.equal(out, t_dma.blur_fused_u8_dma_ref(x, plan))


def test_wrapper_rejects_bad_inputs():
    plan = make_plan((24, 40), 2.0)
    with pytest.raises(TypeError):
        t_dma.blur_fused_u8_dma(torch.zeros((3, 24, 40)), plan)
    with pytest.raises(ValueError):
        t_dma.blur_fused_u8_dma(torch.zeros((3, 24, 41), dtype=torch.uint8), plan)
    with pytest.raises(ValueError):  # neither CUDA nor CPU: no silent move
        t_dma.blur_fused_u8_dma(torch.zeros((3, 24, 40), dtype=torch.uint8, device="meta"), plan)


@pytest.mark.parametrize("plan, match", [
    (make_plan((48, 64), 0.1), "radius-0 axis"),  # both axes radius 0: K2's
    (make_plan((1, 64), 3.0), "radius-0 axis"),  # the column axis only
    (make_plan((1400, 1400), 200.0), "support radius 665 > 600"),
    (make_custom_plan((16, 16), [-0.25, 1.5, -0.25]), "signed"),
    (make_custom_plan((16, 16), [0.5, 1.0, 0.5]), "non-normalised"),
])
def test_outside_the_domain_raises(plan, match):
    x = torch.zeros((1, *plan.shape), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match=match):
        t_dma.blur_fused_u8_dma(x, plan)
    with pytest.raises(NotImplementedError, match=match):
        t_dma.blur_fused_u8_dma_ref(x, plan)


def test_kernel_sources_are_built_from_csrc():
    from blur_algorithms_tpu_torch.utils import build

    sources = sorted(p.name for p in (build._CSRC).glob("*.cu"))
    assert sources == ["box_scan.cu", "fft4step.cu", "fused_blur.cu", "fused_dma.cu",
                       "fused_split.cu", "spectral_multiply.cu"]
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert build.build_dir().name == "build"
    # each source names the TPU kernel it replaces
    text = (build._CSRC / "fused_dma.cu").read_text()
    assert "fused_dma.py:_kernel_direct" in text
    text = (build._CSRC / "fused_blur.cu").read_text()
    assert "fused_blur.py:_kernel" in text and "fused_dma.py:_tile_bf16x3" in text
    assert "box_blur_pallas.py:_kernel" in (build._CSRC / "box_scan.cu").read_text()
    assert "fused_blur.py:_kernel_int8" in (build._CSRC / "fused_split.cu").read_text()
    text = (build._CSRC / "fft4step.cu").read_text()
    assert "fft4step.py:_kernel" in text and ":_kernel_framed" in text
    text = (build._CSRC / "spectral_multiply.cu").read_text()
    assert "spectral_multiply.py:_kernel" in text


def test_port_imports_no_jax():
    """A static scan: no module of the port, and not ``chip_smoke.py``,
    imports jax, the JAX package or ``bench.py`` (which imports the JAX
    package); the interpreter here may have jax loaded already, so
    sys.modules proves nothing."""
    pkg = pathlib.Path(t_dma.__file__).resolve().parents[1]
    files = sorted(pkg.rglob("*.py"))
    assert len(files) >= 15
    for path in files + [pkg.parent / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "blur_algorithms_tpu", "bench"), (
                    path, name)
