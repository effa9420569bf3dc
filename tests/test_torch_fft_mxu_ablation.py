"""B2, the K3/K3f ablation probe: its modes, its masks and its plain version.

Only ``full`` is a correct result; its plain version is K3's (or K3f's),
which ``tests/test_torch_fft_mxu.py`` holds against the JAX kernels. The
other modes are for timing on the card, as in the JAX probe
(``benchmarks/fft_mxu_ablation.py``), and run only there (``chip_smoke.py``
phase 17, ``tests/test_torch_cuda.py``). Here: the mode table against the
JAX probe's modes, the Python mirror of the mask against the enum in
``csrc/fft4step.cu`` and the instantiations in
``csrc/probes/fft_ablation.cu``, and a model of what each mask keeps.
"""

import ast
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu_torch import make_plan  # noqa: E402
from blur_algorithms_tpu_torch.benchmarks import fft_mxu_ablation as b2  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step  # noqa: E402
from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _ROOT / "blur_algorithms_tpu_torch" / "csrc"


def _jax_modes():
    """The default ``--modes`` of the JAX probe's main, from its source."""
    tree = ast.parse((_ROOT / "benchmarks" / "fft_mxu_ablation.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "add_argument"
                and n.args and ast.literal_eval(n.args[0]) == "--modes")
    return ast.literal_eval(next(k.value for k in call.keywords if k.arg == "default"))


def test_every_jax_mode_has_its_mask_or_its_reason():
    assert list(b2.MODES) == _jax_modes()
    assert b2.MODES["1dot"] is None and "bf16x3" in b2.ONE_DOT
    assert all(isinstance(m, int) for name, m in b2.MODES.items() if name != "1dot")
    assert len({*b2.MODES.values(), *b2.PORT_MODES.values()} - {None}) == 8
    x = torch.zeros((2, 256))
    with pytest.raises(ValueError, match="no counterpart"):
        b2.conv_rows_ablation(x, 256, make_plan((8, 256), 3.0).row, "1dot")
    with pytest.raises(ValueError, match="the modes are"):
        b2.conv_rows_ablation(x, 256, make_plan((8, 256), 3.0).row, "nodots")


def _enum():
    src = (_CSRC / "fft4step.cu").read_text()
    body = re.search(r"enum Ablate \{(.*?)\};", src, re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"(k\w+) = (\d+)", body)}


def test_mask_bits_are_the_sources():
    assert _enum() == {"kNoButterflies": b2.NO_BUTTERFLIES, "kNoTwiddles": b2.NO_TWIDDLES,
                       "kNoExchanges": b2.NO_EXCHANGES, "kNoSpectrum": b2.NO_SPECTRUM,
                       "kIoOnly": b2.IO_ONLY}


def test_the_probe_instantiates_every_mode_at_every_cells_length():
    src = (_CSRC / "probes" / "fft_ablation.cu").read_text()
    enum = _enum()
    cases = re.findall(r"ABLATE_CASE\(([^)\\]+)\)\n", src)
    masks = {sum(enum.get(t.strip(), 0) for t in c.split("|")) for c in cases}
    assert masks == {m for m in [*b2.MODES.values(), *b2.PORT_MODES.values()] if m is not None}
    lengths = set(re.findall(r"if \((!?)framed && n == (\d+)\)", src))
    want = {(c[4], c[2]) for c in b2.cells()} | {(False, b2.jax_default()[2])}
    assert {("" if f else "!", str(n)) for f, n in want} == lengths


def test_mask_zero_keeps_every_stage():
    keeps = b2.mask_keeps(0)
    assert all(keeps.values()) and set(keeps) == {*b2.STAGES, "middle passes"}


@pytest.mark.parametrize("mode", [m for m in [*b2.MODES, *b2.PORT_MODES] if m != "1dot"])
def test_each_mode_leaves_out_its_stages_alone(mode):
    mask = {**b2.MODES, **b2.PORT_MODES}[mode]
    keeps = b2.mask_keeps(mask)
    if mode == "io_only":
        assert not any(keeps.values())
        return
    dropped = {s for s, kept in keeps.items() if not kept}
    names = {"nodot": "butterflies", "notw": "twiddles", "norot": "exchanges",
             "noh": "spectrum"}
    want = {stage for tag, stage in names.items() if tag in mode}
    assert dropped == want


@pytest.mark.parametrize("framed, shape, sigma", [
    (False, (6, 300), 20.0),   # K3 on rows framed to n by the caller
    (True, (5, 1200), 60.0),   # K3f frames them
])
def test_full_mode_on_the_cpu_is_k3s_plain_version(framed, shape, sigma):
    ax = make_plan(shape, sigma).row
    n = 1024 if not framed else None
    rng = np.random.default_rng(3)
    if framed:
        from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length

        n = transform_length(ax)
        x = torch.from_numpy(rng.standard_normal((shape[0], ax.dim), dtype=np.float32))
        want = fft4step.fft_conv_rows_framed_ref(x, n, ax)
    else:
        x = torch.from_numpy(rng.standard_normal((shape[0], n), dtype=np.float32))
        want = _conv_rows_einsum(x, n, ax)
    before = b2.conv_rows_ablation.launches
    assert torch.equal(b2.conv_rows_ablation(x, n, ax, "full", framed), want)
    assert torch.equal((fft4step.fft_conv_rows_framed if framed else fft4step.fft_conv_rows)(
        x, n, ax), want)
    assert b2.conv_rows_ablation.launches == before
    with pytest.raises(ValueError, match="timing on the card"):
        b2.conv_rows_ablation(x, n, ax, "nodot", framed)
