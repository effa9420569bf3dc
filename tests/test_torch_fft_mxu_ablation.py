"""B2, the K3/K3f ablation probe: its modes, its masks and its plain version.

Only ``full`` is a correct result; its plain version is K3's (or K3f's),
which ``tests/test_torch_fft_mxu.py`` holds against the JAX kernels. The
other modes are for timing on the card, as in the JAX probe
(``benchmarks/fft_mxu_ablation.py``), and run only there (``chip_smoke.py``
phase 17, ``tests/test_torch_cuda.py``). Here: the mode table against the
JAX probe's modes, the Python mirror of the mask against the enum in
``csrc/fft4step.cu`` and the instantiations in
``csrc/probes/fft_ablation.cu``, and a model of what each mask keeps. Past
16384 the probe runs PR 16's cluster form (the yardstick the current one is
timed against) and both designs with parts left out: the variant numbers
against ``enum ClusterVariant``, the variants each C entry dispatches,
``pr16``'s plain version on the CPU, and the timed shapes.
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


def _cluster_enum():
    src = (_CSRC / "fft4step.cu").read_text()
    body = re.search(r"enum ClusterVariant \{(.*?)\};", src, re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"(kV\w+) = (\d+)", body)}


def test_cluster_variant_numbers_are_the_sources():
    enum = _cluster_enum()
    assert enum == {"kVLocal": 1, "kVNoBarriers": 2, "kVIoOnly": 4, "kVBodyOnly": 8,
                    "kVPushBarriers": 16}
    assert b2.CLUSTER_VARIANTS == {
        "pr16": 0, "local": enum["kVLocal"], "no_barriers": enum["kVNoBarriers"],
        "local_no_barriers": enum["kVLocal"] | enum["kVNoBarriers"],
        "io_only": enum["kVIoOnly"], "body_only": enum["kVBodyOnly"]}
    push = enum["kVPushBarriers"]
    assert b2.CURRENT_VARIANTS == {
        "current_push_barriers": push, "current_local": push | enum["kVLocal"],
        "current_local_cta_barriers": push | enum["kVLocal"] | enum["kVNoBarriers"]}


def _c_function(src, name):
    """The body of the C entry ``name`` in ``src`` (to the next entry)."""
    start = src.index(f'extern "C" int {name}(')
    nxt = src.find('extern "C"', start + 1)
    return src[start:nxt if nxt > 0 else len(src)]


@pytest.mark.parametrize("entry, cases", [
    ("fft_cluster_ablation", ["kVLocal", "kVNoBarriers", "kVLocal | kVNoBarriers", "kVIoOnly",
                              "kVBodyOnly"]),
    ("fft_cluster_current_ablation", ["kVPushBarriers", "kVPushBarriers | kVLocal",
                                      "kVPushBarriers | kVLocal | kVNoBarriers"]),
])
def test_the_probe_dispatches_every_cluster_variant(entry, cases):
    src = (_CSRC / "probes" / "fft_ablation.cu").read_text()
    enum = _cluster_enum()
    if entry == "fft_cluster_ablation":  # PR 16's: its dispatch template, CLUSTER_VARIANT(...)
        found = re.findall(r"CLUSTER_VARIANT\(([^)\\]+)\)\n", src)
        want = {b2.CLUSTER_VARIANTS[k] for k in b2.CLUSTER_VARIANTS if k != "pr16"}
    else:
        found = re.findall(r"case (kV[^:]+):", _c_function(src, entry))
        want = set(b2.CURRENT_VARIANTS.values())
    got = {sum(enum[t.strip()] for t in c.split("|")) for c in found}
    assert [c.strip() for c in found] == cases and got == want


@pytest.mark.parametrize("framed", [False, True])
def test_cluster_ablation_on_the_cpu_is_the_plain_version(framed):
    """``pr16`` on CPU rows runs K3's or K3f's plain version at n 32768 and
    counts no launch; every other variant is for timing on the card."""
    from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length

    ax = make_plan((8, 16800), 400.0).row
    n = transform_length(ax) if framed else 32768
    assert n == 32768
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, ax.dim if framed else n), dtype=np.float32))
    want = fft4step.fft_conv_rows_framed_ref(x, n, ax) if framed else _conv_rows_einsum(x, n, ax)
    before = b2.cluster_ablation.launches
    assert torch.equal(b2.cluster_ablation(x, n, ax, "pr16", framed), want)
    assert b2.cluster_ablation.launches == before
    for variant in [*b2.CLUSTER_VARIANTS, b2.OTHER_SEGMENT, *b2.CURRENT_VARIANTS]:
        if variant != "pr16":
            with pytest.raises(ValueError, match="timing on the card"):
                b2.cluster_ablation(x, n, ax, variant, framed)
    with pytest.raises(ValueError, match="the variants are"):
        b2.cluster_ablation(x, n, ax, "no_such_variant", framed)
    with pytest.raises(ValueError, match="not a length of the cluster form"):
        b2.cluster_ablation(x[:, :16384], 16384, make_plan((8, 16384), 10.0).row)


@pytest.mark.parametrize("framed", [False, True])
def test_staged_yardstick_on_the_cpu_is_the_plain_version(framed):
    """The copying staged form at n 262144 (the yardstick of the wide cluster
    form there) on CPU rows runs K3's or K3f's plain version and counts no
    launch; a shorter length raises."""
    from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length

    ax = make_plan((2, 140000), 900.0).row
    n = transform_length(ax) if framed else 262144
    assert n == 262144 == fft4step.CLUSTER_LONGEST
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, ax.dim if framed else n), dtype=np.float32))
    want = fft4step.fft_conv_rows_framed_ref(x, n, ax) if framed else _conv_rows_einsum(x, n, ax)
    before = b2.staged_yardstick.launches
    assert torch.equal(b2.staged_yardstick(x, n, ax, framed), want)
    assert b2.staged_yardstick.launches == before
    with pytest.raises(ValueError, match="not a length of the copying staged form"):
        b2.staged_yardstick(x, n // 2, ax, framed)


def test_cluster_cells_are_the_timed_shapes():
    """K3 on the panorama's adjoint rows (C 2), K3f on a giant frame's rows
    (C 2) and on a streamed column strip (n 65536)."""
    cells = b2.cluster_cells()
    assert [(rows, n, framed) for _, rows, n, _, framed in cells] == [
        (25920, 32768, False), (72000, 32768, True), (12288, 65536, True)]
    assert [ax.dim for *_, ax, _ in cells] == [15360, 14500, 24000]
    assert all(fft4step.kernel_length(n) and n > fft4step.BODY_N for _, _, n, *_ in cells)
