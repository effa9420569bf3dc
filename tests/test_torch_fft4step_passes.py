"""The plan of the K3/K3f and K5 kernels, checked on the CPU.

``csrc/fft4step.cu`` runs the FFT convolution of a pair of rows as a few
high-radix passes (radix Q, radix R0, radix-32 passes) with twiddles from a
two-level table, the multiply by H between the last forward and the first
inverse pass. A NumPy model of those passes, fed the host's tables
(``_twiddle_tables``, ``_kernel_spectrum`` in ``_kernel_bin_order``),
reproduces the plain version ``_conv_rows_einsum`` (which
``tests/test_torch_fft_mxu.py`` holds against the JAX package) within 1e-3
at 0..255 scale, the cluster form's lengths (32768, 65536, 131072, and the
wide form's 262144) included, and ``np.fft`` at those lengths. The cluster
form is modelled as
``fft_conv_rows_cluster_kernel`` runs it, lane group by lane group: the
first pass (radix n / 1024 over stride 1024: radix-C DFTs with rotated
outputs, the W_(n/1024) table entries, the shuffles between a group's
G = n / 32768 lanes, radix-R0 DFTs, the outer W_n twiddles with the
rotation's correction), the segments' radix-32 passes, and the last pass
as its adjoint; the wide cluster form at 262144 as a radix-16 pass over
stride 16384 (the staged pass kernel's arithmetic, split over 16 CTAs), the
segments' whole body, and its adjoint, with its mapping over the cluster.
The staged form (past 262144: 524288, one first-pass digit of 32, and
1048576, the shortest length with two) is modelled pass by pass as
its kernels index it (a thread a butterfly, twiddles ``(q j) << shift``
from the W_n tables), each segment through the body's passes, and held
against ``np.fft`` in the host's bin order and against a float64
correlation; its mapping touches each position once, its twiddle
exponents stay below n, and its row and scratch offsets, which pass 2^31
at the frames it serves, are int64. A model of the
kernel's thread mapping checks that every pass touches each position once,
with no shared-memory bank conflict, and that the twiddle exponents stay
below n; the cluster form's mapping over the cluster's CTAs likewise (each
position loaded, stored, pushed and read back once, shuffle partners in
one warp, the slabs read without bank conflicts). The two-level table's
f32 product stays within 4 * 2^-24 of the float64 root (the bound the
source note states). K5's grid and its head / pairs / tail split cover every value of
every plane once, with 16-byte-aligned pairs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu_torch.cuda_kernels import fft4step as k3  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import spectral_multiply as k5  # noqa: E402
from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum  # noqa: E402
from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel, wrap_centered  # noqa: E402
from blur_algorithms_tpu_torch.ops.plan import make_custom_plan  # noqa: E402

CLUSTER_LENGTHS = [32768, 65536, 131072, 262144]
WIDE_N = 16 * 16384  # the wide cluster form's length: a cluster of 16 CTAs
# the staged form's: one first-pass digit (32), two (8, 8)
STAGED_LENGTHS = [524288, 1048576]
LENGTHS = [256, 4096, 5120, 6144, 7168, 8192, 11264, 15360, 16384] + CLUSTER_LENGTHS
TWIDDLE_BOUND = 4 * 2.0 ** -24


def _tables(n):
    """(Tlo, Thi, W_Q) of ``_twiddle_tables`` as complex64; past
    ``BODY_N`` the cluster pass's (W_n^l, W_n^(128 h), None)."""
    tab = k3._twiddle_tables(n)
    c = (tab[:, 0] + 1j * tab[:, 1]).astype(np.complex64)
    if n > k3.BODY_N:
        return c[272:400], c[400:], None
    return c[:128], c[128:256], c[256:]


def _twiddle(n, e):
    """W_n^e as the kernel forms it: Thi[e >> 7] * Tlo[e & 127] in f32 (the
    cluster pass's tables past ``BODY_N``)."""
    lo, hi, _ = _tables(n)
    return hi[e >> 7] * lo[e & 127]


def _pass_twiddle(n, span, qj):
    """W_span^(q j) as the pass over spans ``span`` of a length-n transform
    forms it: the cluster pass (span n past ``BODY_N``) and the staged
    form's first passes (spans past ``BODY_N``) from the W_n tables, every
    other pass from the tables of the block's length (n, or ``BODY_N`` on
    a segment of the cluster or the staged form)."""
    if span == n or span > k3.BODY_N:
        return _twiddle(n, qj * (n // span))
    nb = min(n, k3.BODY_N)
    return _twiddle(nb, qj * (nb // span))


def _schedule(n):
    """The kernel's forward passes as ``fft_conv_rows_kernel`` runs them:
    (radix, butterfly count, log2 of the stride s, tw_mul = n / span)."""
    q, p = n, 0
    while q % 2 == 0:
        q //= 2
        p += 1
    a = 2 if p >= 10 else 1
    r0_log2 = p - 5 * a
    out = []
    if q > 1:
        out.append((q, n // q, p, 1))
    if r0_log2:
        out.append((1 << r0_log2, n >> r0_log2, p - r0_log2, q))
    for i in range(a - 1):
        l2 = p - r0_log2 - 5 * i
        out.append((32, n // 32, l2 - 5, n >> l2))
    out.append((32, n // 32, 0, n // 32))  # the middle pass: span 32, j = 0
    return out


def _butterflies(n, radix, count, s_log2):
    """Positions of each butterfly, in the order the kernel's threads take
    them (b = thread + k * n / 32): (b, j, positions)."""
    smask = (1 << s_log2) - 1
    for b in range(count):
        j = b & smask
        base = (((b >> s_log2) * radix) << s_log2) + j
        yield b, j, base + (np.arange(radix) << s_log2)


def _dft(radix, wq):
    """The R-point DFT matrix a pass applies: W_32 roots rounded to f32 for
    a power of two (the literal constants), the table's W_Q for odd Q."""
    m = np.outer(np.arange(radix), np.arange(radix)) % radix
    if radix & (radix - 1) == 0:
        w32 = np.exp(-2j * np.pi * np.arange(32) / 32).astype(np.complex64)
        return w32[m * (32 // radix)].astype(np.complex128)
    return wq[m].astype(np.complex128)


def _cluster_geometry(n, segment=None):
    """(M, C, G, MG, QG, J) of the cluster form at n (``csrc/fft4step.cu``:
    ``ClusterMap``): the segment, CTAs a cluster, lanes a group, m values a
    lane, outputs q a lane, j values a CTA."""
    m_len = segment or k3.cluster_segment(n)
    c, grp = n // m_len, n // 32768
    return m_len, c, grp, m_len // 1024 // grp, c // grp, 1024 // c


def _quarter_turns(k):
    """(-i)^k, the kernel's ``quarter_turns``."""
    return (-1j) ** (np.asarray(k) % 4)


def _outer_twiddle(n, q, k, j, g, segment=None):
    """The first and last pass's outer twiddle of output (q, k) at butterfly
    j in lane g: W_n^(kk j) (kk = q + C k) times the lane's rotation
    W_G^(k g), as the kernel forms its exponent and the product of its two
    W_n tables (f32)."""
    _, c, grp, _, _, _ = _cluster_geometry(n, segment)
    step = (c * j + g * (n // grp)) % n
    return _twiddle(n, (q * j + k * step) % n).astype(np.complex128)


def _inner_twiddle(n, q, m):
    """W_(n/1024)^(q m), the W_n^(128 h) table's entry 8 q m."""
    return _tables(n)[1][8 * q * m].astype(np.complex128)


def _cluster_forward(z, n, segment=None):
    """``cluster_forward`` over every butterfly j and lane g: (half, n) rows
    -> (half, n) segments, segment q at [q M, (q + 1) M)."""
    m_len, c, grp, mg, qg, _ = _cluster_geometry(n, segment)
    r0 = m_len // 1024
    j = np.arange(1024)
    seg = np.zeros_like(z)
    a = {}
    for g in range(grp):  # the loads, radix-C DFTs and inner twiddles
        a[g] = [[z[:, j + 1024 * (g * mg + mi) + m_len * cc] for mi in range(mg)]
                for cc in range(c)]
        for mi in range(mg):
            v = np.einsum("sc,cbj->sbj", _dft(c, None), np.array(
                [a[g][cc][mi] * _quarter_turns(g * cc * (4 // grp)) for cc in range(c)]))
            m = g * mg + mi
            for s in range(c):
                a[g][s][mi] = v[s] * _inner_twiddle(n, (s + qg * g) % c, m)
    for g in range(grp):  # the shuffles, radix-R0 DFTs, outer twiddles, stores
        for e in range(qg):
            w = np.array([a[(g + d) % grp][(e - qg * d) % c][mi]
                          for d in range(grp) for mi in range(mg)])
            y = np.einsum("kt,tbj->kbj", _dft(r0, None), w)
            q = qg * g + e
            for k in range(r0):
                seg[:, m_len * q + j + 1024 * k] = y[k] * _outer_twiddle(n, q, k, j, g, segment)
    return seg


def _cluster_inverse(seg, n, segment=None):
    """``cluster_inverse`` over every j and g: segments -> rows."""
    m_len, c, grp, mg, qg, _ = _cluster_geometry(n, segment)
    r0 = m_len // 1024
    j = np.arange(1024)
    out = np.zeros_like(seg)
    w = {}
    for g in range(grp):
        for e in range(qg):
            q = qg * g + e
            t = np.array([seg[:, m_len * q + j + 1024 * k]
                          * np.conj(_outer_twiddle(n, q, k, j, g, segment)) for k in range(r0)])
            w[g, e] = np.einsum("tk,kbj->tbj", np.conj(_dft(r0, None)), t)
    for g in range(grp):
        a = {}
        for d in range(grp):
            for e in range(qg):
                for mi in range(mg):
                    a[(e - qg * d) % c, mi] = w[(g - d) % grp, e][d * mg + mi]
        for mi in range(mg):
            m = g * mg + mi
            v = np.array([a[s, mi] * np.conj(_inner_twiddle(n, (s + qg * g) % c, m))
                          for s in range(c)])
            v = np.einsum("cs,sbj->cbj", np.conj(_dft(c, None)), v)
            for cc in range(c):
                out[:, j + 1024 * m + m_len * cc] = v[cc] * np.conj(
                    _quarter_turns(g * cc * (4 // grp)))
    return out


def _staged_butterflies(n, radix, span):
    """The butterflies of a staged pass as ``fft_conv_rows_staged_pass_kernel``
    indexes them: b < n / radix (t mod (n / radix) of a pair), stride
    s = span / radix, j = b mod s, base = (b / s) span + j; returns j and the
    (n / radix, radix) positions base + m s."""
    s_log2 = (span // radix).bit_length() - 1
    b = np.arange(n // radix, dtype=np.int64)
    j = b & ((1 << s_log2) - 1)
    base = ((b >> s_log2) << (span.bit_length() - 1)) + j
    return j, base[:, None] + (np.arange(radix, dtype=np.int64) << s_log2)[None, :]


def _staged_exponents(n, radix, span):
    """Twiddle exponents (q j) << (log2 n - log2 span) of a staged pass, per
    butterfly and output q: (n / radix, radix)."""
    j, _ = _staged_butterflies(n, radix, span)
    shift = (n.bit_length() - 1) - (span.bit_length() - 1)
    return (j[:, None] * np.arange(radix)[None, :]) << shift


def _staged_pass(z, n, radix, span, inverse):
    """One staged pass over spans ``span`` of (half, n) complex rows, as the
    kernel runs it: forward the radix-R DFT of x[base + m s], then output q
    times W_n^e (the f32 table product) at base + q s; inverse conjugate
    twiddles, then the conjugate DFT."""
    _, pos = _staged_butterflies(n, radix, span)
    tw = _twiddle(n, _staged_exponents(n, radix, span)).astype(np.complex128)
    d = _dft(radix, None)
    a = z[:, pos]
    if inverse:
        y = np.einsum("mq,bjq->bjm", np.conj(d), a * np.conj(tw))
    else:
        y = np.einsum("qm,bjm->bjq", d, a) * tw
    out = np.empty_like(z)
    out[:, pos] = y
    return out


def _first_digits(n):
    """The passes over spans past ``BODY_N`` that index the rows as the
    staged pass kernel does: from ``CLUSTER_LONGEST`` on the staged form's
    digits; at ``WIDE_N`` (16, the staged form's one digit there) also the
    wide cluster form's radix-16 pass over stride ``BODY_N`` (rows ->
    segments, output q times W_n^(q j)) and its adjoint, the same arithmetic
    split over the cluster's CTAs."""
    return k3.staged_digits(n) if n >= k3.CLUSTER_LONGEST else []


def _model_conv(rows: np.ndarray, n: int, axis_plan) -> np.ndarray:
    """NumPy model of the kernel: pairs (c, c + half) packed as z = a + ib,
    the forward passes (DFT, then twiddles), H in the kernel's bin order,
    the inverse passes (conjugate twiddles, then the conjugate DFT); past
    ``BODY_N`` the cluster form's first and last pass, and the segments'
    radix-32 passes between them; at ``WIDE_N`` the wide cluster form's
    radix-16 pass and, past ``CLUSTER_LONGEST``, the staged form's first
    passes, and their adjoints, around the segments' body passes."""
    r = rows.shape[0]
    half = (r + 1) // 2
    z = rows[:half].astype(np.complex128)
    z[: r - half] += 1j * rows[half:]
    _, _, wq = _tables(min(n, k3.BODY_N))
    radices, span = k3._radices(n), n
    digits = _first_digits(n)
    for radix in digits:
        z = _staged_pass(z, n, radix, span, inverse=False)
        span //= radix
    radices = radices[len(digits):]
    if k3.BODY_N < n < WIDE_N:
        z, radices, span = _cluster_forward(z, n), radices[2:], 1024
    spans = []
    for radix in radices:
        s = span // radix
        qj = np.outer(np.arange(radix), np.arange(s))
        spans.append((radix, span, s, _pass_twiddle(n, span, qj).astype(np.complex128)))
        cube = z.reshape(half, n // span, radix, s)
        cube = np.einsum("qm,bkms->bkqs", _dft(radix, wq), cube)
        z = (cube * spans[-1][3]).reshape(half, n)
        span = s
    h, complex_h = k3._kernel_spectrum(axis_plan, n, torch.device("cpu"))
    h = h.numpy().astype(np.float64)
    z = z * (h[:, 0] + 1j * h[:, 1] if complex_h else h)
    for radix, span, s, tw in reversed(spans):
        cube = z.reshape(half, n // span, radix, s) * np.conj(tw)
        cube = np.einsum("mq,bkqs->bkms", np.conj(_dft(radix, wq)), cube)
        z = cube.reshape(half, n)
    if k3.BODY_N < n < WIDE_N:
        z = _cluster_inverse(z, n)
    span = k3.BODY_N
    for radix in reversed(digits):
        span *= radix
        z = _staged_pass(z, n, radix, span, inverse=True)
    return np.concatenate([z.real, z.imag])[:r]


def _plan(asymmetric: bool):
    t = gaussian_kernel(201 / 6.0, 201).astype(np.float64)
    if asymmetric:
        t *= np.linspace(0.6, 1.4, 201)
    return make_custom_plan((8, 300), (t / t.sum()).astype(np.float32), [1.0])


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("asymmetric", [False, True])
def test_model_of_the_passes_reproduces_the_plain_version(n, asymmetric):
    plan = _plan(asymmetric)
    rows = (np.random.default_rng(n).random((5, n)) * 255).astype(np.float32)
    got = _model_conv(rows, n, plan.row)
    want = _conv_rows_einsum(torch.from_numpy(rows), n, plan.row).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("n, segment", [(32768, 16384), (65536, 8192), (131072, 16384),
                                        (32768, 8192), (65536, 16384)])
def test_model_of_the_cluster_form_reproduces_numpy_fft(n, segment):
    """The model's forward passes alone (the cluster form's first pass, then
    a segment's radix-32 passes) leave frequency ``_kernel_bin_order(n)[p]``
    at position p, to f32 twiddle rounding, and the adjoint passes undo
    them (times n); with the kernels' segments and with the probe's other
    segment lengths."""
    z = np.array([1, 1j]) @ np.random.default_rng(n).standard_normal((2, n))
    x = _cluster_forward(z[None], n, segment)
    span = 1024
    _, _, wq = _tables(k3.BODY_N)
    spans = []
    for radix in k3._radices(n, segment)[2:]:
        s = span // radix
        tw = _pass_twiddle(n, span, np.outer(np.arange(radix), np.arange(s)))
        spans.append((radix, span, s, tw))
        cube = np.einsum("qm,bkms->bkqs", _dft(radix, wq), x.reshape(1, n // span, radix, s))
        x = (cube * tw).reshape(1, n)
        span = s
    want = np.fft.fft(z)[k3._kernel_bin_order(n, segment)]
    assert np.abs(x[0] - want).max() <= 1e-5 * np.abs(want).max()
    for radix, span, s, tw in reversed(spans):
        cube = x.reshape(1, n // span, radix, s) * np.conj(tw)
        x = np.einsum("mq,bkqs->bkms", np.conj(_dft(radix, wq)), cube).reshape(1, n)
    back = _cluster_inverse(x, n, segment)[0] / n
    assert np.abs(back - z).max() <= 1e-5 * np.abs(z).max()


def _correlation64(rows, n, axis_plan):
    """Float64 circular correlation of (R, n) rows by the axis taps."""
    h = np.conj(np.fft.fft(wrap_centered(axis_plan.taps, n).astype(np.float64)))
    return np.fft.ifft(np.fft.fft(rows.astype(np.float64), axis=-1) * h, axis=-1).real


def _first_digits_reproduce_numpy_fft(n):
    """The first passes over spans past ``BODY_N`` (``_first_digits``),
    then a segment's body passes, leave frequency ``_kernel_bin_order(n)[p]``
    at position p (to f32 twiddle rounding); the adjoint passes undo them
    (times n)."""
    z = (np.array([1, 1j]) @ np.random.default_rng(n).standard_normal((2, n)))[None]
    _, _, wq = _tables(k3.BODY_N)
    span, x, spans = n, z, []
    for radix in k3._radices(n):
        if span > k3.BODY_N:
            x = _staged_pass(x, n, radix, span, inverse=False)
        else:
            s = span // radix
            tw = _pass_twiddle(n, span, np.outer(np.arange(radix), np.arange(s)))
            spans.append((radix, span, s, tw))
            cube = np.einsum("qm,bkms->bkqs", _dft(radix, wq), x.reshape(1, n // span, radix, s))
            x = (cube * tw).reshape(1, n)
        span //= radix
    want = np.fft.fft(z[0])[k3._kernel_bin_order(n)]
    assert np.abs(x[0] - want).max() <= 1e-5 * np.abs(want).max()
    for radix, span, s, tw in reversed(spans):
        cube = x.reshape(1, n // span, radix, s) * np.conj(tw)
        x = np.einsum("mq,bkqs->bkms", np.conj(_dft(radix, wq)), cube).reshape(1, n)
    span = k3.BODY_N
    for radix in reversed(_first_digits(n)):
        span *= radix
        x = _staged_pass(x, n, radix, span, inverse=True)
    assert np.abs(x[0] / n - z[0]).max() <= 1e-5 * np.abs(z).max()


@pytest.mark.parametrize("n", STAGED_LENGTHS)
def test_model_of_the_staged_form_reproduces_numpy_fft(n):
    """The staged form's first passes and its segments' body passes."""
    _first_digits_reproduce_numpy_fft(n)


def test_model_of_the_wide_form_reproduces_numpy_fft():
    """The wide cluster form's radix-16 pass over stride ``BODY_N`` (n
    262144) and its segments' body passes, in the bin order the host plans
    for the cluster form there (C 16, then the segment's digits)."""
    assert k3._radices(WIDE_N) == [16, 16, 32, 32] and _first_digits(WIDE_N) == [16]
    _first_digits_reproduce_numpy_fft(WIDE_N)


@pytest.mark.parametrize("asymmetric", [False, True])
def test_model_of_the_wide_form_against_a_float64_correlation(asymmetric):
    """The whole wide kernel on 3 rows (a zero row rides along) with the
    host's H in its bin order, within 1e-3 at 0..255 scale of the float64
    ``np.fft`` correlation."""
    plan = _plan(asymmetric)
    rows = (np.random.default_rng(7 + asymmetric).random((3, WIDE_N)) * 255).astype(np.float32)
    got = _model_conv(rows, WIDE_N, plan.row)
    np.testing.assert_allclose(got, _correlation64(rows, WIDE_N, plan.row), rtol=0, atol=1e-3)


@pytest.mark.parametrize("n, asymmetric, rows", [
    (524288, False, 3), (524288, True, 3), (1048576, True, 1)])
def test_model_of_the_staged_form_against_a_float64_correlation(n, asymmetric, rows):
    """The whole staged kernel (odd row counts: a zero row rides along)
    with the host's H in its bin order, within 1e-3 at 0..255 scale of the
    float64 ``np.fft`` correlation."""
    plan = _plan(asymmetric)
    rows = (np.random.default_rng(n + asymmetric).random((rows, n)) * 255).astype(np.float32)
    got = _model_conv(rows, n, plan.row)
    np.testing.assert_allclose(got, _correlation64(rows, n, plan.row), rtol=0, atol=1e-3)


# rows of the frames the staged form serves: the 1400 x 262000 float
# plane's 1400 rows (n 524288), 16384 rows of 524288 (96 GB of rows, output
# and scratch) and 8192 rows of 2^20
STAGED_ROWS = [(524288, 1400), (524288, 16384), (1048576, 8192)]


@pytest.mark.parametrize("n, rows", STAGED_ROWS)
def test_staged_mapping_covers_each_position_once(n, rows):
    """``fft_conv_rows_staged_pass_kernel``'s butterflies touch every
    position of a pair's transform once a pass; the twiddle exponents stay
    below n (the high table's index below n / 128); the digits multiply to
    n / ``BODY_N`` and leave segments of ``BODY_N``. Offsets: positions in a
    row stay int (below 2^31), while a pair's scratch offset (pair n +
    position) and a row's (row dim) pass 2^31 at the larger row counts, so
    the kernel takes them, and its thread index, as 64-bit (int64 here);
    the grids fit (blocks under 2^31, the segment pass's (R + 1) / 2 x P
    blocks too)."""
    digits = k3.staged_digits(n)
    assert np.prod(digits) == n // k3.BODY_N and set(digits) <= {8, 16, 32}
    assert k3._radices(n)[:len(digits)] == digits
    half, span = (rows + 1) // 2, n
    for radix in digits:
        j, pos = _staged_butterflies(n, radix, span)
        seen = np.zeros(n, np.int64)
        np.add.at(seen, pos.ravel(), 1)
        assert (seen == 1).all(), (n, radix, span)
        e = _staged_exponents(n, radix, span)
        assert e.max() < n and (e >> 7).max() < n // 128
        assert pos.max() < 2**31 and (np.arange(radix) * j.max()).max() < span
        threads = half * (n // radix)
        assert -(-threads // 256) < 2**31
        # the last thread's pair, and its scratch offset in float2
        pair = np.int64(threads - 1) // (n // radix)
        assert pair == half - 1
        assert pair * n + pos.max() == half * n - 1
        span //= radix
    assert span == k3.BODY_N
    assert half * (n // k3.BODY_N) < 2**31
    last_row = np.int64(rows - 1) * n  # K3: dim n
    if rows * n > 2**31:  # an int32 offset would wrap here: the kernel's are 64-bit
        assert last_row >= 2**31 and last_row.astype(np.int32) != last_row
    assert np.int64(half) * n * 8 < 2**63


@pytest.mark.parametrize("n", LENGTHS + STAGED_LENGTHS)
def test_two_level_twiddles_within_the_stated_bound(n):
    e = np.arange(n)
    exact = np.exp(-2j * np.pi * e / n)
    assert np.abs(_twiddle(n, e) - exact).max() <= TWIDDLE_BOUND
    _, _, wq = _tables(min(n, k3.BODY_N))
    q = n // (n & -n)
    assert np.abs(wq[:q] - np.exp(-2j * np.pi * np.arange(q) / q)).max() <= 2.0 ** -24
    assert not wq[q:].any()


@pytest.mark.parametrize("n", [m for m in LENGTHS if m <= 16384]
                         + [512, 1024, 2048, 9216, 10240, 12288, 13312, 14336])
def test_thread_mapping_covers_each_position_once_without_conflicts(n):
    threads = n // 32
    sched = _schedule(n)
    assert [r for r, *_ in sched] == k3._radices(n)
    assert np.prod([r for r, *_ in sched]) == n
    for radix, count, s_log2, tw_mul in sched:
        seen = np.zeros(n, int)
        banks = {}
        for b, j, pos in _butterflies(n, radix, count, s_log2):
            seen[pos] += 1
            assert (radix - 1) * j * tw_mul < n  # twiddle exponents
            banks.setdefault(b // 32 if b < threads else None, []).append(
                (pos + (pos >> 5)) % 32)
        assert (seen == 1).all(), (radix, s_log2)
        if threads >= 32:
            # every warp's first butterflies: 32 lanes, each value m in a
            # distinct bank (the padded layout i + (i >> 5))
            for warp, rows in banks.items():
                if warp is not None:
                    lanes = np.array(rows)  # (32, radix)
                    for m in range(radix):
                        assert len(set(lanes[:, m])) == 32, (radix, warp, m)


def _slab_index(n, q, k, jl, segment=None):
    """``slab_index<M, C>``: slab (q, k) of a CTA's slabs, inside its own
    sub-block k, padded as ``sidx``."""
    _, _, _, _, _, jj = _cluster_geometry(n, segment)
    i = k * 1024 + q * jj + jl
    return i + (i >> 5)


def _half_warps_conflict_free(slots):
    """An 8-byte access by a warp's 32 lanes runs as two half-warps; each is
    free of bank conflicts when its 16 slots fall in distinct bank pairs."""
    slots = np.asarray(slots)
    return all(len(set(slots[h:h + 16] % 16)) == 16 for h in (0, 16))


# (n, segment): the kernels' (``cluster_segment``) and the other segment
# lengths that probes/k3_cluster_variants.py times beside them
CLUSTER_CASES = [(32768, 16384), (65536, 8192), (131072, 16384), (32768, 8192),
                 (65536, 16384)]
SM_SHARED = 233472  # bytes of shared memory an H100 SM gives its CTAs
CTA_RESERVED = 1024  # and keeps for each CTA


def _cluster_smem(m_len, c):
    """``kClusterSmem<M, C>``: the padded segment, the body's tables, the
    W_1024 table, the first pass's W_n tables and the mbarriers, 8 bytes an
    entry."""
    return (8 * (m_len + m_len // 32) + 8 * 272 + 8 * 1024 + 8 * (128 + c * m_len // 128)
            + 8 * (2 * m_len // 1024 + 1))


@pytest.mark.parametrize("n, segment", CLUSTER_CASES)
def test_cluster_pass_mapping_covers_each_position_once(n, segment):
    """``fft_conv_rows_cluster_kernel``'s mapping: CTA r's thread t is warp
    w, lane l, group lane g = l / (32 / G), j = r J + w (32 / G) + l % (32 /
    G). Over the cluster: the first pass loads every position of the row
    once; a shuffle's source lane is in the same warp, on the same j, at
    group lane (g + d) mod G; the first pass's stores fill every segment
    position of every CTA once (a warp's lanes bound for one CTA on
    consecutive positions); the inverse radix-32 pass pushes every slab slot
    of every CTA once and the last pass reads each once, both free of bank
    conflicts; the last pass stores every position once. The twiddle
    exponents stay below 2^31 before their mask and the W_(n/1024) entries
    inside the table. Each sub-block's and the slabs' mbarrier sees exactly
    the values it expects arrive from the other CTAs. CTAs an SM: two at
    segments of 8192 (shared memory and 128 registers a thread), one at
    16384."""
    m_len, c, grp, mg, qg, jj = _cluster_geometry(n, segment)
    r0, threads, lg = m_len // 1024, m_len // 32, 32 // grp
    assert c in (2, 4, 8) and c * m_len == n and k3._radices(n, segment)[:2] == [c, r0]
    assert c * mg == 32 and qg * r0 == 32 and threads // 32 == r0
    resident = k3.BODY_N // m_len
    assert resident * (_cluster_smem(m_len, c) + CTA_RESERVED) <= SM_SHARED
    assert resident * threads * 128 <= 65536
    loads, stores = np.zeros(n, int), np.zeros(n, int)
    segs = np.zeros((c, m_len), int)
    # values each CTA's mbarriers see arrive from the other CTAs: sub-block
    # k's (the first pass) and the slabs' (the inverse radix-32 pass)
    remote_sub, remote_slab = np.zeros((c, r0), int), np.zeros(c, int)
    pushed, read = np.zeros((c, m_len + m_len // 32), int), np.zeros((c, m_len + m_len // 32), int)
    assert 8 * (c - 1) * (r0 - 1) < n // 128  # the W_(n/1024) entries
    for r in range(c):
        t = np.arange(threads)
        warp, lane = t >> 5, t & 31
        g, jl = lane // lg, (t >> 5) * lg + lane % lg
        j = r * jj + jl
        assert (jl < jj).all()
        for mi in range(mg):
            for cc in range(c):
                np.add.at(loads, j + 1024 * (g * mg + mi) + m_len * cc, 1)
                np.add.at(stores, j + 1024 * (g * mg + mi) + m_len * cc, 1)
        for d in range(1, grp):
            src = (lane + d * lg) & 31
            assert (g[warp * 32 + src] == (g + d) % grp).all()
            assert (j[warp * 32 + src] == j).all()
        for e in range(qg):
            q = qg * g + e
            step = (c * j + g * (n // grp)) % n
            for k in range(r0):
                assert (q * j + k * step < 2**31).all()  # no int overflow before the mask
                np.add.at(segs, (q, j + 1024 * k), 1)
                np.add.at(remote_sub, (q[q != r], k), 1)
                for w in range(threads // 32):
                    lanes = slice(32 * w, 32 * w + 32)
                    for dst in set(q[lanes]):
                        pos = (j + 1024 * k)[lanes][q[lanes] == dst]
                        assert (np.diff(pos) == 1).all()
                slots = _slab_index(n, q, k, jl, segment)
                np.add.at(read, (r, slots), 1)
                for w in range(threads // 32):
                    assert _half_warps_conflict_free(slots[32 * w:32 * w + 32])
        # the inverse radix-32 pass of CTA r: sub-block k = warp, output m of
        # j = lane + 32 m goes to CTA m / (32 / C)
        for m in range(32):
            dst, jl_dst = m // (32 // c), lane + 32 * (m % (32 // c))
            assert (dst * jj + jl_dst == lane + 32 * m).all()
            slots = _slab_index(n, r, warp, jl_dst, segment)
            # a slab lands in the receiver's sub-block `warp` alone: only
            # the receiver's warp `warp` reads there first
            assert ((slots >= (1024 + 32) * warp) & (slots < (1024 + 32) * (warp + 1))).all()
            np.add.at(pushed, (dst, slots), 1)
            remote_slab[dst] += threads if dst != r else 0
            for w in range(threads // 32):
                assert _half_warps_conflict_free(slots[32 * w:32 * w + 32])
    assert (loads == 1).all() and (stores == 1).all() and (segs == 1).all()
    assert (pushed == read).all() and pushed.sum() == c * m_len and pushed.max() == 1
    # what the kernel's mbarriers expect (mbar_expect_tx, 8 bytes a value):
    # a wrong count would leave a wait unfinished
    assert (remote_sub == 1024 - jj).all()
    assert (remote_slab == (c - 1) * r0 * jj).all()
    assert 8 * (c - 1) * r0 * jj < 2**20  # an mbarrier's transaction count


def _sidx(i):
    """The padded shared-memory slot of position i (``sidx``)."""
    return np.asarray(i) + (np.asarray(i) >> 5)


def _wide_smem():
    """``kWideSmem``: the padded segment, the body's tables, the W_1024
    table and the first pass's W_n tables, 8 bytes an entry."""
    return 8 * (16384 + 16384 // 32) + 8 * 272 + 8 * 1024 + 8 * (128 + WIDE_N // 128)


@pytest.mark.parametrize("pairs, clusters", [(3240, 7), (3, 7), (16, 7)])
def test_wide_cluster_mapping_covers_each_position_once(pairs, clusters):
    """``fft_conv_rows_wide_kernel``'s mapping at n 262144: 16 CTAs of 512
    threads, thread t of CTA r on j = r B + t + u T (B 1024, T 512, u < 2).
    The first pass loads every row position once, a warp 32 consecutive
    positions (128 contiguous bytes of a row a load), and stores output q
    of j at position j of CTA q's segment, each position of each segment
    once over the cluster, a warp's store 32 consecutive slots of one CTA
    (256 contiguous bytes, free of bank conflicts); the last pass reads
    position j of every segment (a warp 32 consecutive slots of one CTA) and
    stores every row position once. Twiddle exponents stay below n. One CTA
    an SM. The persistent clusters (min(pairs, the clusters the card holds))
    take pairs c, c + clusters, ...: each pair once, each cluster at least
    one."""
    c, m_len, threads = 16, k3.BODY_N, 512
    b_len = m_len // c
    assert c * m_len == WIDE_N == k3.CLUSTER_LONGEST and b_len == 2 * threads
    assert k3.cluster_segment(WIDE_N) == m_len
    assert _wide_smem() + CTA_RESERVED <= SM_SHARED < 2 * (_wide_smem() + CTA_RESERVED)
    grid = min(pairs, clusters)
    taken = np.zeros(pairs, int)
    for cl in range(grid):
        assert len(range(cl, pairs, grid)) >= 1
        taken[cl::grid] += 1
    assert (taken == 1).all()
    t = np.arange(threads)
    loads, stores = np.zeros(WIDE_N, int), np.zeros(WIDE_N, int)
    segs, reads = np.zeros((c, m_len), int), np.zeros((c, m_len), int)
    for r in range(c):
        for u in range(2):
            j = r * b_len + t + u * threads
            for m in range(c):
                np.add.at(loads, j + m * m_len, 1)
                np.add.at(stores, j + m * m_len, 1)
                assert (np.diff((j + m * m_len).reshape(-1, 32), axis=1) == 1).all()
            for q in range(c):
                assert (q * j < WIDE_N).all()  # W_n^(q j)
                np.add.at(segs[q], j, 1)
                np.add.at(reads[q], j, 1)
                for w in range(threads // 32):
                    assert _half_warps_conflict_free(_sidx(j[32 * w:32 * w + 32]))
    assert (loads == 1).all() and (stores == 1).all()
    assert (segs == 1).all() and (reads == 1).all()


@pytest.mark.parametrize("n", LENGTHS + STAGED_LENGTHS)
def test_kernel_bin_order_is_a_permutation(n):
    order = k3._kernel_bin_order(n)
    assert order.shape == (n,) and (np.sort(order) == np.arange(n)).all()


@pytest.mark.parametrize("n", CLUSTER_LENGTHS)
def test_cluster_inner_twiddles_are_rounded_roots(n):
    """The first pass's W_(n/1024)^e, e < n / 1024, are the W_n^(128 h)
    table's entries 8 e: each one float64 root rounded to f32 (within
    2^-24)."""
    e = np.arange(n // 1024)
    got = _tables(n)[1][8 * e]
    assert np.abs(got - np.exp(-2j * np.pi * e / (n // 1024))).max() <= 2.0 ** -24


def test_kernel_lengths_are_the_planned_ones():
    from blur_algorithms_tpu_torch.ops.fft_mxu import transform_length

    planned = {max(256, 1 << k) for k in range(8, 15)} | {1024 * k for k in range(5, 17)}
    assert {n for n in range(1, 16385) if k3.kernel_length(n)} == planned
    for need in range(300, 16385, 97):
        pad = min(100, need // 4)
        taps = gaussian_kernel(pad / 3.0, 2 * pad + 1)
        plan = make_custom_plan((9, need - 2 * pad), taps, [1.0])
        assert k3.kernel_length(transform_length(plan.row))
    with pytest.raises(ValueError):
        k3._radices(3072)
    # past 16384 the powers of two the cluster form takes, then the staged
    # form's, and nothing else
    assert {n for n in range(16385, k3.CLUSTER_LONGEST + 1) if k3.kernel_length(n)} == set(
        CLUSTER_LENGTHS)
    assert {n for n in range(k3.CLUSTER_LONGEST + 1, (1 << 20) + 1)
            if k3.kernel_length(n)} == {1 << 19, 1 << 20}
    assert k3.kernel_length(1 << 30) and not k3.kernel_length(1 << 31)
    # the staged form also takes 262144 (on a card that places no cluster of
    # 16), with the wide cluster form's one digit; not below it
    assert k3.staged_digits(k3.CLUSTER_LONGEST) == [16]
    with pytest.raises(ValueError):
        k3.staged_digits(k3.CLUSTER_LONGEST // 2)
    for need in (16385, 20000, 33000, 70000, 131072, 140000, 300000, 600000):
        taps = gaussian_kernel(30.0, 201)
        plan = make_custom_plan((9, need - 200), taps, [1.0])
        assert k3.kernel_length(transform_length(plan.row))


def _plane_split(plane: int, h: int, wf: int, odd_base: int) -> tuple[int, int, int]:
    """(head, pairs, tail) of one plane as the K5 kernel splits it: a
    scalar head value where the plane's first value is not 16-byte aligned
    (the tensor's base 8 bytes past a boundary, ``odd_base`` 1, or the
    plane starting at an odd value), 16-byte pairs, and a scalar tail value
    where the count after the head is odd."""
    m = h * wf
    head = (odd_base + plane * m) & 1
    return head, (m - head) >> 1, (m - head) & 1


@pytest.mark.parametrize("h, wf", [(40, 33), (41, 33), (6, 8), (2160 + 64, 1985)])
@pytest.mark.parametrize("odd_base", [0, 1])
@pytest.mark.parametrize("planes, grid_y_cap", [(1, 65535), (3, 65535), (5, 2)])
def test_k5_geometry_covers_each_value_once(monkeypatch, h, wf, odd_base, planes,
                                            grid_y_cap):
    monkeypatch.setattr(k5, "_MAX_GRID_Y", grid_y_cap)
    grid_x, grid_y = k5.launch_geometry(planes, h, wf)
    assert grid_y == min(planes, grid_y_cap)
    m = h * wf
    seen = np.zeros((planes, m), int)
    ks = np.arange(grid_x * k5.THREADS)  # the kernel's k: block * THREADS + thread
    assert ks.size * 2 >= m
    for y in range(grid_y):
        for p in range(y, planes, grid_y):  # the kernel's plane loop
            head, pairs, tail = _plane_split(p, h, wf, odd_base)
            k = ks[ks < pairs]
            first = head + 2 * k
            assert ((odd_base + p * m + first) % 2 == 0).all()  # 16-byte aligned
            seen[p, first] += 1
            seen[p, first + 1] += 1
            if head:
                seen[p, 0] += 1
            if tail:
                seen[p, m - 1] += 1
    assert (seen == 1).all()
