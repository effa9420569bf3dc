"""The plan of the K3/K3f and K5 kernels, checked on the CPU.

``csrc/fft4step.cu`` runs the FFT convolution of a pair of rows as a few
high-radix passes (radix Q, radix R0, radix-32 passes) with twiddles from a
two-level table, the multiply by H between the last forward and the first
inverse pass. A NumPy model of those passes, fed the host's tables
(``_twiddle_tables``, ``_kernel_spectrum`` in ``_kernel_bin_order``),
reproduces the plain version ``_conv_rows_einsum`` (which
``tests/test_torch_fft_mxu.py`` holds against the JAX package) within 1e-3
at 0..255 scale, the cluster form's lengths (32768, 65536, 131072: a
radix-C pass with the cluster pass's own W_n tables, then the length-16384
body with its tables on each segment) included, and ``np.fft`` at those
lengths. A model of the kernel's thread mapping checks that every
pass touches each position once, with no shared-memory bank conflict, and
that the twiddle exponents stay below n; the cluster pass's mapping over
the cluster's CTAs likewise. The two-level table's f32 product
stays within 4 * 2^-24 of the float64 root (the bound the source note
states). K5's grid and its head / pairs / tail split cover every value of
every plane once, with 16-byte-aligned pairs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu_torch.cuda_kernels import fft4step as k3  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import spectral_multiply as k5  # noqa: E402
from blur_algorithms_tpu_torch.ops.fft_mxu import _conv_rows_einsum  # noqa: E402
from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel  # noqa: E402
from blur_algorithms_tpu_torch.ops.plan import make_custom_plan  # noqa: E402

CLUSTER_LENGTHS = [32768, 65536, 131072]
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
    forms it: the cluster pass (span n past ``BODY_N``) from its own
    tables, every other pass from the tables of the block's length (n, or
    ``BODY_N`` on a segment of the cluster form)."""
    if span == n:
        return _twiddle(n, qj)
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


def _model_conv(rows: np.ndarray, n: int, axis_plan) -> np.ndarray:
    """NumPy model of the kernel: pairs (c, c + half) packed as z = a + ib,
    the forward passes (DFT, then twiddles), H in the kernel's bin order,
    the inverse passes (conjugate twiddles, then the conjugate DFT)."""
    r = rows.shape[0]
    half = (r + 1) // 2
    z = rows[:half].astype(np.complex128)
    z[: r - half] += 1j * rows[half:]
    _, _, wq = _tables(min(n, k3.BODY_N))
    spans = []
    span = n
    for radix in k3._radices(n):
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


@pytest.mark.parametrize("n", CLUSTER_LENGTHS)
def test_model_of_the_cluster_form_reproduces_numpy_fft(n):
    """The model's forward passes alone (the cluster pass, then a
    segment's body) leave frequency ``_kernel_bin_order(n)[p]`` at position
    p, to f32 twiddle rounding, and its inverse passes undo them."""
    z = np.array([1, 1j]) @ np.random.default_rng(n).standard_normal((2, n))
    x = z[None].copy()
    span = n
    _, _, wq = _tables(k3.BODY_N)
    for radix in k3._radices(n):
        s = span // radix
        tw = _pass_twiddle(n, span, np.outer(np.arange(radix), np.arange(s)))
        cube = np.einsum("qm,bkms->bkqs", _dft(radix, wq), x.reshape(1, n // span, radix, s))
        x = (cube * tw).reshape(1, n)
        span = s
    want = np.fft.fft(z)[k3._kernel_bin_order(n)]
    assert np.abs(x[0] - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("n", LENGTHS)
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


@pytest.mark.parametrize("n", CLUSTER_LENGTHS)
def test_cluster_pass_mapping_covers_each_position_once(n):
    """``fft_conv_rows_cluster_kernel``'s radix-C passes: CTA c's thread t
    takes butterflies j = c B + t + (k U + u) T (B = M / C, T = 512 threads,
    U butterflies at once, M = 16384): over the cluster every j < M once, so
    every position j + m M of the transform once; a warp's 32 lanes take 32
    consecutive j, whose segment positions i + (i >> 5) fall in distinct
    banks; the twiddle exponents q j stay below n."""
    m_len, threads = k3.BODY_N, k3.BODY_N // 32
    c = n // m_len
    assert c in (2, 4, 8) and c * m_len == n and k3._radices(n)[0] == c
    b = m_len // c
    u = 1 if c >= 8 else 8 // c  # kClusterUnroll
    assert b % (threads * u) == 0
    seen = np.zeros(n, int)
    for rank in range(c):
        for k in range(b // (threads * u)):
            for uu in range(u):
                j = rank * b + np.arange(threads) + (k * u + uu) * threads
                assert ((c - 1) * j < n).all()
                for warp in j.reshape(-1, 32):
                    assert (np.diff(warp) == 1).all() and warp[0] % 32 == 0
                    assert len(set((warp + (warp >> 5)) % 32)) == 32
                for m in range(c):
                    seen[j + m * m_len] += 1
    assert (seen == 1).all()


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
    # past 16384 the powers of two the cluster form takes, and nothing else
    assert {n for n in range(16385, k3.MAX_N + 1) if k3.kernel_length(n)} == set(
        CLUSTER_LENGTHS)
    for need in (16385, 20000, 33000, 70000, 131072):
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
