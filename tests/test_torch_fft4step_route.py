"""K3/K3f's form at transform length 262144, chosen before the launch.

At ``CLUSTER_LONGEST`` (262144) the wide cluster form needs a cluster of 16
CTAs, a non-portable size: a card that places none (a MIG slice, a Hopper
part with fewer free SMs in a GPC) runs the staged form there instead.
``fft4step._form`` decides from ``cluster_occupancy`` (patched here; the
query is cached per card and per framing), and every other length keeps its
form whatever the card places. Both forms share the digits at 262144 (16,
then the body's), so H's bin order, its spectrum and the twiddle tables do
not depend on the route. The streamer's byte estimate covers the staged
form's scratch there. The JAX package plans the same transform length for
the frames checked.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu.ops import fft_mxu as j_fft  # noqa: E402
from blur_algorithms_tpu.ops import plan as j_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fft4step as k3  # noqa: E402
from blur_algorithms_tpu_torch.ops import fft_mxu as t_fft  # noqa: E402
from blur_algorithms_tpu_torch.ops.kernels import gaussian_kernel, wrap_centered  # noqa: E402
from blur_algorithms_tpu_torch.ops.plan import make_custom_plan, make_plan  # noqa: E402

N = 262144
CARD = torch.device("cuda", 0)  # a device object only: nothing runs on it


@pytest.fixture
def occupancy(monkeypatch):
    """Patch ``cluster_occupancy`` to return the value set in the returned
    dict (key "clusters") and count the queries; the cache of the query is
    emptied before and after."""
    state = {"clusters": 0, "queries": []}

    def fake(n, framed=False):
        state["queries"].append((n, framed))
        return state["clusters"]

    monkeypatch.setattr(k3, "cluster_occupancy", fake)
    k3._wide_clusters.cache_clear()
    yield state
    k3._wide_clusters.cache_clear()


@pytest.mark.parametrize("framed", [False, True])
def test_form_at_262144_follows_the_clusters_the_card_places(occupancy, framed):
    occupancy["clusters"] = 0
    assert k3._form(N, framed, CARD) == "staged"
    assert k3._form(N, framed, CARD) == "staged"
    assert occupancy["queries"] == [(N, framed)]  # once a card and framing
    k3._wide_clusters.cache_clear()
    occupancy["clusters"] = 7
    assert k3._form(N, framed, CARD) == "wide"
    assert k3._form(N, framed, torch.device("cuda", 1)) == "wide"
    assert occupancy["queries"] == [(N, framed)] * 3  # another card: its own query


@pytest.mark.parametrize("clusters", [0, 1, 7])
def test_other_lengths_keep_their_form_whatever_the_card_places(occupancy, clusters):
    occupancy["clusters"] = clusters
    want = {256: "body", 5120: "body", 16384: "body", 32768: "cluster", 65536: "cluster",
            131072: "cluster", 524288: "staged", 1 << 20: "staged", 1 << 30: "staged"}
    for n, form in want.items():
        for framed in (False, True):
            assert k3._form(n, framed, CARD) == form, (n, framed)
    assert occupancy["queries"] == []


def _order(radices, n):
    """Digit-reversed bin order of forward passes of ``radices`` (the first
    digit the position's most significant, the frequency's least)."""
    rem, k, span, mult = np.arange(n), np.zeros(n, np.int64), n, 1
    for r in radices:
        span //= r
        k += (rem // span) * mult
        rem, mult = rem % span, mult * r
    return k


@pytest.mark.parametrize("asymmetric", [False, True])
def test_staged_and_wide_forms_share_the_bin_order_and_spectrum_at_262144(asymmetric):
    assert k3.staged_digits(N) == [16] == [N // k3.cluster_segment(N)]
    staged = k3.staged_digits(N) + k3._radices(k3.BODY_N)
    wide = [N // k3.cluster_segment(N)] + k3._radices(k3.cluster_segment(N))
    assert staged == wide == k3._radices(N) == [16, 16, 32, 32]
    order = k3._kernel_bin_order(N)
    np.testing.assert_array_equal(order, _order(staged, N))
    np.testing.assert_array_equal(order, _order(wide, N))
    assert np.array_equal(np.sort(order), np.arange(N))
    taps = gaussian_kernel(300.0, 1801).astype(np.float64)
    if asymmetric:
        taps *= np.linspace(0.6, 1.4, taps.size)
    plan = make_custom_plan((8, 200000), (taps / taps.sum()).astype(np.float32), [1.0])
    assert t_fft.transform_length(plan.row) == N
    full = np.conj(np.fft.fft(wrap_centered(plan.row.taps, N).astype(np.float64))) / N
    h, complex_h = k3._kernel_spectrum(plan.row, N, torch.device("cpu"))
    want = full[_order(staged, N)]
    assert complex_h == asymmetric
    got = h.numpy()
    if complex_h:
        np.testing.assert_array_equal(got[:, 0], want.real.astype(np.float32))
        np.testing.assert_array_equal(got[:, 1], want.imag.astype(np.float32))
    else:
        np.testing.assert_array_equal(got, want.real.astype(np.float32))
    # one table of twiddles for both: the body's, then W_n's two levels
    assert k3._twiddle_tables(N).shape == (400 + N // 128, 2)


# frames whose row transform is 262144: the 2160 x 140000 RGB strip at sigma
# 900 (one frame and four), the 3 x 2160 x 131072 float batch at sigma 400,
# an odd row count, and one plane of 2161 x 131073
FRAMES = [((2160, 140000), 900.0, 3), ((2160, 140000), 900.0, 12),
          ((2160, 131072), 400.0, 3), ((2161, 140000), 900.0, 1), ((2161, 131073), 400.0, 1)]


@pytest.mark.parametrize("shape, sigma, lead", FRAMES)
def test_estimate_covers_the_staged_scratch_at_262144(shape, sigma, lead):
    """``estimate_bytes`` reckons 12 bytes a row-point: rows in and out
    (4 + 4 bytes at most, K3f's are ``dim`` long) and the staged form's
    (R + 1) / 2 x n complex64 scratch (4 bytes a row-point, a half row more
    at an odd count) fit in it."""
    plan = make_plan(shape, sigma)
    n = t_fft.transform_length(plan.row)
    assert n == N == j_fft.transform_length(j_plan.make_plan(shape, sigma).row)
    rows, dim = lead * shape[0], plan.row.dim
    need = 2 * 4 * rows * dim + (rows + 1) // 2 * n * 8
    assert t_fft.estimate_bytes(plan, lead) >= need
