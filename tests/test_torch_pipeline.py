"""The port's ``models.BlurPipeline`` (bucketing, ``stream``, ``warmup``,
``ensure_compiled``, ``stats``), ``GaussianBlur``, ``FastBoxBlur`` and
``SpectrumAnalyzer`` against the JAX package's on the CPU: bucketed results
``torch.equal`` to the port's exact-shape ``blur_u8`` (same fused route),
within 1 count of the JAX pipeline, the same bucket targets and stats; and
the entry points' device rule (no card and no ``"cpu"``: ``RuntimeError``).
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu.models import pipeline as j_pipeline  # noqa: E402
import blur_algorithms_tpu_torch as port  # noqa: E402
from blur_algorithms_tpu_torch.models import (  # noqa: E402
    BlurPipeline,
    FastBoxBlur,
    GaussianBlur,
    SpectrumAnalyzer,
)
from blur_algorithms_tpu_torch.models import pipeline  # noqa: E402
from blur_algorithms_tpu_torch.utils import io  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread: beside XLA's CPU threads (and the suite's other
    workers) the plain versions' tap-by-tap ops otherwise spin against them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CPU = {"device": "cpu"}


def _img(rng, h, w):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def _close(got, want):
    got, want = np.asarray(got).astype(int), np.asarray(want).astype(int)
    assert got.shape == want.shape and np.abs(got - want).max() <= 1


def test_ensure_compiled_once_per_bucket(rng):
    pipe = GaussianBlur(3.0, bucket=64, **CPU)  # r 6 margin folds into the bucket
    assert pipe.ensure_compiled(55, 55) is True  # (55 + 6 -> 64, 64)
    assert pipe.ensure_compiled(50, 53) is False  # the same (64, 64) bucket
    assert pipe.stats == {"calls": 0, "distinct_buckets": 1}
    out = pipe(_img(rng, 55, 55))
    assert out.shape == (55, 55, 3) and isinstance(out, torch.Tensor)
    assert pipe.stats == {"calls": 1, "distinct_buckets": 1}


def test_bucketing_and_stats_equal_jax(rng):
    ours, theirs = GaussianBlur(3.0, bucket=64, **CPU), j_pipeline.GaussianBlur(3.0, bucket=64)
    for h, w in [(60, 60), (64, 64), (50, 63), (61, 58), (70, 70), (100, 120)]:
        assert ours._bucketed(h, w) == theirs._bucketed(h, w)
        f = _img(rng, h, w)
        _close(ours(f), theirs(f))
    assert ours.stats == theirs.stats == {"calls": 6, "distinct_buckets": 3}


@pytest.mark.parametrize("sigma", [2.0, 10.0, 50.0])
def test_bucketed_equals_exact_shape_blur_u8(rng, sigma):
    """Margin-inclusive bucketing is exact, seam included (sigma 50 on 90x77
    is dim-clamped: the pipeline keeps the exact shape by itself)."""
    f = _img(rng, 90, 77)
    pipe = GaussianBlur(sigma, bucket=64, **CPU)
    got = pipe(f)
    assert torch.equal(got, port.blur_u8(torch.from_numpy(f), sigma))
    assert torch.equal(got, GaussianBlur(sigma, exact=True, **CPU)(f))
    _close(got, j_pipeline.GaussianBlur(sigma, bucket=64)(f))


def test_bucket_targets_equal_jax_including_the_dim_clamp():
    for sigma in (1.0, 3.0, 10.0, 50.0, (2.0, 9.0)):
        ours, theirs = GaussianBlur(sigma, bucket=64, **CPU), j_pipeline.GaussianBlur(sigma, bucket=64)
        for h, w in [(90, 77), (64, 64), (31, 200), (257, 129)]:
            assert ours._bucketed(h, w) == theirs._bucketed(h, w), (sigma, h, w)
    assert GaussianBlur(50.0, bucket=64, **CPU)._bucketed(90, 77) == (90, 77)


def test_box_pipeline_against_jax(rng):
    f = _img(rng, 64, 72)
    ours, theirs = FastBoxBlur(2.0, bucket=64, **CPU), j_pipeline.FastBoxBlur(2.0, bucket=64)
    assert ours._bucketed(64, 72) == theirs._bucketed(64, 72)
    got = ours(f)
    _close(got, theirs(f))
    assert torch.equal(got, port.blur_u8(torch.from_numpy(f), 2.0, engine="box"))


def test_exact_mode_matches_the_oracle_and_batches(rng):
    batch = np.stack([_img(rng, 70, 90) for _ in range(2)])
    got = GaussianBlur(5.0, exact=True, **CPU)(batch)
    assert got.shape == batch.shape
    _close(got[1], oracle.blur_u8(batch[1], 5.0))


def test_spectrum_analyzer_against_jax(rng):
    f = _img(rng, 48, 48)
    ours, theirs = SpectrumAnalyzer(**CPU), j_pipeline.SpectrumAnalyzer()
    spec, jspec = ours(f), np.asarray(theirs(f))
    assert spec.shape == jspec.shape and spec.shape[0] == 3
    # log-magnitudes: compare the magnitudes (as tests/test_torch_fft_conv.py)
    a, b = 10.0 ** (spec.numpy() / 20.0), 10.0 ** (jspec / 20.0)
    np.testing.assert_allclose(a, b, rtol=0, atol=4e-6 * b.max())
    vis = ours.to_image(spec)
    assert vis.dtype == np.uint8 and vis.shape[-1] == 3
    np.testing.assert_array_equal(vis, theirs.to_image(spec.numpy()))
    _close(vis, theirs.to_image(jspec))
    with pytest.raises(ValueError, match="one frame"):
        ours.to_image(torch.stack([spec] * 2))


def test_stream_mixed_sizes_paths_and_arrays_in_order(rng, tmp_path):
    pipe = BlurPipeline(3.0, bucket=64, **CPU)
    frames = [_img(rng, 100, 130), _img(rng, 60, 200), _img(rng, 40, 56), _img(rng, 64, 64)]
    paths = []
    for i, f in enumerate(frames[:2]):
        paths.append(str(tmp_path / f"f{i}.ppm"))
        io.write_image(paths[-1], f)
    items = [paths[0], frames[2], paths[1], frames[3]]
    out = list(pipe.stream(items, prefetch=2))
    assert [k for k, _ in out] == [paths[0], 1, paths[1], 3]  # input order
    for (_, got), f in zip(out, [frames[0], frames[2], frames[1], frames[3]]):
        assert torch.equal(got, port.blur_u8(torch.from_numpy(f), 3.0))
    theirs = dict(j_pipeline.BlurPipeline(3.0, bucket=64).stream(items, prefetch=2))
    for k, got in out:
        _close(got, theirs[k])


def test_stream_empty_single_and_grayscale(rng):
    pipe = GaussianBlur(2.0, exact=True, **CPU)
    assert list(pipe.stream([], prefetch=2)) == []
    only = _img(rng, 24, 24)
    [(k, out)] = list(pipe.stream([only], prefetch=4))
    assert k == 0 and out.shape == only.shape
    [(_, gray)] = list(pipe.stream([only[..., 0]]))
    assert gray.shape == (24, 24, 1)


def test_stream_reuses_the_warmup_buckets(rng):
    """The stager's host pad marks its frames ``prebucketed``: without it a
    bucket-shaped frame would re-bucket (``_bucketed`` is not idempotent)."""
    pipe = BlurPipeline(3.0, bucket=64, **CPU)
    pipe.warmup([(100, 130), (60, 200)])
    n = pipe.stats["distinct_buckets"]
    frames = [_img(rng, 100, 130), _img(rng, 60, 200)]
    outs = dict(pipe.stream(frames))
    assert pipe.stats["distinct_buckets"] == n and pipe.stats["calls"] == 2
    for i, f in enumerate(frames):
        assert torch.equal(outs[i], BlurPipeline(3.0, exact=True, **CPU)(f))
    bh, bw = pipe._bucketed(100, 130)
    assert pipe._bucketed(bh, bw) != (bh, bw)  # not idempotent
    padded = pipe(_img(rng, bh, bw), prebucketed=True)
    assert padded.shape == (bh, bw, 3) and pipe.stats["distinct_buckets"] == n


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_pinned_buffers_wait_for_their_copy(monkeypatch):
    """A staged buffer is handed out again only once its copy's event has
    completed; a busy one makes the pool take a new buffer."""
    made = []
    monkeypatch.setattr(pipeline.torch, "empty",
                        lambda n, **k: made.append(n) or torch.zeros(n, dtype=torch.uint8))
    pool = pipeline._PinnedPool(keep=2)
    busy, done = torch.zeros(100, dtype=torch.uint8), torch.zeros(50, dtype=torch.uint8)
    pool.give(busy, _Event(False))
    pool.give(done, _Event(True))
    assert pool.take(40) is done
    assert pool.take(80) is not busy and made == [80]
    pool._free[0][1].done = True
    assert pool.take(80) is busy
    for _ in range(4):
        pool.give(torch.zeros(1, dtype=torch.uint8), _Event(True))
    assert len(pool._free) == 2


@pytest.mark.parametrize("make", [
    lambda: BlurPipeline(3.0),
    lambda: GaussianBlur(3.0),
    lambda: FastBoxBlur(2.0),
    lambda: SpectrumAnalyzer(),
])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(make):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        BlurPipeline(3.0, device="meta")
