"""The port's CLI (``python -m blur_algorithms_tpu_torch``) against the JAX
package's ``cli.main`` on the same PPM, and the port's HTTP server
(``examples/serve.py``) over a socket, both with ``--device cpu`` /
``device="cpu"`` on the kernels' plain versions: outputs within 1 count of
JAX's and of the oracle; the same errors; and the no-fallback rule (no card
and no ``cpu``: ``RuntimeError``).
"""

import json
import os
import subprocess
import sys
import threading
import tomllib
import urllib.error
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu import cli as j_cli  # noqa: E402
from blur_algorithms_tpu import oracle  # noqa: E402
from blur_algorithms_tpu_torch import cli  # noqa: E402
from blur_algorithms_tpu_torch import oracle as t_oracle  # noqa: E402
from blur_algorithms_tpu_torch.examples import serve as serve_mod  # noqa: E402
from blur_algorithms_tpu_torch.utils import io  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def ppm(tmp_path, rgb_image):
    path = tmp_path / "in.ppm"
    io.write_image(str(path), rgb_image)
    return str(path)


@pytest.fixture(autouse=True)
def _no_jax_disk_cache(monkeypatch):
    # the JAX CLI would otherwise point XLA's cache at the user's ~/.cache
    monkeypatch.setenv("BLUR_TPU_NO_COMPILE_CACHE", "1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """torch on one thread: beside XLA's CPU threads (and the suite's other
    workers) the plain versions' tap-by-tap ops otherwise spin against them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(args, tmp_path, name):
    """Run the port's and the JAX CLI on the same arguments, writing
    ``ours_<name>`` and ``jax_<name>``; return both outputs' paths."""
    ours, theirs = tmp_path / f"ours_{name}", tmp_path / f"jax_{name}"
    assert cli.main([*args, "-o", str(ours), "--device", "cpu"]) == 0
    assert j_cli.main([*args, "-o", str(theirs)]) == 0
    return ours, theirs


def _close(a, b):
    a, b = np.asarray(a).astype(int), np.asarray(b).astype(int)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1


@pytest.mark.parametrize("engine, nsmooth", [
    ("1", "3"), ("2", "3"), ("3", "3"), ("4", "2"), ("5", "3"),
    ("auto", "4"), ("fft_tiles", "2x5"), ("band", "3"),
])
def test_flags_and_engines_against_jax(ppm, tmp_path, rgb_image, engine, nsmooth):
    ours, theirs = _both([engine, nsmooth, ppm], tmp_path, "out.ppm")
    got = io.read_image(str(ours))
    _close(got, io.read_image(str(theirs)))
    assert got.shape == rgb_image.shape and got.std() < rgb_image.std()


def test_box_kernel_flag_against_jax(ppm, tmp_path):
    ours, theirs = _both(["2", "3", ppm, "--kernel", "box", "--size-mode", "pow2"],
                         tmp_path, "box.ppm")
    _close(io.read_image(str(ours)), io.read_image(str(theirs)))


def test_spectrum_mode_against_jax(ppm, tmp_path):
    ours, theirs = _both(["2", "1", ppm, "--spectrum"], tmp_path, "spec.npy")
    got = np.load(str(ours))
    assert got.ndim == 3 and got.dtype == np.uint8
    _close(got, np.load(str(theirs)))


def test_sigmas_sweep_against_jax(ppm, tmp_path, rgb_image):
    ours, theirs = _both(["auto", "1", ppm, "--sigmas", "2", "5.5"], tmp_path, "sweep.ppm")
    for s, tag in ((2.0, "2"), (5.5, "5p5")):
        got = io.read_image(str(tmp_path / f"ours_sweep_s{tag}.ppm"))
        _close(got, io.read_image(str(tmp_path / f"jax_sweep_s{tag}.ppm")))
        _close(got, oracle.blur_u8(rgb_image, s))


def test_default_output_name(ppm, rgb_image):
    assert cli.main(["1", "3", ppm, "--device", "cpu"]) == 0
    _close(io.read_image(ppm[:-4] + "_blurred.ppm"), oracle.blur_u8(rgb_image, 3.0))


def test_directory_mode_against_jax(tmp_path, rgb_image):
    src = tmp_path / "frames"
    src.mkdir()
    for i, f in enumerate([rgb_image, rgb_image[:70, :64], np.ascontiguousarray(rgb_image[::-1])]):
        io.write_image(str(src / f"f{i}.ppm"), f)
    io.write_image(str(src / "f3.npy"), rgb_image[:50])
    (src / "notes.txt").write_text("not an image")
    ours, theirs = tmp_path / "ours", tmp_path / "jax"
    assert cli.main(["auto", "4", str(src), "-o", str(ours), "--device", "cpu"]) == 0
    assert j_cli.main(["auto", "4", str(src), "-o", str(theirs)]) == 0
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in theirs.iterdir()) == [
        "f0.ppm", "f1.ppm", "f2.ppm", "f3.npy"]
    for name in names:
        got = io.read_image(str(ours / name))
        _close(got, io.read_image(str(theirs / name)))
        _close(got, oracle.blur_u8(io.read_image(str(src / name)), 4.0))


@pytest.mark.parametrize("args, match", [
    (["9", "3", "{ppm}"], "unknown engine flag"),
    (["nope", "3", "{ppm}"], "unknown engine"),
    (["auto", "1", "{ppm}", "--sigmas", "2", "--spectrum"], "--sigmas"),
    (["auto", "1", "{ppm}", "--sigmas", "2", "--kernel", "box"], "--sigmas"),
    (["auto", "1", "{missing}"], "cannot read"),
    (["auto", "3x4", "{ppm}", "--spectrum"], "single sigma"),
    (["auto", "0", "{ppm}", "--spectrum"], "nsmooth > 0"),
    (["auto", "4", "{dir}", "--bench", "3"], "directory mode"),
    (["auto", "4", "{empty}"], "no images"),
    (["auto", "4", "{dir}", "-o", "{dir}"], "refusing"),
    (["auto", "4", "{ppm}", "--bench", "3"], "--device cuda"),
])
def test_errors_exit_as_in_jax(tmp_path, ppm, rgb_image, args, match):
    (tmp_path / "d").mkdir()
    (tmp_path / "e").mkdir()
    io.write_image(str(tmp_path / "d" / "a.ppm"), rgb_image)
    fill = {"ppm": ppm, "missing": str(tmp_path / "missing.ppm"), "dir": str(tmp_path / "d"),
            "empty": str(tmp_path / "e")}
    argv = [a.format(**fill) for a in args]
    with pytest.raises(SystemExit, match=match):
        cli.main([*argv, "--device", "cpu"])
    if match != "--device cuda":  # the port's own: JAX times any backend
        with pytest.raises(SystemExit):
            j_cli.main(argv)


def test_bad_nsmooth_is_an_argparse_error(ppm):
    with pytest.raises(SystemExit):
        cli.main(["auto", "5x", ppm, "--device", "cpu"])


def test_the_cli_needs_a_card_unless_asked_for_the_cpu(ppm, tmp_path):
    out = tmp_path / "o.ppm"
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["auto", "3", ppm, "-o", str(out)])
        assert not out.exists()
        assert cli.main(["auto", "3", ppm, "-o", str(out), "--device", "cpu"]) == 0


def test_module_invocation(ppm, tmp_path):
    out = tmp_path / "m.ppm"
    proc = subprocess.run(
        [sys.executable, "-m", "blur_algorithms_tpu_torch", "band", "4", ppm, "-o", str(out),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={**os.environ, "BLUR_TPU_NO_COMPILE_CACHE": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert cli.main(["band", "4", ppm, "-o", str(tmp_path / "n.ppm"), "--device", "cpu"]) == 0
    np.testing.assert_array_equal(io.read_image(str(out)), io.read_image(str(tmp_path / "n.ppm")))


def test_console_script_is_declared():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts["blur-tpu-torch"] == "blur_algorithms_tpu_torch.cli:main"


# ---------------------------------------------------------------------------
# the HTTP server


@pytest.fixture(scope="module")
def server():
    started = threading.Event()
    httpd = serve_mod.serve(port=0, started=started, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    started.wait(10)
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(10)


def _post(url, img, query, fmt="ppm"):
    req = urllib.request.Request(f"{url}/blur?{query}&format={fmt}",
                                 data=io.encode_image(img, fmt), method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        assert resp.status == 200
        return io.decode_image(resp.read(), fmt)


@pytest.mark.parametrize("query, shape, fmt, ref", [
    ("sigma=4", (256, 256, 3), "ppm", lambda f: oracle.blur_u8(f, 4.0)),
    ("sigma=2&engine=box", (120, 130, 3), "ppm", lambda f: t_oracle.box_blur_u8(f, 4)),
    # one plane (an .npy body): the 511-tap band's plain version is slow on the CPU
    ("sigma=16&engine=deriche", (260, 270, 1), "npy", lambda f: oracle.blur_u8(f, 16.0)),
])
def test_server_round_trip_matches_the_oracle(server, query, shape, fmt, ref):
    f = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    d = np.abs(_post(server, f, query, fmt).astype(int) - ref(f).astype(int))
    assert d.max() <= 1 and (d == 0).mean() > 0.95


def test_server_healthz_and_bad_requests(server):
    f = np.random.default_rng(2).integers(0, 256, (40, 48, 3), dtype=np.uint8)
    _post(server, f, "sigma=4")
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as resp:
        stats = json.loads(resp.read())
    assert stats["status"] == "ok" and stats["backend"] == "cpu" and stats["requests"] >= 1
    assert any("sigma=4" in k for k in stats["pipelines"])
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/nope", timeout=30)
    assert e.value.code == 404
    req = urllib.request.Request(f"{server}/blur?sigma=3", data=b"", method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    req = urllib.request.Request(f"{server}/blur?sigma=3&format=ppm", data=b"garbage",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(req, timeout=30)
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as resp:
        assert resp.status == 200


def test_service_warms_up_before_its_device_lock():
    service = serve_mod.BlurService(device="cpu")
    pipe = service.pipeline(3.0, "auto", "gaussian")
    seen = []
    real = pipe.ensure_compiled

    def spy(*a, **k):
        seen.append(service._device_lock.locked())
        return real(*a, **k)

    pipe.ensure_compiled = spy
    f = np.random.default_rng(3).integers(0, 256, (30, 40, 3), dtype=np.uint8)
    out = io.decode_image(service.blur(io.encode_image(f, "ppm"), "ppm", 3.0, "auto",
                                       "gaussian"), "ppm")
    assert seen == [False] and out.shape == f.shape
    assert pipe.stats == {"calls": 1, "distinct_buckets": 1}


def test_the_server_needs_a_card_unless_asked_for_the_cpu():
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_mod.serve(port=0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_mod.BlurService()
