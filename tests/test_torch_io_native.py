"""The port's host utilities against the JAX package's on the CPU: image
I/O (``utils/io``: PPM, NPY and PNG files and in-memory codecs,
byte-equal), the native runtime (``utils/native`` over
``native/libblurfx.so`` and its NumPy path: equal) and the kernel library
cache (``utils/cache``).
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu import oracle as j_oracle  # noqa: E402
from blur_algorithms_tpu.utils import io as j_io  # noqa: E402
from blur_algorithms_tpu.utils import native as j_native  # noqa: E402
from blur_algorithms_tpu_torch import oracle  # noqa: E402
from blur_algorithms_tpu_torch.utils import build, cache, io, native  # noqa: E402


@pytest.fixture
def img():
    return np.random.default_rng(0).integers(0, 256, (37, 53, 3), dtype=np.uint8)


@pytest.mark.parametrize("ext", ["ppm", "npy", "png"])
def test_files_byte_equal_to_jax(tmp_path, img, ext):
    if ext == "png":
        pytest.importorskip("PIL")
    ours, theirs = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
    io.write_image(str(ours), img)
    j_io.write_image(str(theirs), img)
    assert ours.read_bytes() == theirs.read_bytes()
    np.testing.assert_array_equal(io.read_image(str(ours)), img)
    np.testing.assert_array_equal(io.read_image(str(theirs)), j_io.read_image(str(theirs)))


@pytest.mark.parametrize("fmt", ["ppm", "npy", "png"])
def test_codecs_byte_equal_to_jax(img, fmt):
    if fmt == "png":
        pytest.importorskip("PIL")
    data = io.encode_image(img, fmt)
    assert data == j_io.encode_image(img, fmt)
    np.testing.assert_array_equal(io.decode_image(data, fmt), img)
    np.testing.assert_array_equal(io.decode_image(data, fmt), j_io.decode_image(data, fmt))


def test_ppm_with_comments_and_refusals(tmp_path, img):
    data = b"P6\n# a comment\n53 37\n# another\n255\n" + img.tobytes()
    np.testing.assert_array_equal(io.decode_image(data, "ppm"), img)
    np.testing.assert_array_equal(io.decode_image(data, "ppm"), j_io.decode_image(data, "ppm"))
    with pytest.raises(ValueError, match="magic"):
        io.decode_image(b"P5\n2 2\n255\n" + bytes(4), "ppm")
    with pytest.raises(ValueError, match="maxval"):
        io.decode_image(b"P6\n1 1\n65535\n" + bytes(6), "ppm")
    np.save(tmp_path / "f.npy", img.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        io.read_image(str(tmp_path / "f.npy"))


def test_png_without_codecs_raises(img):
    import builtins

    real = builtins.__import__

    def no_codecs(name, *a, **k):
        if name in ("PIL", "cv2"):
            raise ImportError(name)
        return real(name, *a, **k)

    with mock.patch.object(builtins, "__import__", no_codecs):
        with pytest.raises(RuntimeError, match="no codec"):
            io.encode_image(img, "png")
        assert io.decode_image(io.encode_image(img, "ppm"), "ppm").shape == img.shape


@pytest.mark.parametrize("pads", [((4, 5), (3, 6)), ((0, 0), (2, 2)), ((11, 11), (8, 8)),
                                  ((15, 2), (1, 12)), ((0, 219), (0, 203))])
@pytest.mark.parametrize("lib", [True, False], ids=["library", "numpy"])
def test_reflect101_equals_jax(monkeypatch, pads, lib):
    if lib and not native.available():
        pytest.skip("native/libblurfx.so not built (make -C native)")
    if not lib:
        monkeypatch.setattr(native, "_load", lambda: None)
    a = np.random.default_rng(1).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    got = native.reflect101_u8(a, pads)
    np.testing.assert_array_equal(got, j_native.reflect101_u8(a, pads))
    np.testing.assert_array_equal(got, oracle.reflect_101_np(a, list(pads), axes=[0, 1]))


@pytest.mark.parametrize("lib", [True, False], ids=["library", "numpy"])
def test_crc32_and_layout_equal_jax(monkeypatch, img, lib):
    if lib and not native.available():
        pytest.skip("native/libblurfx.so not built (make -C native)")
    if not lib:
        monkeypatch.setattr(native, "_load", lambda: None)
    data = np.frombuffer(b"123456789", dtype=np.uint8)
    assert native.crc32(data) == 0xCBF43926
    assert native.crc32(data[:3], data[3:]) == 0xCBF43926
    assert native.crc32(img) == j_native.crc32(img) == j_oracle.crc32c(img) == oracle.crc32c(img)
    np.testing.assert_array_equal(native.deinterleave(img), j_native.deinterleave(img))
    planar = (np.random.default_rng(2).random((3, 20, 30)) * 300 - 20).astype(np.float32)
    np.testing.assert_array_equal(native.interleave(planar), j_native.interleave(planar))


def test_cache_loads_the_kernel_library_on_the_card_only(monkeypatch):
    loads = []
    monkeypatch.setattr(build, "load_library", lambda: loads.append(1))
    monkeypatch.delenv("BLUR_TPU_NO_COMPILE_CACHE", raising=False)
    assert cache.enable_persistent_cache("cpu") is None and not loads
    assert cache.enable_persistent_cache("cuda") == str(build.build_dir())
    assert loads == [1]
    for value, disabled in (("1", True), ("true", True), ("0", False), ("", False)):
        monkeypatch.setenv("BLUR_TPU_NO_COMPILE_CACHE", value)
        assert (cache.enable_persistent_cache("cuda") is None) == disabled
    assert loads == [1, 1, 1]
