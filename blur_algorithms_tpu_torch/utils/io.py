"""Image IO for the CLI and the server (the reference used OpenCV
imread/imwrite, ``Source.cpp:623,635``).

A copy of the JAX package's ``utils/io.py`` (it imports no JAX): PIL
first, then OpenCV, each imported only when a call needs it, and binary
PPM (P6) and ``.npy`` natively, so the port reads and writes frames with
no image library at all. Where neither PIL nor OpenCV is installed, a PNG
or JPG raises ``RuntimeError``, as in JAX.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["read_image", "write_image", "decode_image", "encode_image"]


def _read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return _parse_ppm(f.read(), path)


def _parse_ppm(data: bytes, path: str = "<bytes>") -> np.ndarray:
    fields: list[bytes] = []
    idx = 0
    while len(fields) < 4:
        while idx < len(data) and data[idx : idx + 1].isspace():
            idx += 1
        if data[idx : idx + 1] == b"#":
            while idx < len(data) and data[idx] != 0x0A:
                idx += 1
            continue
        start = idx
        while idx < len(data) and not data[idx : idx + 1].isspace():
            idx += 1
        fields.append(data[start:idx])
    if fields[0] != b"P6":
        raise ValueError(f"unsupported PPM magic {fields[0]!r} in {path}")
    w, h, maxval = int(fields[1]), int(fields[2]), int(fields[3])
    if maxval != 255:
        raise ValueError(f"only maxval 255 PPM supported, got {maxval}")
    raw = data[idx + 1 : idx + 1 + w * h * 3]
    return np.frombuffer(raw, dtype=np.uint8).reshape(h, w, 3).copy()


def _write_ppm(path: str, img: np.ndarray) -> None:
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img, dtype=np.uint8).tobytes())


def read_image(path: str) -> np.ndarray:
    """Load an image as uint8 HWC (RGB order for 3-channel formats)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        img = np.load(path)
        if img.dtype != np.uint8:
            raise ValueError(f".npy image must be uint8, got {img.dtype}")
        return img
    if ext in (".ppm", ".pnm"):
        return _read_ppm(path)
    try:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except ImportError:
        pass
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"cannot read image: {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except ImportError as exc:
        raise RuntimeError(
            f"no codec for {path}; install PIL/cv2 or use .ppm/.npy"
        ) from exc


def decode_image(data: bytes, fmt: str) -> np.ndarray:
    """Decode in-memory image bytes (serving path; same codecs as files)."""
    import io as _io

    fmt = fmt.lstrip(".").lower()
    if fmt == "npy":
        img = np.load(_io.BytesIO(data))
        if img.dtype != np.uint8:
            raise ValueError(f".npy image must be uint8, got {img.dtype}")
        return img
    if fmt in ("ppm", "pnm"):
        return _parse_ppm(data)
    try:
        from PIL import Image

        with Image.open(_io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"), dtype=np.uint8)
    except ImportError:
        pass
    try:
        import cv2

        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError(f"cv2 cannot decode {fmt} bytes")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except ImportError as exc:
        raise RuntimeError(
            f"no codec for {fmt}; install PIL/cv2 or use ppm/npy"
        ) from exc


def encode_image(img: np.ndarray, fmt: str) -> bytes:
    """Encode a uint8 HWC image to in-memory bytes (serving path)."""
    import io as _io

    img = np.asarray(img, dtype=np.uint8)
    fmt = fmt.lstrip(".").lower()
    if fmt == "npy":
        buf = _io.BytesIO()
        np.save(buf, img)
        return buf.getvalue()
    if fmt in ("ppm", "pnm"):
        h, w = img.shape[:2]
        return (f"P6\n{w} {h}\n255\n".encode()
                + np.ascontiguousarray(img).tobytes())
    try:
        from PIL import Image

        buf = _io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG" if fmt in ("jpg", "jpeg")
                                  else fmt.upper())
        return buf.getvalue()
    except ImportError:
        pass
    try:
        import cv2

        ok, out = cv2.imencode(f".{fmt}", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        if not ok:
            raise IOError(f"cv2 failed to encode {fmt}")
        return out.tobytes()
    except ImportError as exc:
        raise RuntimeError(
            f"no codec for {fmt}; install PIL/cv2 or use ppm/npy"
        ) from exc


def write_image(path: str, img: np.ndarray) -> None:
    """Save a uint8 HWC image."""
    img = np.asarray(img, dtype=np.uint8)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        np.save(path, img)
        return
    if ext in (".ppm", ".pnm"):
        _write_ppm(path, img)
        return
    try:
        from PIL import Image

        Image.fromarray(img).save(path)
        return
    except ImportError:
        pass
    try:
        import cv2

        ok = cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        if not ok:
            raise IOError(f"cv2 failed to write {path}")
    except ImportError as exc:
        raise RuntimeError(
            f"no codec for {path}; install PIL/cv2 or use .ppm/.npy"
        ) from exc
