"""Streaming blur pipelines with shape bucketing.

The port of the JAX package's ``models/pipeline.py``. There, each (shape,
sigma) pair is a distinct XLA program, so a pipeline buckets frame shapes
to avoid recompiles. Here a new shape builds no program, but it plans anew
(taps, spectra and the kernels' host tables, cached per plan) and routes
anew, so the same bucketing keeps that work bounded, and keeps the results
of the two packages comparable call for call.

``BlurPipeline`` fixes the blur configuration once and buckets incoming
frame shapes: frames are right/bottom reflect-padded up to the next bucket
(multiples of ``bucket`` per axis), blurred and cropped back. The bucket
target leaves a margin of at least one kernel support radius per axis,
which makes the cropped result the exact-shape result: every output pixel
< (h, w) reads only input rows/cols < (h + rh, w + rw), and those are by
construction the reflect-101 continuation of the true frame. In the rare
dim-clamped regime (sigma so large the kernel width clamps to the frame,
where a bigger bucket would change the taps themselves) the pipeline
plans the exact shape for that frame. ``exact=True`` disables bucketing.
The fused kernels (the AUTO default's domain) and the band and conv
engines give the exact-shape result bit for bit under the margin pad; the
FFT engines re-plan their transform length with the bucket, which can move
float rounding by one count.

The pipeline runs on ``device`` (default the card; with no card it raises
``RuntimeError`` unless ``"cpu"`` is asked for). ``stream`` overlaps the
host's work with the card's: a stager pool reads, decodes and bucket-pads
each frame on the host (``utils/native.reflect101_u8``), copies it into
page-locked memory and starts its host-to-device copy on a side CUDA
stream; the blur waits on that copy's event. On the CPU the same code runs
synchronously.
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import threading

import numpy as np
import torch

from blur_algorithms_tpu_torch import api
from blur_algorithms_tpu_torch.api import Engine, blur_u8
from blur_algorithms_tpu_torch.utils.hw import entry_device

__all__ = ["BlurPipeline", "GaussianBlur", "FastBoxBlur", "SpectrumAnalyzer"]


class _PinnedPool:
    """Page-locked host buffers for the stager's host-to-device copies.

    A buffer goes back to the pool with the event recorded after the copy
    that reads it, and is handed out again only once that event has
    completed: reusing it earlier would overwrite a frame the card has not
    read yet."""

    def __init__(self, keep: int):
        self._free: list[tuple[torch.Tensor, torch.cuda.Event]] = []
        self._keep = keep
        self._lock = threading.Lock()

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            for i, (buf, ev) in enumerate(self._free):
                if buf.numel() >= nbytes and ev.query():
                    del self._free[i]
                    return buf
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor, ev: torch.cuda.Event) -> None:
        with self._lock:
            self._free.append((buf, ev))
            if len(self._free) > self._keep:
                # dropped, not reused: the host allocator itself waits for
                # the copy's completion before it hands the memory out
                self._free.pop(0)


class BlurPipeline:
    """Reusable blur for streams of variably-sized uint8 frames."""

    def __init__(
        self,
        nsmooth: float,
        engine: Engine | str = Engine.AUTO,
        kernel: str = "gaussian",
        size_mode: str = "auto",
        bucket: int = 256,
        exact: bool = False,
        device: torch.device | str = "cuda",
    ):
        self.nsmooth = api._norm_nsmooth(nsmooth)
        self.engine = Engine(engine)
        self.kernel = kernel
        self.size_mode = size_mode
        self.bucket = int(bucket)
        self.exact = bool(exact)
        self.device = entry_device(device)
        self._compiles = 0
        self._calls = 0
        self._seen: set[tuple] = set()

    def _margins(self, h: int, w: int) -> tuple[int, int]:
        """Per-axis kernel support radii of this config at shape (h, w)."""
        if self.engine in (Engine.BOX, Engine.BOX_SCAN):
            plan = api._box_plan(h, w, api._box_radius(self.nsmooth, self.engine), 2,
                                 self.size_mode)
        else:
            plan = api._plan_for(h, w, self.nsmooth, self.kernel, self.size_mode)
        return plan.col.support_radius, plan.row.support_radius

    def _bucketed(self, h: int, w: int) -> tuple[int, int]:
        """Bucket target with >= one support radius of margin per axis.

        The margin makes the cropped result exact (module docstring). If
        the kernel is dim-clamped — a bigger frame would change the taps,
        detected by re-planning at the bucket target — the exact shape.
        Not idempotent: a bucket-shaped frame re-buckets to the next
        margin-inclusive target (hence ``prebucketed``).
        """
        b = self.bucket
        rh, rw = self._margins(h, w)
        bh = -(-(h + rh) // b) * b
        bw = -(-(w + rw) // b) * b
        if (bh, bw) != (h, w) and self._margins(bh, bw) != (rh, rw):
            return h, w  # dim-clamped kernel: the exact shape
        return bh, bw

    def _on_device(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            return img.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    def __call__(self, img, prebucketed: bool = False) -> torch.Tensor:
        """Blur a uint8 frame ``(H, W, C)`` or batch ``(B, H, W, C)`` (a
        NumPy array or a tensor); returns a uint8 tensor on the pipeline's
        device.

        ``prebucketed`` marks a frame already padded to its bucket target
        (``stream``'s host-side pad): it is blurred at its own shape. Without
        it, a bucket-shaped frame would re-bucket to the next target and
        plan a second, larger shape than ``warmup`` / ``ensure_compiled``
        prepared.
        """
        img = self._on_device(img)
        self._calls += 1
        h, w = img.shape[-3], img.shape[-2]
        if self.exact or prebucketed:
            bh, bw = h, w
        else:
            bh, bw = self._bucketed(h, w)
        key = (tuple(img.shape[:-3]), bh, bw, img.shape[-1])
        if key not in self._seen:
            self._seen.add(key)
            self._compiles += 1

        if (bh, bw) != (h, w):
            from blur_algorithms_tpu_torch.ops.pad import reflect_101

            img = reflect_101(img, [(0, bh - h), (0, bw - w)], axes=[-3, -2])
        out = blur_u8(img, self.nsmooth, engine=self.engine, kernel=self.kernel,
                      size_mode=self.size_mode)
        if (bh, bw) != (h, w):
            out = out[..., :h, :w, :]
        return out

    def warmup(self, shapes, channels: int = 3, batch: tuple = ()) -> None:
        """Prepare the buckets of the given (H, W) shapes: plan them and
        run each once (the first launch also loads or builds the kernel
        library), so that no live request pays for it."""
        n = 0
        for h, w in shapes:
            dummy = torch.zeros((*batch, h, w, channels), dtype=torch.uint8,
                                device=self.device)
            self(dummy)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._calls -= n

    def ensure_compiled(self, h: int, w: int, channels: int = 3, batch: tuple = ()) -> bool:
        """Prepare this shape's bucket if it is new; True if it was.

        Serving front ends call this before taking their device lock, so a
        cold bucket's build and planning never blocks other requests or
        health checks; a warm bucket returns at once.
        """
        bh, bw = (h, w) if self.exact else self._bucketed(h, w)
        if (tuple(batch), bh, bw, channels) in self._seen:
            return False
        self.warmup([(h, w)], channels=channels, batch=batch)
        return True

    @property
    def stats(self) -> dict:
        return {"calls": self._calls, "distinct_buckets": self._compiles}

    def stream(self, frames, prefetch: int = 2):
        """Blur a stream of frames, overlapping host work with the card's.

        ``frames`` yields uint8 arrays ``(H, W, C)`` or image paths. A pool
        of ``prefetch`` stager threads reads and decodes the next frames,
        bucket-pads each on the host (``native.reflect101_u8``), copies it
        into page-locked memory and starts its host-to-device copy
        (``non_blocking``) on a side CUDA stream while the card blurs the
        current one; the blur's stream waits on the copy's event and
        ``record_stream`` keeps the frame's device memory until the blur
        is done with it. Yields ``(key, blurred)`` in input order, ``key``
        the path (or the running index for arrays); the outputs are device
        tensors: force them (``.cpu()``) only where needed, so the card
        stays busy ahead of the loop. On the CPU the stagers hand over host
        tensors and the blur runs synchronously.
        """
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(device=self.device) if cuda else None
        pool = _PinnedPool(keep=2 * max(1, int(prefetch)) + 2) if cuda else None

        def stage(item, idx):
            if isinstance(item, (str, os.PathLike)):
                from blur_algorithms_tpu_torch.utils.io import read_image

                arr = read_image(os.fspath(item))
                key = os.fspath(item)
            else:
                arr, key = np.asarray(item), idx
            if arr.ndim == 2:  # grayscale: as the CLI's single-file path
                arr = arr[..., None]
            hw = None
            if not self.exact and arr.ndim == 3 and arr.dtype == np.uint8:
                # the bucket pad on the host, in this stager thread: the
                # blur sees an exact-bucket frame, and the pad hides
                # behind the previous frame's blur
                h, w = int(arr.shape[0]), int(arr.shape[1])
                bh, bw = self._bucketed(h, w)
                if (bh, bw) != (h, w):
                    from blur_algorithms_tpu_torch.utils import native

                    arr = native.reflect101_u8(arr, ((0, bh - h), (0, bw - w)))
                    hw = (h, w)
            arr = np.ascontiguousarray(arr)
            if not cuda or arr.dtype != np.uint8:  # (blur_u8 refuses the latter)
                return key, torch.from_numpy(arr), None, hw
            host = pool.take(arr.size)
            staged = host[: arr.size].view(arr.shape)
            staged.copy_(torch.from_numpy(arr))
            with torch.cuda.stream(side):
                dev = staged.to(self.device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(side)
            pool.give(host, copied)
            return key, dev, copied, hw

        with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, int(prefetch))) as stagers:
            pending: collections.deque = collections.deque()
            it = enumerate(iter(frames))
            for idx, item in it:
                pending.append(stagers.submit(stage, item, idx))
                if len(pending) >= max(1, int(prefetch)):
                    break
            while pending:
                key, img, copied, hw = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(stagers.submit(stage, nxt[1], nxt[0]))
                if copied is not None:
                    current = torch.cuda.current_stream(self.device)
                    current.wait_event(copied)
                    img.record_stream(current)
                out = self(img, prebucketed=hw is not None)
                if hw is not None:  # crop the host-side bucket pad back off
                    out = out[..., : hw[0], : hw[1], :]
                yield key, out


def GaussianBlur(sigma: float, **kwargs) -> BlurPipeline:
    """True-Gaussian pipeline (reference flags 2/3/5 semantics)."""
    return BlurPipeline(sigma, kernel="gaussian", **kwargs)


def FastBoxBlur(nsmooth: float, **kwargs) -> BlurPipeline:
    """FastBoxBlur pipeline (reference flag 4: radius = nsmooth^2, 2 passes)."""
    return BlurPipeline(nsmooth, engine=Engine.BOX, **kwargs)


class SpectrumAnalyzer:
    """``DFT_image`` pipeline: frames -> log-magnitude spectra on ``device``
    (default the card; with no card it raises unless ``"cpu"`` is asked
    for)."""

    def __init__(self, nsmooth: float = 1.0, size_mode: str = "auto",
                 device: torch.device | str = "cuda"):
        self.nsmooth = float(nsmooth)
        self.size_mode = size_mode
        self.device = entry_device(device)

    def __call__(self, img) -> torch.Tensor:
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return api.dft_spectrum(img.to(self.device), self.nsmooth, size_mode=self.size_mode)

    def to_image(self, spec) -> np.ndarray:
        """Normalize one frame's ``(C, fh, fw)`` spectrum to a uint8
        visualization (CLI parity). Batched ``(B, C, fh, fw)`` maps must be
        split per frame first."""
        if isinstance(spec, torch.Tensor):
            spec = spec.cpu().numpy()
        spec = np.asarray(spec)
        if spec.ndim != 3:
            raise ValueError(
                f"to_image expects one frame's (C, fh, fw) spectrum, got "
                f"shape {spec.shape}; split batched spectra per frame"
            )
        lo, hi = float(spec.min()), float(spec.max())
        vis = (spec - lo) / max(hi - lo, 1e-9) * 255.0
        return np.moveaxis(vis.astype(np.uint8), 0, -1)
