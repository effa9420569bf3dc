"""B1: the dot rate of the card's tensor cores, by ``mma.sync`` and ``wgmma``.

The port of the JAX package's ``benchmarks/mxu_dot_rate.py``: a chain of
``inner`` products ``a <- cast(a @ b)`` of an (m, k) lhs and a (k, n) rhs,
int8 -> int32 or bf16 -> f32, the next lhs ``acc[:, :k]`` when n >= k, else
``concat(acc, a[:, n:])``, each step cast back to the lhs type, so that no
product can be hoisted; the result is the last lhs in the accumulator type.
It asks what rate a product whose operands sit on the chip reaches, against
the published peaks, at the nine shapes of the JAX probe (a cube, and the
band shapes of the fused kernels' rows and cols passes).

A CUDA tensor runs ``csrc/probes/mma_rate.cu`` (one 64-row panel of the lhs
a thread-block cluster, in every CTA's shared memory for the whole chain;
CTA r of the cluster on the rhs's 128-column tiles r, r + C, ..., streamed
from L2 by TMA; one chain a CTA a tile, the cast tiles exchanged through
distributed shared memory; the launch that fills the card clusters of one
CTA that computes every tile of its panel and exchanges nothing; by either
instruction path). ``launch_geometry`` models the launch.
``resident=True`` keeps the first ``STAGES`` stages of the rhs's first
tile in shared memory for the instruction's rate alone: every stage of the
chain then reads one of those, so the launch multiplies by
``resident_rhs(b)`` in place of ``b``, and is held to the plain chain on that.
A CPU tensor runs the plain version ``chain_ref``: the products in float64,
exact for int8 here (|a| <= 128, |b| <= 128, k <= 1536, so every sum is an
integer below 2^53), wrapped back to int8 as XLA's and PyTorch's int32 ->
int8 conversions do; for bf16 the exact products summed in float64, rounded
to f32 and then to bf16 each step.

Run: ``python -m blur_algorithms_tpu_torch.benchmarks.mxu_dot_rate``
(``--device cpu`` runs the plain version's short chain at each shape in
place of the rates). Prints one JSON line per shape, type and path.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import sys

import numpy as np
import torch

from blur_algorithms_tpu_torch.benchmarks._common import (
    check_launch,
    device_arg,
    device_of,
    emit,
)

__all__ = ["ITERS", "MAX_CLUSTER", "MAX_TILES", "PATHS", "PEAK_OPS", "SHAPES", "STAGES", "ChainLaunch",
           "LaunchGeometry", "bf16_bound", "chain", "chain_ref", "inner_for",
           "launch_geometry", "operands", "prepare", "rate", "resident_rhs"]

# (m, k, n, label): the JAX probe's shapes (mxu_dot_rate.py main)
SHAPES = (
    (1024, 1024, 1024, "big cube"),
    (2048, 1152, 128, "rows-band r=512 cw=128"),
    (2048, 1280, 256, "rows-band r=512 cw=256"),
    (2048, 1408, 384, "rows-band r=512 cw=384"),
    (2048, 1536, 512, "rows-band r=512 cw=512"),
    (120, 1144, 384, "cols-band r=512 ch=120"),
    (240, 1264, 384, "cols-band r=512 ch=240"),
    (384, 1408, 384, "cols-band r=512 ch=384"),
    (512, 1536, 384, "cols-band r=512 ch=512"),
)
PATHS = ("mma_sync", "wgmma")
# published dense tensor-core peaks of an H100 SXM at 700 W, operations/s
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12}
ITERS = 10  # timed launches a rate

_ROWS = 64  # rows of a cluster's panel (csrc/probes/mma_rate.cu: kRows)
_TILE = 128  # columns of the rhs a CTA's tile (kTile)
_STAGE_K = 64  # bytes of K a stage (kStageK)
STAGES = 4  # stages of the ring (kStages): what a resident launch keeps
MAX_CLUSTER = 8  # CTAs a cluster at most (kMaxCluster: portable clusters)
MAX_TILES = 8  # 128-column tiles of the rhs at most (kMaxTiles)
_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}


def operands(m: int, k: int, n: int, dtype: str, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX probe's inputs on the CPU: int8 in [-4, 4), or bf16 of
    standard normals."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        return (torch.from_numpy(rng.integers(-4, 4, (m, k), dtype=np.int8)),
                torch.from_numpy(rng.integers(-4, 4, (k, n), dtype=np.int8)))
    a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (k, n)).astype(np.float32))
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in _DTYPES.values() or b.dtype != a.dtype:
        raise TypeError(f"B1 takes int8 or bf16 operands of one type, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"B1 takes (m, k) @ (k, n), got {tuple(a.shape)} @ {tuple(b.shape)}")


def chain_ref(a: torch.Tensor, b: torch.Tensor, inner: int) -> torch.Tensor:
    """Plain version: ``inner`` chained products, int8 -> int32 or bf16 ->
    f32 (the last lhs in the accumulator type)."""
    _check(a, b)
    k, n = a.shape[1], b.shape[1]
    acc_type = torch.int64 if a.dtype == torch.int8 else torch.float64
    bf = b.to(torch.float64)
    for _ in range(inner):
        acc = (a.to(torch.float64) @ bf).to(acc_type)
        nxt = acc[:, :k] if n >= k else torch.cat([acc, a[:, n:].to(acc_type)], dim=1)
        a = nxt.to(a.dtype) if a.dtype == torch.int8 else nxt.float().to(a.dtype)
    return a.to(torch.int32 if a.dtype == torch.int8 else torch.float32)


def resident_rhs(b: torch.Tensor) -> torch.Tensor:
    """The (k, n) rhs a ``resident`` launch multiplies by: every CTA loads
    the first ``STAGES`` stages of the zero-padded rhs's first tile (its
    first 128 columns, K bytes [64 s, 64 s + 64) for stage s) once, and K
    stage kc of every 128-column tile reads stage kc mod ``STAGES`` of those
    (only the stages K has, where it has fewer)."""
    k, n = b.shape
    per = _STAGE_K // b.element_size()  # elements of K a stage
    bp = torch.zeros((max(k, STAGES * per), max(n, _TILE)), dtype=b.dtype, device=b.device)
    bp[:k, :n] = b
    rows = torch.arange(k, device=b.device)
    cols = torch.arange(n, device=b.device) % _TILE
    return bp[(((rows // per) % STAGES) * per + rows % per)[:, None], cols[None, :]]


def bf16_bound(a: torch.Tensor, b: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| allowed for one bf16 product of the chain cast back to
    bf16 (``inner`` 1), element by element. Both sides sum exact products (a
    bf16 x bf16 product fits f32): one in float64, the other in f32, where
    each of the k - 1 additions is off by at most 2^-24 of a partial sum (at
    most k 2^-24 sum |a b| in all; 2^-23 leaves room for a tensor core's
    truncating adds); each result is then rounded to bf16, a step of at most
    2^-8 of its value, so two such roundings differ by at most 2^-7 |value|
    past the sums' difference. Columns past min(n, k) hold the lhs as it
    was: no sum there."""
    k, n = a.shape[1], b.shape[1]
    sums = torch.zeros(want.shape, dtype=torch.float64, device=want.device)
    sums[:, :min(n, k)] = (a.abs().double() @ b.abs().double())[:, :min(n, k)]
    return 2.0 ** -7 * want.abs().double() + k * 2.0 ** -23 * sums


@dataclasses.dataclass(frozen=True)
class LaunchGeometry:
    """B1's launch for an (m, k) @ (k, n) chain of ``es``-byte elements:
    ``panels`` 64-row panels, K padded to ``kb`` bytes and n to ``np``
    columns (``ntile`` tiles of 128), clusters of ``cluster`` CTAs (one
    chain: the least power of two >= ``ntile``; filling the card: 1), CTA r
    owning tiles r, r + cluster, ... (at most ``tiles`` of them; CTAs past
    ``ntile`` own none: they receive the exchange and send none), and after
    each product the columns ``exchanged`` of the next lhs ([0, min(n, k)))
    passed between the cluster's CTAs."""

    panels: int
    kb: int
    np: int
    ntile: int
    cluster: int
    tiles: int
    exchanged: tuple[int, int]

    def owned(self, rank: int) -> list[int]:
        """The tiles CTA ``rank`` of a cluster computes, in its order."""
        return list(range(rank, self.ntile, self.cluster))

    def grid(self, chains: int) -> int:
        """CTAs of a launch of ``chains`` clusters (at least one a panel)."""
        return max(chains, self.panels) * self.cluster


def launch_geometry(m: int, k: int, n: int, es: int, copies: bool = False) -> LaunchGeometry:
    """B1's launch geometry (``csrc/probes/mma_rate.cu``): one chain, or
    with ``copies`` the launch that fills the card; ``ValueError`` where n
    needs more than ``MAX_TILES`` tiles."""
    ntile = -(-n // _TILE)
    if ntile > MAX_TILES:
        raise ValueError(f"n = {n}: B1 takes at most {MAX_TILES} tiles of {_TILE} columns")
    cluster = 1 if copies else 1 << (ntile - 1).bit_length()
    return LaunchGeometry(panels=-(-m // _ROWS), kb=-(-k * es // _STAGE_K) * _STAGE_K,
                          np=ntile * _TILE, ntile=ntile, cluster=cluster,
                          tiles=-(-ntile // cluster), exchanged=(0, min(n, k)))


@dataclasses.dataclass
class ChainLaunch:
    """One prepared launch of the chain kernel: the operands padded and
    laid out as the kernel reads them, their TMA tensor maps, the output,
    the cluster size and the grid. Calling it launches the kernel
    (``chain.launches`` counts)."""

    a: torch.Tensor  # (panels * 64, kb / es) lhs, zero-padded
    bt: torch.Tensor  # (np, kb / es) rhs transposed, zero-padded
    out: torch.Tensor  # (m, k) int32 or f32
    maps: ctypes.Array  # the two encoded tensor maps (mma_rate_maps)
    m: int
    k: int
    n: int
    panels: int
    grid: int
    wgmma: bool
    resident: bool
    inner: int
    steps: int
    cluster: int

    @property
    def bf16(self) -> bool:
        return self.a.dtype == torch.bfloat16

    @property
    def real_rows(self) -> int:
        """Rows of the frame the grid's clusters multiply, the padding left
        out."""
        per_panel = [min(_ROWS, self.m - _ROWS * p) for p in range(self.panels)]
        return sum(per_panel[g % self.panels] for g in range(self.grid // self.cluster))

    @property
    def ops(self) -> float:
        """Operations of one launch, the padding left out (2 a multiply-add)."""
        return 2.0 * self.real_rows * self.k * self.n * self.inner * self.steps

    def __call__(self) -> torch.Tensor:
        from blur_algorithms_tpu_torch.utils.build import load_probe_library

        es = self.a.element_size()
        kb = self.a.shape[1] * es
        rc = load_probe_library().mma_rate_chain(
            int(self.wgmma), int(self.bf16), int(self.resident), self.maps,
            self.out.data_ptr(), self.m, self.k, kb, self.bt.shape[0], min(self.n, self.k),
            self.panels, self.inner, self.steps, self.cluster, self.grid,
            torch.cuda.current_stream(self.a.device).cuda_stream)
        check_launch(rc, "mma_rate_chain")
        chain.launches["wgmma" if self.wgmma else "mma_sync"] += 1
        return self.out


def _max_clusters(wgmma: bool, bf16: bool, resident: bool, kb: int, cluster: int) -> int:
    from blur_algorithms_tpu_torch.utils.build import load_probe_library

    clusters = ctypes.c_int(0)
    rc = load_probe_library().mma_rate_clusters(
        int(wgmma), int(bf16), int(resident), kb, cluster, ctypes.byref(clusters))
    check_launch(rc, "mma_rate_clusters")
    if clusters.value < 1:
        raise RuntimeError(f"no cluster of {cluster} chain CTAs ({kb} bytes of K) fits the card")
    return clusters.value


def prepare(a: torch.Tensor, b: torch.Tensor, inner: int, steps: int = 1, *,
            path: str = "wgmma", resident: bool = False, copies: bool = True) -> ChainLaunch:
    """The launch of the chain on CUDA ``a`` and ``b`` (``launch_geometry``):
    ``copies`` fills the card (clusters of one CTA, as many as it holds at
    once, at least one a panel, cluster g on panel g mod panels), else one
    cluster a panel."""
    from blur_algorithms_tpu_torch.utils.build import load_probe_library

    _check(a, b)
    if path not in PATHS:
        raise ValueError(f"B1's paths are {PATHS}, not {path!r}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the chain kernel runs on one CUDA device, not {a.device}, {b.device}")
    if inner < 1 or steps < 1:
        raise ValueError(f"inner {inner} and steps {steps} must be positive")
    m, k = a.shape
    n = b.shape[1]
    es = a.element_size()
    if (min(n, k) * es) % 16:
        raise ValueError(f"min(n, k) * {es} = {min(n, k) * es} bytes: the kernel moves "
                         "the replaced columns in 16-byte pieces")
    geo = launch_geometry(m, k, n, es, copies)
    ap = torch.zeros((geo.panels * _ROWS, geo.kb // es), dtype=a.dtype, device=a.device)
    ap[:m, :k] = a
    bt = torch.zeros((geo.np, geo.kb // es), dtype=a.dtype, device=a.device)
    bt[:n, :k] = b.t()
    wgmma = path == "wgmma"
    chains = (_max_clusters(wgmma, es == 2, resident, geo.kb, geo.cluster) if copies
              else geo.panels)
    maps = ctypes.create_string_buffer(256)
    with torch.cuda.device(a.device):
        check_launch(load_probe_library().mma_rate_maps(
            ap.data_ptr(), bt.data_ptr(), ap.shape[0], geo.kb, geo.np, maps), "mma_rate_maps")
    out = torch.empty((m, k), dtype=torch.int32 if es == 1 else torch.float32,
                      device=a.device)
    return ChainLaunch(ap, bt, out, maps, m, k, n, geo.panels, geo.grid(chains), wgmma,
                       resident, inner, steps, geo.cluster)


def chain(a: torch.Tensor, b: torch.Tensor, inner: int, steps: int = 1, *,
          path: str = "wgmma", resident: bool = False, copies: bool = False) -> torch.Tensor:
    """B1's chain: ``inner`` products, ``steps`` times over (the same
    result). A CUDA tensor launches the kernel by ``path`` (one cluster a
    panel, or filling the card with ``copies``); a CPU tensor runs the plain
    version (on ``resident_rhs(b)`` where ``resident``).
    ``chain.launches[path]`` counts kernel launches."""
    _check(a, b)
    if a.device.type == "cpu":
        return chain_ref(a, resident_rhs(b) if resident else b, inner)
    return prepare(a, b, inner, steps, path=path, resident=resident, copies=copies)()


chain.launches = dict.fromkeys(PATHS, 0)


def inner_for(launch_rows: int, k: int, n: int, steps: int = 1) -> int:
    """Products a step for ~0.5 T multiply-adds a launch, at least 16: the
    JAX probe's sizing (mxu_dot_rate.py run), over the rows every cluster
    of the launch multiplies."""
    return max(16, int(5e11 / (launch_rows * k * n * steps)))


def rate(a: torch.Tensor, b: torch.Tensor, path: str, resident: bool = False) -> dict:
    """The chain's rate on the card: the launch filling it, ``inner`` sized
    by ``inner_for``; ms (median of ``ITERS``), operations and TOP/s."""
    from blur_algorithms_tpu_torch.utils.timing import time_cuda

    m, k = a.shape
    n = b.shape[1]
    probe = prepare(a, b, 1, path=path, resident=resident)
    launch = dataclasses.replace(probe, inner=inner_for(probe.real_rows, k, n))
    res = time_cuda(launch, iters=ITERS, warmup=2, name=f"B1 {path}")
    return {"ms": res.median_ms, "ops": launch.ops, "inner": launch.inner,
            "grid": launch.grid, "cluster": launch.cluster,
            "tops": launch.ops / (res.median_ms * 1e-3) / 1e12}


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    device_arg(p)
    args = p.parse_args(argv)
    device = device_of(args.device)
    for dtype in _DTYPES:
        for m, k, n, label in SHAPES:
            a, b = operands(m, k, n, dtype)
            if device.type == "cpu":
                out = chain(a, b, 3)
                emit({"probe": "B1", "dtype": dtype, "shape": [m, k, n], "label": label,
                      "device": "cpu", "inner": 3, "sum": float(out.double().sum())})
                continue
            a, b = a.to(device), b.to(device)
            for path in PATHS:
                for resident in (False, True):
                    r = rate(a, b, path, resident)
                    emit({"probe": "B1", "dtype": dtype, "shape": [m, k, n], "label": label,
                          "path": path, "resident": resident, **r,
                          "share_of_peak": r["tops"] * 1e12 / PEAK_OPS[dtype],
                          "device": torch.cuda.get_device_name(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
