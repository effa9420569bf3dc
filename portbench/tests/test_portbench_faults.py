"""A whole run, past the harness's look for a card, with the timed path
sound and then broken underneath: ``correct`` has to come out true for the
port and false for each fault a cell can have, in a ``blur_u8`` cell and in
the float ``blur`` cell with its backward."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from portbench import harness, manifest as manifest_mod, reference

MAN = manifest_mod.load()
FLOAT_CELL = "float4k-b4-s10-fwdbwd"


def _tiny(cell_name: str, batch: int = 2):
    """The cell with its frames cut to a size a test run holds (its sigma
    kept where the frame holds its taps, else 4)."""
    cell = MAN.cell(cell_name)
    cfg = dict(cell.config, batch=batch, height=72, width=96)
    traffic = dict(cell.traffic)
    if harness.sigma_of(traffic, cell.config) > 10:
        traffic.pop("sigma_rule", None)
        traffic["sigma"] = 4.0
    traffic["trace_seconds"] = 0.05
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def _run(cell, fn=None, trace=False):
    torch.set_num_threads(2)
    return harness.run_cell(MAN, cell, 2**31 + 77, 0.3, trace, "cpu", time.perf_counter(),
                            fn=fn)


def _port():
    from blur_algorithms_tpu_torch.api import blur_u8

    return blur_u8


@pytest.mark.parametrize("cell", ["rgb4k-b32-s10", "photo24k-sqrtw", FLOAT_CELL])
@pytest.mark.parametrize("trace", [False, True])
def test_the_port_runs_correct(cell, trace):
    result, compared = _run(_tiny(cell), None, trace)
    assert result["correct"], compared
    assert result["attempted"] >= 2 and result["failed"] == 0
    names = {m["name"] for m in (MAN.cell(cell).per_layer if trace else MAN.cell(cell).end_to_end)}
    assert set(result["metrics"]) <= names
    if not trace:
        assert {"mp_per_s", "call_ms_p95", "setup_s"} <= set(result["metrics"])
    else:
        # the port's spans reach their readers (Context.program)
        assert {"route_ms_per_call", "program_idle_ms_per_call"} <= set(result["metrics"])
    assert [c[0] for c in compared][-1] == "failed_calls"


def _unchanged(img, sigma, engine="auto"):
    """A step that returns its state unchanged."""
    return img.clone()


def _half_batch(img, sigma, engine="auto"):
    """Half the batch left out: the first half blurred, the rest unchanged."""
    out = img.clone()
    half = img.shape[0] // 2
    out[:half] = _port()(img[:half], sigma, engine=engine)
    return out


def _altered(img, sigma, engine="auto"):
    """An answer altered where it is produced: one value three counts off."""
    out = _port()(img, sigma, engine=engine)
    v = int(out[0, 3, 5, 1])
    out[0, 3, 5, 1] = v + 3 if v < 250 else v - 3
    return out


class _Raises:
    """Calls that raise in the window (the warm-up calls pass)."""

    def __init__(self):
        self.calls = 0
        self.__name__ = "raises"

    def __call__(self, img, sigma, engine="auto"):
        self.calls += 1
        if self.calls > 2:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return _port()(img, sigma, engine=engine)


def _wrong_shape(img, sigma, engine="auto"):
    return _port()(img, sigma, engine=engine)[..., :2]


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered, "raises", _wrong_shape])
def test_a_broken_timed_path_reads_not_correct(fault):
    fault = _Raises() if fault == "raises" else fault
    result, compared = _run(_tiny("rgb4k-b32-s10"), fault)
    assert not result["correct"], (fault.__name__, compared)
    assert any(not ok for *_, ok in compared)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN.data["workloads"]])
def test_the_control_in_the_port_place_reads_not_correct(cell):
    """The control (the reference one step below the configuration's
    precision: float8 e4m3 under bfloat16, TF32 under float32) through a
    whole run of the cell's comparison."""
    from portbench import control as control_mod

    tiny = _tiny(cell)
    result, compared = _run(tiny, control_mod.control_function(tiny, None, "cpu"))
    assert not result["correct"]
    passed = dict((c[0], c[3]) for c in compared)
    if harness.entry_name(tiny.traffic) == "blur":
        assert passed["max_abs_err"] is False
    else:
        assert passed["mismatch_pct"] is False and passed["worst_count_diff"] is False


def _port_blur():
    from blur_algorithms_tpu_torch.api import blur

    return blur


def _port_grad(x, ct, sigma):
    """The port's own gradient of ``blur`` at ``x`` for ``ct``."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(_port_blur()(x, sigma), x, ct)[0]


def _fault(forward, backward):
    """A ``blur`` whose forward and backward are the given functions of
    ``(x, sigma)`` and ``(x, ct, sigma)``."""

    class _Faulty(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, sigma):
            ctx.save_for_backward(x)
            ctx.sigma = sigma
            return forward(x, sigma)

        @staticmethod
        def backward(ctx, ct):
            (x,) = ctx.saved_tensors
            return backward(x, ct, ctx.sigma), None

    def blur(x, sigma, engine="auto"):
        return _Faulty.apply(x, sigma)

    return blur


def _port_forward(x, sigma):
    return _port_blur()(x.detach(), sigma)


def _forward_as_gradient(x, ct, sigma):
    """The forward blur of the cotangent in place of the adjoint."""
    return _port_blur()(ct, sigma)


def _band_without_left_fold(n: int, taps: np.ndarray) -> torch.Tensor:
    """``reference.band_matrix`` with the left border's reflections left
    out (zero there in place of the mirrored samples)."""
    r = (len(taps) - 1) // 2
    m = np.zeros((n, n))
    for i in range(n):
        for t, tap in enumerate(taps.astype(np.float64)):
            j = i - r + t
            if 0 <= j <= n - 1:
                m[j, i] += tap
            elif n - 1 < j <= 2 * (n - 1):
                m[2 * (n - 1) - j, i] += tap
    return torch.from_numpy(m)


def _one_fold_left_out(x, ct, sigma):
    """The exact adjoint with the rows' left border fold left out."""
    h, w = x.shape[-2:]
    ops = reference.Operators(h, w, sigma, "cpu")
    rows = _band_without_left_fold(w, reference.gaussian_taps(sigma, max(h, w)))
    planes = ct.reshape(-1, h, w).to(torch.float64)
    out = torch.stack([reference._adjoint_plane(p, rows, ops.cols, ops.r, ops.r)
                       for p in planes])
    return out.reshape(ct.shape).to(torch.float32)


def _tf32_forward(x, sigma):
    """The forward rounded to TF32 (the float control's forward)."""
    return reference.blur_f32_lower_precision(x, sigma)


def _port_backward(x, ct, sigma):
    return _port_grad(x, ct, sigma)


def _unchanged_float(x, sigma):
    return x.detach().clone()


def _half_batch_float(x, sigma):
    out = x.detach().clone()
    half = x.shape[0] // 2
    out[:half] = _port_forward(x[:half], sigma)
    return out


def _altered_grad(x, ct, sigma):
    gx = _port_grad(x, ct, sigma)
    gx[0, 1, 3, 5] += 0.01
    return gx


FLOAT_FAULTS = {
    "forward_as_gradient": (_port_forward, _forward_as_gradient, "grad_max_abs_err"),
    "one_fold_left_out": (_port_forward, _one_fold_left_out, "grad_max_abs_err"),
    "tf32_forward": (_tf32_forward, _port_backward, "max_abs_err"),
    "unchanged": (_unchanged_float, _forward_as_gradient, "max_abs_err"),
    "half_batch": (_half_batch_float, _port_backward, "max_abs_err"),
    "altered_gradient": (_port_forward, _altered_grad, "grad_max_abs_err"),
}


@pytest.mark.parametrize("fault", sorted(FLOAT_FAULTS))
def test_a_broken_float_path_reads_not_correct(fault):
    forward, backward, number = FLOAT_FAULTS[fault]
    result, compared = _run(_tiny(FLOAT_CELL), _fault(forward, backward))
    assert not result["correct"], (fault, compared)
    assert dict((c[0], c[3]) for c in compared)[number] is False, (fault, compared)


def test_the_sound_float_fault_harness_reads_correct():
    """The faults' own frame, the port's forward and its gradient, reads
    correct: each fault above fails by what it breaks alone."""
    result, compared = _run(_tiny(FLOAT_CELL), _fault(_port_forward, _port_backward))
    assert result["correct"], compared


def test_a_float_answer_of_the_wrong_type_reads_inf():
    def wrong_dtype(x, sigma, engine="auto"):
        return _port_blur()(x, sigma).to(torch.float64)

    result, compared = _run(_tiny(FLOAT_CELL), wrong_dtype)
    assert not result["correct"]
    assert result["judged"]["max_abs_err"] == float("inf")
    assert result["judged"]["grad_max_abs_err"] == float("inf")
