"""Tests of the port that need an NVIDIA card (marked ``cuda``).

They skip where ``torch.cuda.is_available()`` is false. The file imports no
jax, so it also runs where jax is not installed; on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blur_algorithms_tpu_torch import blur_u8, make_plan  # noqa: E402
from blur_algorithms_tpu_torch.cuda_kernels import fused_dma  # noqa: E402
from blur_algorithms_tpu_torch.ops.layout import from_planar  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planes(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, sigma", [
    ((1080, 1920), 10.0),
    ((1001, 1777), (5.0, 11.0)),
    ((541, 963), 150.0),
    ((37, 1300), 1.0),
    ((1210, 1205), 180.0),
])
def test_k1_equals_plain_version_on_the_card(cuda_device, shape, sigma):
    plan = make_plan(shape, sigma)
    x = _planes((3, *shape), seed=6).to(cuda_device)
    before = fused_dma.blur_fused_u8_dma.launches
    got = fused_dma.blur_fused_u8_dma(x, plan)
    want = fused_dma.blur_fused_u8_dma_ref(x, plan)
    torch.cuda.synchronize()
    assert fused_dma.blur_fused_u8_dma.launches == before + 1
    assert got.device == x.device
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_blur_u8_on_the_card_runs_k1_and_matches_the_cpu(cuda_device):
    img = _planes((2, 120, 200, 3), seed=7)
    before = fused_dma.blur_fused_u8_dma.launches
    got = blur_u8(img.to(cuda_device), 4.0)
    torch.cuda.synchronize()
    assert fused_dma.blur_fused_u8_dma.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got.cpu(), blur_u8(img, 4.0))
    planar = img.movedim(-1, -3).contiguous()
    want = from_planar(fused_dma.blur_fused_u8_dma_ref(planar, make_plan((120, 200), 4.0)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_k1_rejects_a_non_contiguous_tensor(cuda_device):
    plan = make_plan((64, 96), 2.0)
    x = _planes((3, 96, 64), seed=8).to(cuda_device).transpose(-1, -2)
    with pytest.raises(ValueError, match="contiguous"):
        fused_dma.blur_fused_u8_dma(x, plan)
