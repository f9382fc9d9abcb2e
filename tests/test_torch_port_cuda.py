"""The hand-written CUDA conv kernel against its plain PyTorch version, on the card.

Every test needs a CUDA card (the kernel has no CPU mode) and skips without
one. On the card, run this file without the JAX package's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_port_cuda.py

The reference r is the plain version evaluated in fp64 on the same
bf16-rounded inputs (cuDNN may pick fp32 algorithms whose own error exceeds
a bf16 ulp near zero). Tolerances: fp32 out, max|k - r| <= 1e-3 * max|r|;
bf16 out, |k - r| <= 2^-7 |r| + 1e-4 max|r| (one bf16 ulp, plus a floor for
values near zero that covers fp32 accumulation over up to 64,000 products).
"""

import numpy as np
import pytest
import torch

from repmode_tpu_torch.config import ModelConfig
from repmode_tpu_torch.models import reparam
from repmode_tpu_torch.models.reparam import plain_forward, reparameterize
from repmode_tpu_torch.models.repmode import RepModeNet
from repmode_tpu_torch.ops.conv3d import conv3d_same, conv3d_same_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def plain_fp64(x, w, b, relu):
    bf = torch.bfloat16
    return conv3d_same_plain(x.to(bf).double(), w.to(bf).double(),
                             None if b is None else b.double(), relu=relu)


def within_tolerance(y: torch.Tensor, ref: torch.Tensor) -> bool:
    err = (y.double() - ref).abs()
    top = ref.abs().max()
    if y.dtype == torch.float32:
        return bool(err.max() <= 1e-3 * top)
    return bool((err <= 2.0**-7 * ref.abs() + 1e-4 * top).all())


# (N, D, H, W, Ci, Co, taps): covers the scalar (Ci % 8 != 0) and vector
# input paths, partial channel chunks and Co tiles, W below and above the
# 128-position tile, partial tiles and depths smaller than the taps.
CASES = [
    (2, 4, 6, 8, 1, 32, (5, 5, 5)),
    (1, 3, 5, 20, 3, 5, (3, 5, 3)),
    (2, 2, 4, 8, 16, 1, (5, 5, 5)),
    (1, 5, 3, 130, 24, 40, (3, 3, 3)),
    (1, 2, 2, 200, 8, 100, (1, 1, 1)),
    (2, 2, 8, 8, 64, 64, (5, 5, 5)),
    (1, 1, 9, 16, 40, 16, (1, 3, 3)),
]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["none", "bias", "bias_relu"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda, case, epilogue, out_dtype):
    n, d, h, w, ci, co, taps = case
    g = torch.Generator().manual_seed(hash(case) % 2**31)
    x = torch.randn((n, d, h, w, ci), generator=g).to(cuda)
    wk = (torch.randn(taps + (ci, co), generator=g) / (ci * np.prod(taps)) ** 0.5).to(cuda)
    b = torch.randn((co,), generator=g).to(cuda) if epilogue != "none" else None
    relu = epilogue == "bias_relu"
    before = conv3d_same.launches
    y = conv3d_same(x, wk, b, relu=relu, compute_dtype=torch.bfloat16, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv3d_same.launches == before + 1
    ref = plain_fp64(x, wk, b, relu)
    assert y.shape == ref.shape and y.dtype == out_dtype
    assert within_tolerance(y, ref), (y.double() - ref).abs().max().item()


def test_kernel_rejects_fp32_compute(cuda):
    x = torch.zeros((1, 2, 2, 2, 8), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        conv3d_same(x, torch.zeros((3, 3, 3, 8, 8), device=cuda))


def test_plain_forward_through_kernel_matches_plain_version(cuda, monkeypatch):
    cfg = ModelConfig(mult_chan=8, depth=3)
    net = RepModeNet(cfg, 3, generator=torch.Generator().manual_seed(1), device=cuda).eval()
    plain = reparameterize(net.state_dict(), cfg, 3, 2)
    x = torch.randn((2, 16, 32, 32, 1), generator=torch.Generator().manual_seed(2)).to(cuda)
    before = conv3d_same.launches
    y = plain_forward(plain, x, cfg, compute_dtype=torch.bfloat16)
    assert conv3d_same.launches == before + 4 * cfg.depth + 3
    monkeypatch.setattr(reparam, "conv3d_same", conv3d_same_plain)
    ref = plain_forward(plain, x, cfg, compute_dtype=torch.bfloat16)
    rel = ((y - ref).norm() / ref.norm()).item()
    assert torch.isfinite(y).all() and rel <= 1e-2, rel
