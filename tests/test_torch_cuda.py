"""The port's CUDA kernels on the card, against their plain versions, at the
serving path's shapes (DreamerV3 width, rungs 1 and 8). Marked `cuda`: they
skip without a CUDA device. The file imports neither jax nor the reference,
so it also runs on a machine that has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Tolerances: f32 atol/rtol 1e-4 (f32 sums in another order), bf16 2e-2
(one bf16 rounding of the output).
"""

from __future__ import annotations

import pytest
import torch

from sheeprl_tpu_torch.ops.kernels import cnn, gru

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
STAGES = [(3, 32, 64), (32, 64, 32), (64, 128, 16), (128, 256, 8)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are compiled and run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 8])
def test_gru_kernel_matches_plain(cuda_device, dtype, batch):
    gen = torch.Generator().manual_seed(batch)
    x = _rand(gen, batch, 512).to(cuda_device, dtype)
    h = torch.tanh(_rand(gen, batch, 512)).to(cuda_device, dtype)
    w = _rand(gen, 1536, 1024, scale=0.03).to(cuda_device, dtype)
    scale = (1.0 + _rand(gen, 1536, scale=0.1)).to(cuda_device)
    offset = _rand(gen, 1536, scale=0.1).to(cuda_device)
    before = gru.layernorm_gru_cell.launches
    got = gru.layernorm_gru_cell(x, h, w, scale, offset, 1e-5)
    torch.cuda.synchronize()
    assert gru.layernorm_gru_cell.launches == before + 1
    want = gru.layernorm_gru_cell_plain(x, h, w, scale, offset, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", STAGES, ids=lambda s: f"{s[0]}to{s[1]}at{s[2]}")
@pytest.mark.parametrize("n", [1, 8])
def test_conv_kernel_matches_plain(cuda_device, dtype, stage, n):
    cin, cout, size = stage
    gen = torch.Generator().manual_seed(cin + n)
    x = torch.rand(n, size, size, cin, generator=gen).to(cuda_device, dtype)
    w = _rand(gen, 4, 4, cin, cout, scale=(2.0 / (16 * (cin + cout))) ** 0.5).to(cuda_device, dtype)
    scale = (1.0 + _rand(gen, cout, scale=0.1)).to(cuda_device)
    offset = _rand(gen, cout, scale=0.1).to(cuda_device)
    before = cnn.conv_ln_silu.launches
    got = cnn.conv_ln_silu(x, w, scale, offset, 1e-3)
    torch.cuda.synchronize()
    assert cnn.conv_ln_silu.launches == before + 1
    want = cnn.conv_ln_silu_plain(x, w, scale, offset, 1e-3)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda_device):
    x = torch.zeros(2, 8, device=cuda_device)
    h = torch.zeros(2, 8, device=cuda_device)
    w = torch.zeros(16, 24, device=cuda_device).t()  # [24, 16] view, not contiguous
    ones, zeros = torch.ones(24, device=cuda_device), torch.zeros(24, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        gru.layernorm_gru_cell(x, h, w, ones, zeros)
    cx = torch.zeros(1, 8, 8, 3, device=cuda_device)
    cw = torch.zeros(4, 4, 3, 8, device=cuda_device)
    with pytest.raises(ValueError, match="one device"):
        cnn.conv_ln_silu(cx, cw.cpu(), torch.ones(8), torch.zeros(8))
