"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need an NVIDIA Hopper GPU and nvcc: they carry the `cuda` marker and
skip elsewhere. Run them on the card with
``python -m pytest tests/test_torch_cuda.py -q``. `chip_smoke.py` makes the
same comparison at the full serving shapes.

Tolerance (bf16 outputs): max |kernel - plain| <= 2e-2 * max |plain| + 1e-2;
both sides round once to bf16 from f32 sums taken in different orders.
"""

import pytest
import torch

from argus_tpu_torch.ops import kernels
from argus_tpu_torch.ops.kernels import block_fused as tb
from argus_tpu_torch.ops.kernels import proj_fused as tp
from argus_tpu_torch.ops.kernels import stage_fused as tst
from argus_tpu_torch.ops.kernels import stem_fused as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels are built with nvcc for sm_90a)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2e-2 * want.float().abs().max().item() + 1e-2, err


def _w(g, *shape, dev):
    return (torch.randn(*shape, generator=g) / shape[-2] ** 0.5).to(dev, torch.bfloat16)


def _b(g, c, dev):
    return (0.1 * torch.randn(1, c, generator=g)).to(dev)


def _id(g, c, f, dev):
    return (_w(g, c, f, dev=dev), _b(g, f, dev), _w(g, 3, 3, f, f, dev=dev), _b(g, f, dev),
            _w(g, f, c, dev=dev), _b(g, c, dev))


def _proj(g, cin, f, cout, dev):
    return (_w(g, cin, f, dev=dev), _b(g, f, dev), _w(g, 3, 3, f, f, dev=dev), _b(g, f, dev),
            _w(g, f, cout, dev=dev), _b(g, cout, dev), _w(g, cin, cout, dev=dev), _b(g, cout, dev))


def test_stem_kernel(dev):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(3, 72, 40, 3, generator=g).to(dev, torch.bfloat16)
    w = (0.2 * torch.randn(7, 7, 3, 64, generator=g)).to(dev, torch.bfloat16)
    b = _b(g, 64, dev)
    before = ts.KERNEL.launches
    _close(ts.stem_pool(x, w, b), ts.stem_pool_plain(x, w, b))
    assert ts.KERNEL.launches == before + 1


@pytest.mark.parametrize("cin,f", [(64, 16), (256, 64)])
def test_identity_block_kernel(dev, cin, f):
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 9, 7, cin, generator=g).to(dev, torch.bfloat16)
    ws = _id(g, cin, f, dev)
    _close(tb.bottleneck_block(x, *ws), tb.bottleneck_block_plain(x, *ws))


@pytest.mark.parametrize("stride", [1, 2])
def test_projection_block_kernel(dev, stride):
    g = torch.Generator().manual_seed(2)
    x = torch.rand(2, 10, 6, 64, generator=g).to(dev, torch.bfloat16)
    ws = _proj(g, 64, 32, 128, dev)
    _close(tp.projection_block(x, *ws, stride), tp.projection_block_plain(x, *ws, stride))


@pytest.mark.parametrize("with_proj", [True, False])
def test_stage_kernel(dev, with_proj):
    g = torch.Generator().manual_seed(3)
    cin = 64 if with_proj else 256
    x = torch.rand(2, 8, 8, cin, generator=g).to(dev, torch.bfloat16)
    proj = _proj(g, cin, 64, 256, dev) if with_proj else None
    ids = [_id(g, 256, 64, dev) for _ in range(2)]
    _close(tst.fused_stage(x, proj, ids, 1), tst.stage_plain(x, proj, ids, 1))


def test_wrappers_check_arguments(dev):
    x = torch.zeros(1, 8, 8, 64, device=dev)  # f32: the kernels take bf16
    ws = _id(torch.Generator().manual_seed(4), 64, 16, dev)
    with pytest.raises(TypeError):
        tb.bottleneck_block(x, *ws)
    with pytest.raises(ValueError):
        tb.bottleneck_block(x.to(torch.bfloat16)[..., :60], *ws)
    assert set(kernels.KERNELS) == {"stem_fused", "stage_fused", "proj_fused", "block_fused"}
