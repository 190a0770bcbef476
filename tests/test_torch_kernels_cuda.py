"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here is marked ``cuda`` and skips without a GPU.  The
file imports torch and the port only (no JAX), so on a GPU machine it
runs without the repo's JAX test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa
from distributed_tensorflow_tpu_torch.ops import layer_norm as ln


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(784, 2048), (8, 2048), (3, 5, 1000)])
def test_layer_norm_kernel_matches_plain_on_card(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 3 + 1
         ).to(dtype)
    scale = torch.randn(shape[-1], generator=g, device=cuda_device)
    bias = torch.randn(shape[-1], generator=g, device=cuda_device)
    before = ln.launches
    got = ln.layer_norm(x, scale, bias)
    assert ln.launches == before + 1 and got.dtype == torch.float32
    want = ln.layer_norm_reference(x, scale, bias)
    # fp32 on both sides; values of magnitude up to ~10 (random scale).
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,D,window,masked", [
    (784, 128, 0, False), (112, 128, 0, True), (100, 64, 32, False),
    (48, 64, 0, True), (300, 128, 64, True)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, S, D,
                                            window, masked):
    g = torch.Generator(device=cuda_device).manual_seed(S)
    B, H = 2, 4
    fused = torch.randn(B, S, 3, H, D, generator=g, device=cuda_device
                        ).to(dtype)
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    mask = None
    if masked:
        mask = torch.rand(B, S, generator=g, device=cuda_device) > 0.3
        mask[0, :5] = False                    # rows 0..4: fully masked
    before = tfa.launches
    out, lse = tfa.flash_attention(q, k, v, mask, causal=True,
                                   window=window)
    assert tfa.launches == before + 1
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, mask, causal=True,
                                                 window=window)
    # bf16: the kernel rounds unnormalised probabilities to bf16 for the
    # V product, the plain version normalised ones (a few bf16 ulps).
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), atol=atol,
                               rtol=0)
    live = ref_lse > -1e29
    assert torch.equal(lse > -1e29, live)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)
