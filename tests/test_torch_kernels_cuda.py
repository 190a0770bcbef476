"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here is marked ``cuda`` and skips without a GPU.  The
file imports torch and the port only (no JAX), so on a GPU machine it
runs without the repo's JAX test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from distributed_tensorflow_tpu_torch.ops import attention as tattn
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


def _rel_err(got, want):
    """Max abs error over the largest reference magnitude."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-6)).item()


# K2 against its plain version.  bf16: the kernels round P and dS to bf16
# as tensor-core operands and the gradients to bf16 once; the plain
# version computes in fp32 and rounds once, so the two land within about
# one bf16 ulp (2^-8) of the largest gradient.  fp32: the order of fp32
# sums only.
K2_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,D,causal,window,masked", [
    (1024, 128, True, 0, False), (300, 128, True, 0, True),
    (300, 64, True, 64, True), (100, 64, False, 0, True),
    (48, 128, False, 0, False)])
def test_flash_backward_kernels_match_plain_on_card(cuda_device, dtype, S,
                                                    D, causal, window,
                                                    masked):
    g = torch.Generator(device=cuda_device).manual_seed(S + D)
    B, H = 2, 4
    fused = torch.randn(B, S, 3, H, D, generator=g, device=cuda_device
                        ).to(dtype)
    q, k, v = fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]
    mask = None
    if masked:
        mask = torch.rand(B, S, generator=g, device=cuda_device) > 0.3
        mask[0, :5] = False                    # causal rows 0..4: no key
    out, lse = tfa.flash_attention(q, k, v, mask, causal=causal,
                                   window=window)
    dout = torch.randn(B, S, H, D, generator=g, device=cuda_device).to(dtype)
    dq0, dkv0 = tfa.dq_launches, tfa.dkv_launches
    got = tfa.flash_attention_backward(q, k, v, mask, out, lse, dout,
                                       causal=causal, window=window)
    assert (tfa.dq_launches, tfa.dkv_launches) == (dq0 + 1, dkv0 + 1)
    want = tfa.flash_attention_backward_reference(
        q, k, v, mask, out, lse, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        assert _rel_err(a, b) <= K2_REL_TOL[dtype], (name, _rel_err(a, b))
    if masked and causal:
        assert not got[0][0, :5].any()         # exact zeros, not NaN


# The wgmma kernels' tiling: 128-row Q tiles and 128-row K tiles (K1),
# 128-row own tiles and 64-row streamed tiles (K2), so the sweep crosses
# every edge of both, and the serving (784) and train (1024) lengths.
SWEEP_S = (1, 63, 64, 65, 127, 129, 784, 1000, 1024)


def _fused_qkv(g, dev, B, S, H, D, dtype=torch.bfloat16):
    """q, k, v as strided views into one fused [B, S, 3, H, D] projection,
    as the model hands them over."""
    fused = torch.randn(B, S, 3, H, D, generator=g, device=dev).to(dtype)
    return fused[:, :, 0], fused[:, :, 1], fused[:, :, 2]


def _check_forward(q, k, v, mask, causal, window):
    out, lse = tfa.flash_attention(q, k, v, mask, causal=causal,
                                   window=window)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, mask,
                                                 causal=causal, window=window)
    # K1's tolerances (chip_smoke.py K1_OUT_TOL, K1_LSE_TOL).
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    live = ref_lse > -1e29
    assert torch.equal(lse > -1e29, live)
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3, rtol=0)
    return out, lse


def _check_backward(q, k, v, mask, out, lse, dout, causal, window):
    """K2 against its plain version: each gradient's max abs error over
    the largest magnitude of the three reference gradients, K2_REL_TOL.
    (At S = 1 the only probability is 1 and dS = dP - delta cancels: the
    exact dq and dk are 0, and both sides hold fp32 rounding noise, so a
    gradient is measured against the case's scale, not its own.)"""
    got = tfa.flash_attention_backward(q, k, v, mask, out, lse, dout,
                                       causal=causal, window=window)
    want = tfa.flash_attention_backward_reference(
        q, k, v, mask, out, lse, dout, causal=causal, window=window)
    torch.cuda.synchronize()
    scale = max(w.float().abs().max().item() for w in want)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == q.dtype and torch.isfinite(a).all(), name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= K2_REL_TOL[q.dtype] * max(scale, 1e-6), (name, err,
                                                               scale)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", SWEEP_S)
def test_flash_kernels_tile_edges_on_card(cuda_device, S, D, causal):
    g = torch.Generator(device=cuda_device).manual_seed(S * D + causal)
    q, k, v = _fused_qkv(g, cuda_device, 2, S, 2, D)
    counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    out, lse = _check_forward(q, k, v, None, causal, 0)
    dout = torch.randn(q.shape, generator=g, device=cuda_device
                       ).to(q.dtype)
    _check_backward(q, k, v, None, out, lse, dout, causal, 0)
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == tuple(
        n + 1 for n in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [300, 1024])
def test_flash_kernels_window_edge_off_tile_on_card(cuda_device, S, D):
    """A window of 100 keys: the band's lower edge falls inside a tile of
    every size the kernels use (64, 128)."""
    g = torch.Generator(device=cuda_device).manual_seed(S + D)
    q, k, v = _fused_qkv(g, cuda_device, 2, S, 4, D)
    out, lse = _check_forward(q, k, v, None, True, 100)
    dout = torch.randn(q.shape, generator=g, device=cuda_device
                       ).to(q.dtype)
    _check_backward(q, k, v, None, out, lse, dout, True, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_fully_masked_rows_on_card(cuda_device, D, causal):
    """kv_mask: batch 0 masks its first 70 keys (causal rows 0..69 see no
    key, across a 64-row tile edge), batch 1 its last 200 (masked keys
    take no gradient)."""
    g = torch.Generator(device=cuda_device).manual_seed(D + causal)
    B, S, H = 2, 784, 4
    q, k, v = _fused_qkv(g, cuda_device, B, S, H, D)
    mask = torch.ones(B, S, dtype=torch.bool, device=cuda_device)
    mask[0, :70] = False
    mask[1, S - 200:] = False
    out, lse = _check_forward(q, k, v, mask, causal, 0)
    dout = torch.randn(q.shape, generator=g, device=cuda_device
                       ).to(q.dtype)
    dq, dk, dv = _check_backward(q, k, v, mask, out, lse, dout, causal, 0)
    if causal:
        assert not out[0, :70].any() and not dq[0, :70].any()
        assert (lse.reshape(B, H, S)[0, :, :70] <= -1e29).all()
    assert not dk[1, S - 200:].any() and not dv[1, S - 200:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernels_are_bitwise_repeatable_on_card(cuda_device, D):
    """No atomics: two calls on the same inputs give the same bits, in
    the forward and in every gradient."""
    g = torch.Generator(device=cuda_device).manual_seed(D)
    q, k, v = (t.detach().requires_grad_() for t in
               _fused_qkv(g, cuda_device, 2, 1024, 4, D))
    dout = torch.randn(q.shape, generator=g, device=cuda_device
                       ).to(q.dtype)
    runs = []
    for _ in range(2):
        out, lse = tfa.flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out, (q, k, v), dout)
        runs.append((out, lse, *grads))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_kernels_launch_on_a_second_card():
    """Every kernel on cuda:1 while cuda:0 is current: the wrappers enter
    the operands' device and each launcher opts in to its shared memory on
    that card.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    dev = torch.device("cuda", 1)
    g = torch.Generator(device=dev).manual_seed(5)
    with torch.cuda.device(0):
        q, k, v = _fused_qkv(g, dev, 2, 300, 4, 128)
        out, lse = _check_forward(q, k, v, None, True, 0)
        dout = torch.randn(q.shape, generator=g, device=dev).to(q.dtype)
        _check_backward(q, k, v, None, out, lse, dout, True, 0)
        x = torch.randn(64, 2048, generator=g, device=dev)
        one = torch.ones(2048, device=dev)
        torch.testing.assert_close(
            ln.layer_norm(x, one, 0 * one),
            ln.layer_norm_reference(x, one, 0 * one), atol=1e-4, rtol=1e-5)
        xq, qw, sw = _qmm_inputs(g, dev, 200, 384, 640, torch.bfloat16)
        for got, want in (
                (qmm.quantized_matmul(xq, qw, sw),
                 qmm.quantized_matmul_reference(xq, qw, sw)),
                (qmm.quantized_matmul_nt(xq, *qmm.quantize_cols(qw.t().float())),
                 qmm.quantized_matmul_nt_reference(
                     xq, *qmm.quantize_cols(qw.t().float()))),
                (qmm.quantized_matmul_dgelu(xq, xq, qw, sw),
                 qmm.quantized_matmul_dgelu_reference(xq, xq, qw, sw))):
            peak = want.float().abs().max().item()
            assert (got.float() - want.float()).abs().max().item() <= \
                K45_TOL[torch.bfloat16](peak)
        qc, kc, vc, mask, m, l, acc = _chunk_inputs(g, dev, torch.bfloat16,
                                                    128, 128, 128, False)
        kw = dict(q_offset=128, k_offset=0, causal=True)
        got = tfa.flash_attention_chunk(qc, kc, vc, mask, m, l, acc, **kw)
        want = tfa.flash_attention_chunk_reference(qc, kc, vc, mask, m, l,
                                                   acc, **kw)
        assert _rel_err(got[2], want[2]) <= 1e-2
        lse_c = want[0] + torch.log(want[1])
        do = torch.randn(qc.shape, generator=g, device=dev).to(qc.dtype)
        delta = torch.randn(lse_c.shape, generator=g, device=dev)
        dq = tfa.flash_attention_chunk_dq(qc, kc, vc, mask, do, lse_c,
                                          delta, **kw)
        dk, dv = tfa.flash_attention_chunk_dkv(qc, kc, vc, mask, do, lse_c,
                                               delta, **kw)
        assert _rel_err(dq, tfa.flash_attention_chunk_dq_reference(
            qc, kc, vc, mask, do, lse_c, delta, **kw)) <= 1e-2
        for a, b in zip((dk, dv), tfa.flash_attention_chunk_dkv_reference(
                qc, kc, vc, mask, do, lse_c, delta, **kw)):
            assert _rel_err(a, b) <= 1e-2
        torch.cuda.synchronize(dev)


@pytest.mark.cuda
def test_flash_autograd_on_card_matches_dense_backend(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, S, H, D = 2, 256, 4, 128
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=cuda_device)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    dout = torch.randn(B, S, H, D, generator=g, device=cuda_device
                       ).to(torch.bfloat16)
    grads = []
    for backend in ("pallas", "xla"):
        out = tattn.dot_product_attention(q, k, v, causal=True,
                                          backend=backend)
        grads.append(torch.autograd.grad(out, (q, k, v), dout))
    for a, b in zip(*grads):
        # The dense path rounds its softmax weights to bf16 before the V
        # product and differentiates through that rounding: ~2 bf16 ulps.
        assert _rel_err(a, b) <= 2e-2


@pytest.mark.cuda
def test_layer_norm_grads_on_card_match_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn(64, 2048, generator=g, device=cuda_device) * 3 + 1
         ).to(torch.bfloat16).requires_grad_()
    scale = torch.randn(2048, generator=g, device=cuda_device
                        ).requires_grad_()
    bias = torch.randn(2048, generator=g, device=cuda_device).requires_grad_()
    dy = torch.randn(64, 2048, generator=g, device=cuda_device)
    before = ln.launches
    got = torch.autograd.grad(ln.layer_norm(x, scale, bias), (x, scale, bias),
                              dy)
    assert ln.launches == before + 1
    want = torch.autograd.grad(ln.layer_norm_reference(x, scale, bias),
                               (x, scale, bias), dy)
    # The backward differentiates the same plain formula on both sides.
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_gpt_train_step_on_card_launches_every_kernel(cuda_device):
    """A small GPT (head_dim 64: the kernels take 64 and 128) through
    TrainState and the sync step: each kernel launches once per layer (K3
    twice, plus the final norm) and the loss comes out in range."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState

    cfg = gpt.GptConfig(hidden_size=256, num_layers=2, num_heads=4,
                        intermediate_size=512, max_position=128,
                        attention_backend="pallas", fused_ln=True)
    model = gpt.GptLM(cfg, device=cuda_device, param_dtype=torch.float32)
    state = TrainState.create(model, make_optimizer("adam", 1e-3))

    def loss_fn(m, batch):
        tokens = torch.as_tensor(batch["tokens"], device=cuda_device).long()
        loss, acc = gpt.lm_loss(m(tokens), tokens)
        return loss, {"accuracy": acc}

    step = build_sync_train_step(loss_fn)
    batch = gpt.synthetic_lm_batch(0, 4, 128, cfg)
    counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches, ln.launches)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    L = cfg.num_layers
    assert (tfa.launches - counts[0], tfa.dq_launches - counts[1],
            tfa.dkv_launches - counts[2], ln.launches - counts[3]) == (
                L, L, L, 2 * L + 1)
    assert 4.0 < loss < 7.0 and state.global_step == 2


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    import math
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def _qmm_inputs(g, dev, M, K, N, dtype):
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = torch.randn(K, N, generator=g, device=dev) * 0.05
    qw, sw = qmm.quantize_cols(w)
    return x, qw, sw


# K4/K5 against their plain versions on the same inputs.  Both quantize
# with the same IEEE division and round half to even, add the exact int32
# K-block products into fp32 in the same order with every step rounded
# (no FMA contraction in the kernel), and evaluate tanh through the same
# tanhf: the outputs agree to within one ulp of the working dtype at the
# largest magnitude (bf16 2^-8 relative; fp32 a few 2^-24).
K45_TOL = {torch.bfloat16: _bf16_ulp, torch.float32: lambda x: 4e-6 * x}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("variant", ["plain", "bias", "gelu_preact",
                                     "residual"])
@pytest.mark.parametrize("M,K,N,block_k", [(200, 384, 640, 512),
                                           (1024, 2048, 1024, 1024),
                                           (64, 1024, 256, 128)])
def test_quantized_matmul_kernel_matches_plain_on_card(
        cuda_device, dtype, variant, M, K, N, block_k):
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    g = torch.Generator(device=cuda_device).manual_seed(M + K + N)
    x, qw, sw = _qmm_inputs(g, cuda_device, M, K, N, dtype)
    kw = dict(block_k=block_k)
    bias = residual = None
    if variant != "plain":
        bias = torch.randn(N, generator=g, device=cuda_device)
    if variant == "gelu_preact":
        kw.update(activation="gelu", want_preact=True)
    if variant == "residual":
        residual = torch.randn(M, N, generator=g, device=cuda_device
                               ).to(dtype)
    before = qmm.launches
    got = qmm.quantized_matmul(x, qw, sw, bias, residual, **kw)
    assert qmm.launches == before + 1
    want = qmm.quantized_matmul_reference(x, qw, sw, bias, residual, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == (M, N)
        peak = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= K45_TOL[dtype](peak), (err, peak)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prologue,want_g", [("fold", False),
                                             ("dgelu_fold", False),
                                             ("dgelu_fold", True)])
@pytest.mark.parametrize("M,K,N,block_k", [(200, 384, 640, 512),
                                           (1024, 2048, 1024, 1024)])
def test_quantized_matmul_nt_kernel_matches_plain_on_card(
        cuda_device, dtype, prologue, want_g, M, K, N, block_k):
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    g = torch.Generator(device=cuda_device).manual_seed(M + K + N + 1)
    da = torch.randn(M, K, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(N, K, generator=g, device=cuda_device) * 0.05
    qw, sw = qmm.quantize_cols(w)            # the forward's [N, K] weight
    pre = None
    if prologue == "dgelu_fold":
        pre = (2 * torch.randn(M, K, generator=g, device=cuda_device)
               ).to(dtype)
    kw = dict(prologue=prologue, want_g=want_g, block_k=block_k)
    before = qmm.nt_launches
    got = qmm.quantized_matmul_nt(da, qw, sw, pre, **kw)
    assert qmm.nt_launches == before + 1
    want = qmm.quantized_matmul_nt_reference(da, qw, sw, pre, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        peak = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= K45_TOL[dtype](peak), (err, peak)


@pytest.mark.cuda
def test_quantized_matmul_kernels_read_strided_rows(cuda_device):
    """x and da as row-strided views (a slice of wider rows) give what
    their contiguous copies give."""
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    g = torch.Generator(device=cuda_device).manual_seed(3)
    wide = torch.randn(256, 1024, generator=g, device=cuda_device
                       ).to(torch.bfloat16)
    x = wide[:, 256:768]
    w = torch.randn(512, 256, generator=g, device=cuda_device) * 0.05
    qw, sw = qmm.quantize_cols(w)
    torch.testing.assert_close(qmm.quantized_matmul(x, qw, sw),
                               qmm.quantized_matmul(x.contiguous(), qw, sw),
                               atol=0, rtol=0)
    qwt, swt = qmm.quantize_cols(w.t())                 # [256, 512]
    torch.testing.assert_close(
        qmm.quantized_matmul_nt(x, qwt, swt),
        qmm.quantized_matmul_nt(x.contiguous(), qwt, swt), atol=0, rtol=0)


@pytest.mark.cuda
def test_quantized_matmul_kernels_refuse_what_they_cannot_take(cuda_device):
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    x = torch.randn(64, 256, device=cuda_device).to(torch.bfloat16)
    qw, sw = qmm.quantize_cols(torch.randn(256, 200, device=cuda_device))
    with pytest.raises(ValueError, match="N % 128"):
        qmm.quantized_matmul(x, qw, sw)
    qw, sw = qmm.quantize_cols(torch.randn(192, 256, device=cuda_device))
    with pytest.raises(ValueError, match="K-block"):
        qmm.quantized_matmul(torch.randn(64, 192, device=cuda_device),
                             qw, sw)
    with pytest.raises(ValueError, match="fp32/bf16"):
        qmm.quantized_matmul(x.half(), *qmm.quantize_cols(
            torch.randn(256, 128, device=cuda_device)))


@pytest.mark.cuda
def test_int8_gpt_train_step_on_card_launches_k4_and_k5(cuda_device):
    """matmul_int8: each layer's gelu MLP runs two K4 and two K5 launches
    per step (the shapes pass the fused gate), and the loss is in range."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState

    cfg = gpt.GptConfig(hidden_size=256, num_layers=2, num_heads=4,
                        intermediate_size=512, max_position=128,
                        attention_backend="pallas", fused_ln=True,
                        matmul_int8=True)
    model = gpt.GptLM(cfg, device=cuda_device, param_dtype=torch.float32)
    state = TrainState.create(model, make_optimizer("adam", 1e-3))

    def loss_fn(m, batch):
        tokens = torch.as_tensor(batch["tokens"], device=cuda_device).long()
        loss, acc = gpt.lm_loss(m(tokens), tokens)
        return loss, {"accuracy": acc}

    step = build_sync_train_step(loss_fn)
    batch = gpt.synthetic_lm_batch(0, 4, 128, cfg)
    counts = (qmm.launches, qmm.nt_launches, tfa.launches)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    L = cfg.num_layers
    assert (qmm.launches - counts[0], qmm.nt_launches - counts[1],
            tfa.launches - counts[2]) == (2 * L, 2 * L, L)
    assert 4.0 < loss < 7.0 and state.global_step == 2
    assert all(torch.isfinite(p).all() for p in model.parameters())


# ---------------------------------------------------------------- K6, K7

# The ring's chunk kernels against their plain versions (fp32 math).
# bf16: the kernels round P (and dS) to bf16 as tensor-core operands, as
# K1/K2 do, so acc and the gradient partials land within about one bf16
# ulp (2^-8) of their largest magnitude; m and l sum unrounded fp32
# probabilities and differ only by where the 1/sqrt(D) scale is applied
# (after the product here, before it in the plain version).  fp32: the
# order of fp32 sums only.
CHUNK_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
CHUNK_M_ATOL = 1e-4            # running maxima of magnitude ~3
CHUNK_L_REL_TOL = 1e-4

# (Sq, Sk, D, q_offset, k_offset, causal, window, masked): a chunk in the
# past, on the diagonal, wholly in the future (every tile skipped), a
# window band, non-causal, ragged lengths and a fully masked row.
CHUNK_CASES = [(256, 256, 128, 768, 0, True, 0, False),
               (256, 256, 128, 512, 512, True, 0, False),
               (256, 256, 128, 0, 768, True, 0, False),
               (256, 256, 128, 512, 256, True, 300, True),
               (200, 136, 64, 136, 0, False, 0, True),
               (100, 100, 64, 100, 100, True, 0, True)]


def _chunk_inputs(g, dev, dtype, Sq, Sk, D, masked, B=2, H=4):
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
    # k and v as views into one fused [B, Sk, 2, H, D] tensor.
    kv = torch.randn(B, Sk, 2, H, D, generator=g, device=dev).to(dtype)
    mask = None
    if masked:
        mask = torch.rand(B, Sk, generator=g, device=dev) > 0.3
        mask[0] = False                        # batch 0: no valid key
    # A carry in flight: finite maxima, positive sums.
    m = torch.randn(B, H, Sq, generator=g, device=dev)
    l = 1 + torch.rand(B, H, Sq, generator=g, device=dev)
    acc = torch.randn(B, H, Sq, D, generator=g, device=dev)
    if masked:
        m[0], l[0], acc[0] = -1e30, 0.0, 0.0   # ... and nothing seen yet
    return q, kv[:, :, 0], kv[:, :, 1], mask, m, l, acc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_ring_chunk_kernels_match_plain_on_card(cuda_device, dtype, case):
    Sq, Sk, D, q_off, k_off, causal, window, masked = case
    g = torch.Generator(device=cuda_device).manual_seed(Sq + Sk + q_off)
    q, k, v, mask, m, l, acc = _chunk_inputs(g, cuda_device, dtype, Sq, Sk,
                                             D, masked)
    kw = dict(q_offset=q_off, k_offset=k_off, causal=causal, window=window)
    before = tfa.chunk_launches
    got = tfa.flash_attention_chunk(q, k, v, mask, m, l, acc, **kw)
    assert tfa.chunk_launches == before + 1
    want = tfa.flash_attention_chunk_reference(q, k, v, mask, m, l, acc,
                                               **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("m", "l", "acc"), got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
    assert (got[0] - want[0]).abs().max() <= CHUNK_M_ATOL
    assert _rel_err(got[1], want[1]) <= CHUNK_L_REL_TOL
    assert _rel_err(got[2], want[2]) <= CHUNK_REL_TOL[dtype]
    if causal and q_off + Sq <= k_off:            # wholly in the future
        for a, b in zip(got, (m, l, acc)):
            assert torch.equal(a, b)
    if masked:
        assert torch.equal(got[0][0], m[0]) and not got[2][0].any()

    # The backward partials from a finished state's lse.
    lse = want[0] + torch.log(want[1].clamp_min(1e-30))
    do = torch.randn(q.shape, generator=g, device=cuda_device).to(dtype)
    delta = torch.randn(lse.shape, generator=g, device=cuda_device)
    counts = (tfa.chunk_dq_launches, tfa.chunk_dkv_launches)
    dq = tfa.flash_attention_chunk_dq(q, k, v, mask, do, lse, delta, **kw)
    dk, dv = tfa.flash_attention_chunk_dkv(q, k, v, mask, do, lse, delta,
                                           **kw)
    assert (tfa.chunk_dq_launches, tfa.chunk_dkv_launches) == (
        counts[0] + 1, counts[1] + 1)
    want_dq = tfa.flash_attention_chunk_dq_reference(q, k, v, mask, do, lse,
                                                     delta, **kw)
    want_dk, want_dv = tfa.flash_attention_chunk_dkv_reference(
        q, k, v, mask, do, lse, delta, **kw)
    torch.cuda.synchronize()
    for name, a, b in (("dq", dq, want_dq), ("dk", dk, want_dk),
                       ("dv", dv, want_dv)):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        if b.abs().max() == 0:                    # nothing visible
            assert not a.any(), name
        else:
            assert _rel_err(a, b) <= CHUNK_REL_TOL[dtype], (name,
                                                            _rel_err(a, b))
    if masked:
        assert not dq[0].any() and not dk[0].any() and not dv[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 300])
def test_ring_on_card_matches_flash_kernels(cuda_device, window):
    """Four sequence shards on one card through K6/K7 against K1/K2 over
    the whole sequence: output and gradients, with 16 launches (4 shards x
    4 hops; 4 x 3 with the truncated window ring) of each chunk kernel."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.parallel.ring import (
        _ring_hops, make_ring_attention)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, S, H, D = 2, 1024, 4, 128
    fused = torch.randn(B, S, 3, H, D, generator=g, device=cuda_device
                        ).to(torch.bfloat16)
    q, k, v = (fused[:, :, i].detach().requires_grad_() for i in range(3))
    dout = torch.randn(B, S, H, D, generator=g, device=cuda_device
                       ).to(torch.bfloat16)
    mesh = create_mesh(data=1, seq=4, devices=[cuda_device] * 4)
    ring = make_ring_attention(mesh, causal=True, window=window)
    counts = (tfa.chunk_launches, tfa.chunk_dq_launches,
              tfa.chunk_dkv_launches, tfa.launches)
    out = ring(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout)
    hops = _ring_hops(4, S // 4, True, window)         # 4, or 3 (window)
    assert (tfa.chunk_launches - counts[0], tfa.chunk_dq_launches - counts[1],
            tfa.chunk_dkv_launches - counts[2], tfa.launches - counts[3]) \
        == (4 * hops, 4 * hops, 4 * hops, 0)
    ref = tfa.flash_attention(q, k, v, causal=True, window=window)[0]
    want = torch.autograd.grad(ref, (q, k, v), dout)
    # Both round P (and dS) to bf16 as tensor-core operands: a few bf16
    # ulps on the output, about one of the largest gradient.
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=0)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel_err(a, b) <= 1e-2, (name, _rel_err(a, b))


@pytest.mark.cuda
def test_gpt_ring_train_step_on_card_launches_the_chunk_kernels(
        cuda_device):
    """A small ring GPT (head_dim 64) on a seq=4 mesh of one card: per
    step n_seq x hops x layers launches of K6, K7a and K7b, none of K1/K2,
    K3 as in the pallas step, the loss in range."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState

    cfg = gpt.GptConfig(hidden_size=256, num_layers=2, num_heads=4,
                        intermediate_size=512, max_position=128,
                        attention_backend="ring", fused_ln=True)
    mesh = create_mesh(data=1, seq=4, devices=[cuda_device] * 4)
    model = gpt.GptLM(cfg, device=cuda_device, param_dtype=torch.float32,
                      mesh=mesh)
    state = TrainState.create(model, make_optimizer("adam", 1e-3))

    def loss_fn(m, batch):
        tokens = torch.as_tensor(batch["tokens"], device=cuda_device).long()
        loss, acc = gpt.lm_loss(m(tokens), tokens)
        return loss, {"accuracy": acc}

    step = build_sync_train_step(loss_fn)
    batch = gpt.synthetic_lm_batch(0, 4, 128, cfg)
    counts = (tfa.chunk_launches, tfa.chunk_dq_launches,
              tfa.chunk_dkv_launches, tfa.launches, tfa.dq_launches,
              ln.launches)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    L = cfg.num_layers
    assert (tfa.chunk_launches - counts[0], tfa.chunk_dq_launches - counts[1],
            tfa.chunk_dkv_launches - counts[2], tfa.launches - counts[3],
            tfa.dq_launches - counts[4], ln.launches - counts[5]) == (
                16 * L, 16 * L, 16 * L, 0, 0, 2 * L + 1)
    assert 4.0 < loss < 7.0 and state.global_step == 2


# -------------------------------------------------------------------- K8

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("want_g", [False, True])
@pytest.mark.parametrize("M,K,N,block_k", [(200, 384, 640, 512),
                                           (1024, 2048, 1024, 512),
                                           (256, 1024, 256, 1024)])
def test_quantized_matmul_dgelu_kernel_matches_plain_on_card(
        cuda_device, dtype, want_g, M, K, N, block_k):
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    g = torch.Generator(device=cuda_device).manual_seed(M + K + N + 2)
    da = torch.randn(M, K, generator=g, device=cuda_device).to(dtype)
    pre = (2 * torch.randn(M, K, generator=g, device=cuda_device)).to(dtype)
    qwt, swt = qmm.quantize_cols(
        torch.randn(K, N, generator=g, device=cuda_device) * 0.05)
    kw = dict(want_g=want_g, block_k=block_k)
    before = qmm.dgelu_launches
    got = qmm.quantized_matmul_dgelu(da, pre, qwt, swt, **kw)
    assert qmm.dgelu_launches == before + 1
    want = qmm.quantized_matmul_dgelu_reference(da, pre, qwt, swt, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        peak = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= K45_TOL[dtype](peak), (err, peak)
