"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here is marked ``cuda`` and skips without a GPU.  The
file imports torch and the port only (no JAX), so on a GPU machine it
runs without the repo's JAX test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses

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


# K3 at the decode (8), prefill (784) and train (8192) row counts and one
# row, across both kernels: rows in registers up to H = 8192 (one to four
# warps a row; 1001 is ragged, so it takes one-element accesses), one
# block a row in shared memory at 16384.  Held to chip_smoke.py's K3_TOL.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("H", [128, 1000, 1001, 2048, 8192, 16384])
@pytest.mark.parametrize("rows", [1, 8, 784, 8192])
def test_layer_norm_kernels_at_every_row_count_and_width_on_card(
        cuda_device, rows, H, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(rows + H)
    x = (torch.randn(rows, H, generator=g, device=cuda_device) * 3 + 1
         ).to(dtype)
    scale = torch.randn(H, generator=g, device=cuda_device)
    bias = torch.randn(H, generator=g, device=cuda_device)
    before = ln.launches
    got = ln.layer_norm(x, scale, bias)
    assert ln.launches == before + 1 and got.dtype == torch.float32
    want = ln.layer_norm_reference(x, scale, bias)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_layer_norm_kernel_reads_an_unaligned_row_on_card(cuda_device):
    """x contiguous but 2 bytes off a 16-byte boundary: the one-element
    accesses of the register kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    flat = torch.randn(8 * 2048 + 1, generator=g, device=cuda_device
                       ).to(torch.bfloat16)
    x = flat[1:].view(8, 2048)
    assert x.is_contiguous() and x.data_ptr() % 16
    scale = torch.randn(2048, generator=g, device=cuda_device)
    bias = torch.randn(2048, generator=g, device=cuda_device)
    torch.testing.assert_close(ln.layer_norm(x, scale, bias),
                               ln.layer_norm_reference(x, scale, bias),
                               atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,D,window,masked", [
    (784, 128, 0, False), (112, 128, 0, True), (100, 64, 32, False),
    (48, 64, 0, True), (300, 128, 64, True), (784, 32, 0, False),
    (300, 32, 64, True)])
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
    (48, 128, False, 0, False), (1024, 32, True, 0, False),
    (300, 32, True, 64, True), (100, 32, False, 0, True)])
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
@pytest.mark.parametrize("D", [32, 64, 128])
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
@pytest.mark.parametrize("D", [32, 64, 128])
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
@pytest.mark.parametrize("D", [32, 64, 128])
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
@pytest.mark.parametrize("D", [32, 64, 128])
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
def test_launch_reads_the_card_and_stream_that_torch_cuda_reports(
        cuda_device):
    """``kernels.launch`` reads the current card and stream through
    PyTorch's private bindings (``torch._C._cuda_getDevice``,
    ``torch._C._cuda_getCurrentRawStream``): they must exist and give
    what ``torch.cuda.current_device()`` and
    ``torch.cuda.current_stream(i).cuda_stream`` give, on the default
    stream and inside a side stream, so a PyTorch that renames them fails
    here by name."""
    idx = torch.cuda.current_device()
    assert torch._C._cuda_getDevice() == idx
    assert (torch._C._cuda_getCurrentRawStream(idx)
            == torch.cuda.current_stream(idx).cuda_stream)
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        assert torch._C._cuda_getCurrentRawStream(idx) == side.cuda_stream
        x = torch.randn(8, 2048, device=cuda_device)
        one = torch.ones(2048, device=cuda_device)
        got = ln.layer_norm(x, one, 0 * one)
    side.synchronize()
    torch.testing.assert_close(got, ln.layer_norm_reference(x, one, 0 * one),
                               atol=1e-4, rtol=1e-5)


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


@pytest.mark.cuda
def test_gpt_train_step_at_the_jax_default_width_on_card(cuda_device):
    """The JAX GptConfig's default width (hidden 128, 4 heads: head_dim
    32) with attention_backend="pallas" and fused_ln: one step launches
    K1, K2b, K2a once per layer and K3 2L + 1 times, and its loss and
    gradients match the plain path (dense attention, plain LayerNorm) with
    the same fp32 masters and batch, within chip_smoke.py's TRAIN_*
    tolerances."""
    from distributed_tensorflow_tpu_torch.models import gpt

    cfg = gpt.GptConfig(attention_backend="pallas", fused_ln=True)
    assert cfg.head_dim == 32
    model = gpt.GptLM(cfg, device=cuda_device, param_dtype=torch.float32)
    plain = gpt.GptLM(dataclasses.replace(cfg, attention_backend="xla",
                                          fused_ln=False),
                      device=cuda_device, param_dtype=torch.float32)
    plain.load_state_dict(model.state_dict())
    tokens = torch.as_tensor(gpt.synthetic_lm_batch(0, 4, 128, cfg)[
        "tokens"], device=cuda_device).long()
    counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches, ln.launches)
    steps = []
    for m in (model, plain):
        loss, _ = gpt.lm_loss(m(tokens), tokens)
        loss.backward()
        steps.append((loss.item(), torch.cat(
            [p.grad.flatten() for p in m.parameters()])))
    L = cfg.num_layers
    assert (tfa.launches - counts[0], tfa.dq_launches - counts[1],
            tfa.dkv_launches - counts[2], ln.launches - counts[3]) == (
                L, L, L, 2 * L + 1)
    (la, ga), (lb, gb) = steps
    assert 4.0 < la < 7.0 and abs(la - lb) <= 1e-3
    assert abs(ga.norm() - gb.norm()) / gb.norm() <= 2e-3
    assert torch.nn.functional.cosine_similarity(ga, gb, dim=0) >= 0.999


# chip_smoke.py's train_parallel arms: (seq, model, backend).
PARALLEL_ARMS = {"tp2": (1, 2, "pallas"), "ulysses4": (4, 1, "ulysses"),
                 "tp2_ring2": (2, 2, "ring"), "tp2_ulysses2": (2, 2, "ulysses")}


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(PARALLEL_ARMS))
def test_parallel_train_step_on_card_matches_the_pallas_step(cuda_device,
                                                            arm):
    """One step of a small GPT (head_dim 64, 8 heads) placed by
    ``ParallelConfig.place_state`` on a seq x model mesh of positions on
    the one card: the loss and the gathered gradients match the unsharded
    pallas step within chip_smoke.py's TRAIN_* tolerances, and the
    kernels launch exactly per shard: K1/K2 once a layer per (model
    column, seq device) for pallas and ulysses, K6/K7 once a hop per
    (model column, seq shard) for the ring, K3 2L + 1 (replicated)."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.mesh import ParallelConfig
    from distributed_tensorflow_tpu_torch.parallel.sharding import (
        gather_named)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState

    seq, model_axis, backend = PARALLEL_ARMS[arm]
    pc = ParallelConfig(model=model_axis, seq=seq, attention=backend)
    mesh = pc.build_mesh([cuda_device] * (seq * model_axis))
    cfg = gpt.GptConfig(hidden_size=512, num_layers=2, num_heads=8,
                        intermediate_size=1024, max_position=256,
                        attention_backend=backend, fused_ln=True)
    model = gpt.GptLM(cfg, device=cuda_device, param_dtype=torch.float32,
                      mesh=mesh)
    plain = gpt.GptLM(dataclasses.replace(cfg, attention_backend="pallas"),
                      device=cuda_device, param_dtype=torch.float32)
    plain.load_state_dict(model.state_dict())
    state = pc.place_state(mesh, TrainState.create(
        model, make_optimizer("adam", 1e-3), params_to_tree=gpt.params_to_jax,
        params_from_tree=gpt.params_from_jax), gpt.gpt_sharding_rules())
    tokens = torch.as_tensor(gpt.synthetic_lm_batch(0, 4, 256, cfg)[
        "tokens"], device=cuda_device).long()
    names = ("launches", "dq_launches", "dkv_launches", "chunk_launches",
             "chunk_dq_launches", "chunk_dkv_launches")
    steps = []
    for m in (state.model, plain):
        before = [getattr(tfa, n) for n in names] + [ln.launches]
        loss, _ = gpt.lm_loss(m(tokens), tokens)
        loss.backward()
        after = [getattr(tfa, n) for n in names] + [ln.launches]
        grads = gather_named(m, {n: p.grad for n, p in m.named_parameters()})
        steps.append((loss.item(), torch.cat(
            [grads[n].flatten() for n, _ in plain.named_parameters()]),
            [a - b for a, b in zip(after, before)]))
    L = cfg.num_layers
    flash = 0 if backend == "ring" else L * model_axis * seq
    chunk = L * model_axis * seq * seq if backend == "ring" else 0
    assert steps[0][2] == [flash] * 3 + [chunk] * 3 + [2 * L + 1]
    (la, ga, _), (lb, gb, _) = steps
    assert 4.0 < la < 7.0 and abs(la - lb) <= 1e-3
    assert abs(ga.norm() - gb.norm()) / gb.norm() <= 2e-3
    assert torch.nn.functional.cosine_similarity(ga, gb, dim=0) >= 0.999


# chip_smoke.py's train_data arms: (data, seq, model, backend, fsdp).
DATA_ARMS = {"dp2": (2, 1, 1, "pallas", False),
             "dp2_tp2": (2, 1, 2, "pallas", False),
             "dp2_ring2": (2, 2, 1, "ring", False),
             "fsdp_dp2": (2, 1, 1, "pallas", True)}


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(DATA_ARMS))
def test_data_rows_train_step_on_card(cuda_device, arm):
    """Two steps of a small GPT over two local data rows on the one card
    (``ParallelConfig.place_state``: a model copy a row, beside tp2 or
    ring2, or FSDP over the rows): the first step's loss within
    chip_smoke.py's TRAIN_* of the unsharded pallas step's, each row's
    kernels launched on its half of the batch, the rows bit-equal after
    the steps."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel.mesh import ParallelConfig
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState

    data, seq, model_axis, backend, fsdp = DATA_ARMS[arm]
    pc = ParallelConfig(data=data, model=model_axis, seq=seq,
                        attention=backend, fsdp=fsdp, fsdp_min_size=4096)
    mesh = pc.build_mesh([cuda_device] * (data * seq * model_axis))
    cfg = gpt.GptConfig(hidden_size=512, num_layers=2, num_heads=8,
                        intermediate_size=1024, max_position=256,
                        attention_backend=backend, fused_ln=True)
    model = gpt.GptLM(cfg, device=cuda_device, param_dtype=torch.float32,
                      mesh=mesh)
    plain = gpt.GptLM(dataclasses.replace(cfg, attention_backend="pallas"),
                      device=cuda_device, param_dtype=torch.float32)
    plain.load_state_dict(model.state_dict())
    state = pc.place_state(mesh, TrainState.create(
        model, make_optimizer("adam", 1e-3), params_to_tree=gpt.params_to_jax,
        params_from_tree=gpt.params_from_jax), gpt.gpt_sharding_rules())
    assert len(state.rows) == data - 1

    def loss_fn(m, batch):
        t = torch.as_tensor(batch["tokens"], device=cuda_device).long()
        return gpt.lm_loss(m(t), t)[0], {}
    batch = gpt.synthetic_lm_batch(0, 4, 256, cfg)
    want, _ = loss_fn(plain, batch)
    step = build_sync_train_step(loss_fn)
    names = ("launches", "dq_launches", "dkv_launches", "chunk_launches",
             "chunk_dq_launches", "chunk_dkv_launches")
    before = [getattr(tfa, n) for n in names] + [ln.launches]
    state, metrics = step(state, batch)
    after = [getattr(tfa, n) for n in names] + [ln.launches]
    state, _ = step(state, gpt.synthetic_lm_batch(1, 4, 256, cfg))
    L = cfg.num_layers
    flash = 0 if backend == "ring" else data * L * model_axis * seq
    chunk = data * L * model_axis * seq * seq if backend == "ring" else 0
    assert [a - b for a, b in zip(after, before)] == (
        [flash] * 3 + [chunk] * 3 + [data * (2 * L + 1)])
    assert abs(float(metrics["loss"]) - want.item()) <= 1e-3
    lead = dict(state.model.named_parameters())
    for row in state.rows:
        for n, p in row.named_parameters():
            if getattr(p, "fsdp_info", None) is None:
                assert torch.equal(p, lead[n]), n


@pytest.mark.cuda
def test_async_local_step_runs_each_replica_through_the_kernels_on_card(
        cuda_device):
    """One async local step of two replicas (``parallel/async_replicas``)
    at the JAX default width with the kernels: each replica's forward and
    backward launches K1, K2b, K2a once a layer and K3 2L + 1 times (2x in
    all), each replica's update equals a sync step of the same model on
    its half of the batch through the same kernels, and the merge sets
    both copies to their mean."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.parallel import async_replicas
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        _split, build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)
    from distributed_tensorflow_tpu_torch.training.state import TrainState

    cfg = gpt.GptConfig(attention_backend="pallas", fused_ln=True)

    def state():
        torch.manual_seed(0)
        model = gpt.GptLM(cfg, device=cuda_device, param_dtype=torch.float32)
        return TrainState.create(model, make_optimizer("adam", 1e-3))

    def loss_fn(model, tokens):
        loss, accuracy = gpt.lm_loss(model(tokens), tokens)
        return loss, {"accuracy": accuracy}

    tokens = torch.as_tensor(gpt.synthetic_lm_batch(0, 4, 128, cfg)[
        "tokens"], device=cuda_device).long()
    local = async_replicas.build_async_local_step(loss_fn)
    astate = async_replicas.make_async_state(state(), 2)
    counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches, ln.launches)
    astate, raw = local(astate, tokens)
    L = cfg.num_layers
    assert (tfa.launches - counts[0], tfa.dq_launches - counts[1],
            tfa.dkv_launches - counts[2], ln.launches - counts[3]) == (
                2 * L, 2 * L, 2 * L, 2 * (2 * L + 1))
    for r in (0, 1):
        solo = state()
        solo, m = build_sync_train_step(loss_fn)(solo, _split(tokens, 2, r))
        for n, p in solo.model.named_parameters():
            torch.testing.assert_close(astate.params[n][r], p.detach(),
                                       atol=1e-6, rtol=0)
        assert abs(float(raw["loss"][r]) - float(m["loss"])) <= 1e-6
    async_replicas.build_merge_step()(astate)
    for t in astate.params.values():
        assert torch.equal(t[0], t[1])


@pytest.mark.cuda
def test_cached_decode_family_gives_the_plain_tokens_on_card(cuda_device):
    """generate_cached and generate_cached_speculative_device on a small
    fp32 model through K1 (prefill) and K3 (every LayerNorm) give the
    greedy tokens of the same model on the plain path (dense attention,
    plain LayerNorm): K1 once a layer a prefill, K3 2L + 1 a prefill and a
    decode step or chunk."""
    import numpy as np

    from distributed_tensorflow_tpu_torch.models import gpt

    cfg = gpt.GptConfig(vocab_size=64, hidden_size=128, num_layers=2,
                        num_heads=4, intermediate_size=256,
                        max_position=128, dtype="float32",
                        attention_backend="pallas", fused_ln=True)
    model = gpt.GptLM(cfg, device=cuda_device, seed=1)
    plain = gpt.GptLM(dataclasses.replace(cfg, attention_backend="xla",
                                          fused_ln=False),
                      device=cuda_device)
    plain.load_state_dict(model.state_dict())
    phrase = np.random.default_rng(0).integers(0, 64, 9)
    prompt = np.stack([np.resize(phrase, 40), np.resize(phrase[4:], 40)])
    L, N = cfg.num_layers, 24
    want = gpt.generate_cached(plain, None, prompt, N)
    before = (tfa.launches, ln.launches)
    got = gpt.generate_cached(model, None, prompt, N)
    assert (tfa.launches - before[0], ln.launches - before[1]) == (
        L, (2 * L + 1) * N)
    assert torch.equal(got, want)
    before = (tfa.launches, ln.launches)
    spec, stats = gpt.generate_cached_speculative_device(model, None,
                                                         prompt, N)
    assert (tfa.launches - before[0], ln.launches - before[1]) == (
        L, (2 * L + 1) * (1 + stats["rounds"]))
    assert torch.equal(spec, want)


@pytest.mark.cuda
def test_checkpoint_round_trip_serves_through_the_kernels_on_card(
        cuda_device, tmp_path):
    """save_raw -> restore_raw -> the serving CLI's restore recipe on the
    card: the restored model (K1 in the prefill, K3 in every LayerNorm)
    gives the in-memory model's logits, exactly: the same weights in the
    same dtypes through the same kernels."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.tools import checkpoint_io, serve
    from distributed_tensorflow_tpu_torch.tools.export_model import (
        clear_restore_memo)

    cfg = gpt.GptConfig(vocab_size=64, hidden_size=256, num_layers=2,
                        num_heads=2, intermediate_size=512,
                        max_position=128, dtype="bfloat16",
                        attention_backend="pallas", fused_ln=True)
    model = gpt.GptLM(cfg, device=cuda_device, seed=2)
    checkpoint_io.save_raw(
        str(tmp_path / "checkpoints"), 5,
        {"params": gpt.params_to_jax(model.state_dict()),
         "global_step": torch.tensor(5, dtype=torch.int32)})
    restored, step, _ = checkpoint_io.restore_raw(str(tmp_path))
    assert step == 5 and int(restored["global_step"]) == 5
    clear_restore_memo()
    rcfg, tree, step = serve.load_gpt_serving_model(str(tmp_path))
    assert step == 5 and rcfg == cfg
    again = gpt.GptLM(rcfg, device=cuda_device, seed=3)
    again.load_state_dict(gpt.params_from_jax(tree))
    tokens = torch.randint(0, 64, (2, 100), device=cuda_device,
                           generator=torch.Generator(
                               device=cuda_device).manual_seed(0))
    logits = []
    for m in (model, again):
        before = (tfa.launches, ln.launches)
        caches = gpt.init_kv_cache(cfg, 2, 100, device=cuda_device)
        logits.append(m.prefill(tokens, caches)[0])
        assert (tfa.launches - before[0], ln.launches - before[1]) == (
            cfg.num_layers, 2 * cfg.num_layers + 1)
    assert torch.equal(logits[0], logits[1])
    clear_restore_memo()


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
    before = (qmm.launches, qmm.quantize_launches, qmm.transpose_launches,
              qmm.gemm_launches)
    got = qmm.quantized_matmul(x, qw, sw, bias, residual, **kw)
    # One K4 call: kernel A (the quantize pass), the weight's transpose,
    # then kernel B (the GEMM).
    assert (qmm.launches, qmm.quantize_launches, qmm.transpose_launches,
            qmm.gemm_launches) == tuple(n + 1 for n in before)
    want = qmm.quantized_matmul_reference(x, qw, sw, bias, residual, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == (M, N)
        if variant != "gelu_preact":
            # No tanh enters: the same bits as the plain version.
            assert torch.equal(a, b)
            continue
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
    before = (qmm.nt_launches, qmm.quantize_launches, qmm.gemm_launches)
    got = qmm.quantized_matmul_nt(da, qw, sw, pre, **kw)
    assert (qmm.nt_launches, qmm.quantize_launches,
            qmm.gemm_launches) == tuple(n + 1 for n in before)
    want = qmm.quantized_matmul_nt_reference(da, qw, sw, pre, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        if prologue == "fold":
            # No tanh enters: the same bits as the plain version.
            assert torch.equal(a, b)
            continue
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
    # The two stages on their own.
    with pytest.raises(ValueError, match="K-block"):
        qmm.quantize_blocks(x, 384)
    with pytest.raises(ValueError, match="want_g needs pre"):
        qmm.quantize_blocks(x, 128, want_g=True)
    q, sx, _ = qmm.quantize_blocks(x, 128)
    w = torch.zeros(200, 256, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="N % 128"):
        qmm.blocked_gemm(q, sx, w, 128)
    with pytest.raises(ValueError, match="sx shape"):
        qmm.blocked_gemm(q, sx.t(), w[:128], 128)
    with pytest.raises(ValueError, match="epilogue"):
        qmm.blocked_gemm(q, sx, w[:128], 128, bias=torch.zeros(
            128, device=cuda_device))


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
    counts = (qmm.launches, qmm.nt_launches, tfa.launches,
              qmm.quantize_launches, qmm.gemm_launches,
              qmm.transpose_launches)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    L = cfg.num_layers
    # Each K4 and K5 call runs kernel A, then kernel B; K4 transposes its
    # weight between them.
    assert (qmm.launches - counts[0], qmm.nt_launches - counts[1],
            tfa.launches - counts[2], qmm.quantize_launches - counts[3],
            qmm.gemm_launches - counts[4],
            qmm.transpose_launches - counts[5]) == (
                2 * L, 2 * L, L, 4 * L, 4 * L, 2 * L)
    assert 4.0 < loss < 7.0 and state.global_step == 2
    assert all(torch.isfinite(p).all() for p in model.parameters())


# ------------------------------------------------- K4/K5 kernels A and B

QUANT_PROLOGUES = ("none", "fold", "dgelu_fold", "dgelu_fold_want_g")


def _quant_operands(g, dev, M, K, dtype, prologue):
    a = torch.randn(M, K, generator=g, device=dev).to(dtype)
    pre = sf = None
    if prologue != "none":
        sf = 0.01 + 0.01 * torch.rand(K, generator=g, device=dev)
    if prologue.startswith("dgelu"):
        pre = (2 * torch.randn(M, K, generator=g, device=dev)).to(dtype)
    return a, pre, sf


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prologue", QUANT_PROLOGUES)
@pytest.mark.parametrize("M,K,bk", [(200, 384, 128), (64, 1024, 256),
                                    (1024, 2048, 512), (256, 2048, 1024)])
def test_quantize_blocks_kernel_is_bit_equal_to_plain_on_card(
        cuda_device, dtype, prologue, M, K, bk):
    """Kernel A against its plain version on the same inputs: codes,
    scales and g bit for bit (the same IEEE division, rounding half to
    even; gelu' in the plain version's operation order), at every K-block
    width and row count."""
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    g = torch.Generator(device=cuda_device).manual_seed(M + K + bk)
    a, pre, sf = _quant_operands(g, cuda_device, M, K, dtype, prologue)
    want_g = prologue.endswith("want_g")
    before = qmm.quantize_launches
    got = qmm.quantize_blocks(a, bk, pre, sf, want_g=want_g)
    assert qmm.quantize_launches == before + 1
    want = qmm.quantize_blocks_reference(a, bk, pre, sf, want_g=want_g)
    torch.cuda.synchronize()
    for name, x, y in zip(("q", "sx", "g"), got, want):
        if y is None:
            assert x is None, name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


GEMM_EPILOGUES = {"none": dict(), "plain": dict(sw=True),
                  "bias": dict(sw=True, bias=True),
                  "bias_residual": dict(sw=True, bias=True, residual=True),
                  "bias_gelu_preact": dict(sw=True, bias=True,
                                           activation="gelu",
                                           want_preact=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("epilogue", sorted(GEMM_EPILOGUES))
@pytest.mark.parametrize("M,K,N,bk", [(200, 384, 640, 128),
                                      (1024, 2048, 1024, 1024),
                                      (64, 1024, 256, 512)])
def test_blocked_gemm_kernel_is_bit_equal_to_plain_on_card(
        cuda_device, dtype, epilogue, M, K, N, bk):
    """Kernel B against its plain version on the same codes and scales:
    bit for bit where no tanh enters (the int32 K-block sums are exact and
    promoted with the plain version's roundings, in its order); with gelu
    within one ulp of the working dtype at the peak, as K4."""
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    spec = GEMM_EPILOGUES[epilogue]
    g = torch.Generator(device=cuda_device).manual_seed(M + K + N + bk)
    q = torch.randint(-127, 128, (M, K), generator=g, device=cuda_device,
                      dtype=torch.int8)
    sx = 0.01 * (1 + torch.rand(K // bk, M, generator=g, device=cuda_device))
    w = torch.randint(-127, 128, (N, K), generator=g, device=cuda_device,
                      dtype=torch.int8)
    args = [None, None, None]
    if spec.get("sw"):
        args[0] = 1e-3 * (1 + torch.rand(N, generator=g, device=cuda_device))
    if spec.get("bias"):
        args[1] = torch.randn(N, generator=g, device=cuda_device)
    if spec.get("residual"):
        args[2] = torch.randn(M, N, generator=g, device=cuda_device
                              ).to(dtype)
    kw = {k: v for k, v in spec.items() if k in ("activation",
                                                 "want_preact")}
    before = qmm.gemm_launches
    got = qmm.blocked_gemm(q, sx, w, bk, *args, out_dtype=dtype, **kw)
    assert qmm.gemm_launches == before + 1
    want = qmm.blocked_gemm_reference(q, sx, w, bk, *args, out_dtype=dtype,
                                      **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == dtype and a.shape == (M, N)
        if "activation" not in kw or i == 1:   # pre comes before gelu
            assert torch.equal(a, b)
            continue
        peak = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= K45_TOL[dtype](peak), (err, peak)


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", [(2048, 8192), (8192, 2048), (384, 640),
                                 (64, 128)])
def test_transpose_kernel_is_bit_equal_to_plain_on_card(cuda_device, R, C):
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    g = torch.Generator(device=cuda_device).manual_seed(R + C)
    w = torch.randint(-127, 128, (R, C), generator=g, device=cuda_device,
                      dtype=torch.int8)
    before = qmm.transpose_launches
    got = qmm.transpose_s8(w)
    assert qmm.transpose_launches == before + 1
    assert got.is_contiguous() and torch.equal(got, w.t())
    with pytest.raises(ValueError, match="multiples of 64"):
        qmm.transpose_s8(w[:, :C - 32])


@pytest.mark.cuda
def test_quantized_matmul_kernels_are_bitwise_repeatable_on_card(
        cuda_device):
    """Two calls of K4 (every epilogue output) and K5 (with g) on the same
    inputs give the same bits: no atomics, no order that changes."""
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    g = torch.Generator(device=cuda_device).manual_seed(9)
    x, qw, sw = _qmm_inputs(g, cuda_device, 1000, 2048, 1024,
                            torch.bfloat16)
    bias = torch.randn(1024, generator=g, device=cuda_device)
    pre = (2 * torch.randn(1000, 2048, generator=g, device=cuda_device)
           ).to(torch.bfloat16)
    qwn, swn = qmm.quantize_cols(torch.randn(1024, 2048, generator=g,
                                             device=cuda_device) * 0.05)
    runs = [(*qmm.quantized_matmul(x, qw, sw, bias, activation="gelu",
                                   want_preact=True),
             *qmm.quantized_matmul_nt(x, qwn, swn, pre,
                                      prologue="dgelu_fold", want_g=True))
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("out", "pre", "dx", "g"), *runs):
        assert torch.equal(a, b), name


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
               (100, 100, 64, 100, 100, True, 0, True),
               (256, 256, 32, 256, 256, True, 0, False),
               (200, 136, 32, 136, 0, True, 100, True),
               (100, 100, 32, 0, 100, True, 0, False)]
# The ring's three hop kinds at its per-hop shape (B 2, H 4): visible,
# diagonal, future; for K6's in-place form.
HOP_CASES = [(256, 256, 128, 768, 0, True, 0, False),
             (256, 256, 128, 512, 512, True, 0, False),
             (256, 256, 128, 0, 768, True, 0, False),
             (256, 256, 32, 512, 512, True, 0, False),
             (256, 256, 64, 256, 0, True, 0, True)]


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", HOP_CASES)
def test_ring_chunk_in_place_equals_out_of_place_on_card(cuda_device, dtype,
                                                         case):
    """K6 in place (the ring's form) against K6 out of place, bit for bit,
    on every hop kind; a chunk wholly in the future leaves m, l and acc
    untouched in place."""
    Sq, Sk, D, q_off, k_off, causal, window, masked = case
    g = torch.Generator(device=cuda_device).manual_seed(Sq + D + q_off)
    q, k, v, mask, m, l, acc = _chunk_inputs(g, cuda_device, dtype, Sq, Sk,
                                             D, masked)
    kw = dict(q_offset=q_off, k_offset=k_off, causal=causal, window=window)
    out = tfa.flash_attention_chunk(q, k, v, mask, m, l, acc, **kw)
    carries = [t.clone() for t in (m, l, acc)]
    before = tfa.chunk_launches
    got = tfa.flash_attention_chunk(q, k, v, mask, *carries, **kw,
                                    in_place=True)
    assert tfa.chunk_launches == before + 1
    torch.cuda.synchronize()
    for name, a, c, b in zip(("m", "l", "acc"), got, carries, out):
        assert a is c, name                       # written where it lies
        assert torch.equal(a, b), name
    if causal and q_off + Sq <= k_off:            # wholly in the future
        for a, b in zip(carries, (m, l, acc)):
            assert torch.equal(a, b)


def _chunk_bwd_case(g, dev, dtype, case):
    """The chunk's operands, a finished lse and a delta for K7a/K7b."""
    Sq, Sk, D, q_off, k_off, causal, window, masked = case
    q, k, v, mask, m, l, acc = _chunk_inputs(g, dev, dtype, Sq, Sk, D, masked)
    kw = dict(q_offset=q_off, k_offset=k_off, causal=causal, window=window)
    want = tfa.flash_attention_chunk_reference(q, k, v, mask, m, l, acc, **kw)
    lse = want[0] + torch.log(want[1].clamp_min(1e-30))
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    delta = torch.randn(lse.shape, generator=g, device=dev)
    return (q, k, v, mask, do, lse, delta), kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_ring_chunk_bwd_adds_into_out_on_card(cuda_device, dtype, case):
    """K7a/K7b with ``out`` (the ring's form) add their partial into the
    given fp32 sums and return them: bit for bit the out-of-place partial
    + add_; a chunk wholly in the future leaves them untouched, fully
    masked rows add exact zeros, and two calls give the same bits."""
    Sq, Sk, D, q_off, k_off, causal, window, masked = case
    g = torch.Generator(device=cuda_device).manual_seed(Sq + 3 * Sk + D)
    args, kw = _chunk_bwd_case(g, cuda_device, dtype, case)
    B, H = args[0].shape[0], args[0].shape[2]
    bufs = [torch.randn(B, H, S, D, generator=g, device=cuda_device)
            for S in (Sq, Sk, Sk)]
    parts = (tfa.flash_attention_chunk_dq(*args, **kw),
             *tfa.flash_attention_chunk_dkv(*args, **kw))
    runs = []
    for _ in range(2):
        sums = [t.clone() for t in bufs]
        counts = (tfa.chunk_dq_launches, tfa.chunk_dkv_launches)
        dq = tfa.flash_attention_chunk_dq(*args, **kw, out=sums[0])
        dk, dv = tfa.flash_attention_chunk_dkv(*args, **kw,
                                               out=(sums[1], sums[2]))
        assert (tfa.chunk_dq_launches, tfa.chunk_dkv_launches) == (
            counts[0] + 1, counts[1] + 1)
        assert dq is sums[0] and dk is sums[1] and dv is sums[2]
        runs.append(sums)
    torch.cuda.synchronize()
    for name, a, b, p, again in zip(("dq", "dk", "dv"), runs[0], bufs, parts,
                                    runs[1]):
        assert torch.equal(a, b + p), name
        assert torch.equal(a, again), name
        if causal and q_off + Sq <= k_off:        # wholly in the future
            assert torch.equal(a, b), name
        if masked:                                # batch 0 sees no key
            assert torch.equal(a[0], b[0]), name


@pytest.mark.cuda
def test_ring_chunk_bwd_refuses_a_wrong_out_on_card(cuda_device):
    """A CUDA ``out`` of another dtype, shape, device or layout raises
    before any launch."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    case = (128, 128, 64, 128, 0, True, 0, False)
    args, kw = _chunk_bwd_case(g, cuda_device, torch.bfloat16, case)
    ok = torch.zeros(2, 4, 128, 64, device=cuda_device)
    bad = [ok.to(torch.bfloat16), ok[:, :, :64], ok.cpu(),
           ok.transpose(2, 3).contiguous().transpose(2, 3)]
    counts = (tfa.chunk_dq_launches, tfa.chunk_dkv_launches)
    for out in bad:
        with pytest.raises(ValueError, match="out"):
            tfa.flash_attention_chunk_dq(*args, **kw, out=out)
        with pytest.raises(ValueError, match="out"):
            tfa.flash_attention_chunk_dkv(*args, **kw, out=(ok, out))
    with pytest.raises(ValueError, match="pair"):
        tfa.flash_attention_chunk_dkv(*args, **kw, out=ok)
    assert (tfa.chunk_dq_launches, tfa.chunk_dkv_launches) == counts


@pytest.mark.cuda
def test_ring_chunk_in_place_refuses_strided_carries(cuda_device):
    q, k, v, mask, m, l, acc = _chunk_inputs(
        torch.Generator(device=cuda_device).manual_seed(1), cuda_device,
        torch.bfloat16, 64, 64, 64, False)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_chunk(q, k, v, mask, m, l,
                                  acc.transpose(2, 3).contiguous()
                                  .transpose(2, 3), q_offset=0, k_offset=0,
                                  causal=True, in_place=True)


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
@pytest.mark.parametrize("backend", ["ring", "ulysses"])
def test_attention_dispatch_on_card_never_takes_the_dense_path(cuda_device,
                                                               backend):
    """Shapes that do not tile a seq=4 x model=2 mesh on one card: local
    heads that seq does not divide (H=4, two a model column) send ulysses
    to the ring's chunk kernels, and a sequence that seq does not divide
    (1022) runs K1 over the whole of it; both agree with the dense path
    (bf16, as above)."""
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    g = torch.Generator(device=cuda_device).manual_seed(11)
    mesh = create_mesh(data=1, seq=4, model=2, devices=[cuda_device] * 8)
    for S, want_chunk in ((1024, True), (1022, False)):
        q, k, v = (torch.randn(2, S, 4, 128, generator=g, device=cuda_device
                               ).to(torch.bfloat16) for _ in range(3))
        counts = (tfa.chunk_launches, tfa.launches)
        out = tattn.dot_product_attention(q, k, v, causal=True,
                                          backend=backend, mesh=mesh)
        chunk, flash = (tfa.chunk_launches - counts[0],
                        tfa.launches - counts[1])
        assert (chunk > 0, flash > 0) == (want_chunk, not want_chunk), (
            S, chunk, flash)
        ref = tattn.dot_product_attention(q, k, v, causal=True)
        torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                                   rtol=0)


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
    before = (qmm.dgelu_launches, qmm.quantize_launches,
              qmm.transpose_launches, qmm.gemm_launches)
    got = qmm.quantized_matmul_dgelu(da, pre, qwt, swt, **kw)
    # One call: kernel A, the weight's transpose, kernel B.
    assert (qmm.dgelu_launches, qmm.quantize_launches,
            qmm.transpose_launches, qmm.gemm_launches) == tuple(
                n + 1 for n in before)
    want = qmm.quantized_matmul_dgelu_reference(da, pre, qwt, swt, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        peak = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        assert err <= K45_TOL[dtype](peak), (err, peak)


@pytest.mark.cuda
def test_trainer_cli_runs_gpt_mini_through_the_kernels_on_card(
        cuda_device, tmp_path, monkeypatch):
    """``train.py --model=gpt_mini --attention_backend=pallas
    --fused_layer_norm`` on the card, in this process (no coordination
    service, no process group): two train steps and the final test eval
    (4 batches) launch K1/K2a/K2b once a layer a step, K1 once a layer an
    eval forward, K3 twice a layer and once at the end a forward; then
    ``--mode=eval`` restores the checkpoint to the same test accuracy."""
    from distributed_tensorflow_tpu_torch import train as ttrain
    from distributed_tensorflow_tpu_torch.cluster.server import Server
    from distributed_tensorflow_tpu_torch.models import gpt

    orig = Server.__init__

    def standalone(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", standalone)
    flags = ["--job_name=worker", "--task_index=0", "--model=gpt_mini",
             "--attention_backend=pallas", "--fused_layer_norm",
             "--bert_seq_len=128", "--batch_size=4", "--train_steps=3",
             "--validation_every=0", "--sync_replicas=true",
             f"--logdir={tmp_path}", "--device=cuda"]
    before = {"fwd": tfa.launches, "dq": tfa.dq_launches,
              "dkv": tfa.dkv_launches, "ln": ln.launches}
    result = ttrain.app.run(ttrain.main, flags)
    L = gpt.mini().num_layers
    steps, forwards = 2, 2 + 4
    assert result.final_global_step == 3
    assert tfa.launches - before["fwd"] == L * forwards
    assert tfa.dq_launches - before["dq"] == L * steps
    assert tfa.dkv_launches - before["dkv"] == L * steps
    assert ln.launches - before["ln"] == (2 * L + 1) * forwards
    evaluated = ttrain.app.run(ttrain.main, ["--mode=eval", *flags])
    assert evaluated["global_step"] == 3
    assert evaluated["test_accuracy"] == result.test_accuracy


@pytest.mark.cuda
def test_serve_cli_prints_its_kernel_launches_on_exit_on_card(
        cuda_device, tmp_path):
    """The serving CLI as a process on the card (the fleet's replica):
    two greedy requests, then SIGTERM; its clean exit prints ``kernel
    launches {json}`` with K1 once a layer a prefill, K3 twice a layer
    and once more a prefill or engine step, and no other kernel."""
    import json
    import os
    import signal
    import subprocess
    import sys

    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.serving.client import ServeClient
    from distributed_tensorflow_tpu_torch.tools import checkpoint_io

    cfg = gpt.GptConfig(vocab_size=256, hidden_size=256, num_layers=2,
                        num_heads=2, intermediate_size=512,
                        max_position=128, dtype="bfloat16",
                        attention_backend="pallas", fused_ln=True)
    model = gpt.GptLM(cfg, device=cuda_device, seed=4)
    checkpoint_io.save_raw(
        str(tmp_path / "run" / "checkpoints"), 1,
        {"params": gpt.params_to_jax(model.state_dict()),
         "global_step": torch.tensor(1, dtype=torch.int32)})
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_tensorflow_tpu_torch.tools.serve",
         "--logdir", str(tmp_path / "run"), "--port", "0", "--device",
         "cuda", "--slots", "2", "--page_size", "16", "--num_pages", "32",
         "--max_pages_per_seq", "8"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("serving ") and " on :" in line:
                break
        port = int(seen[-1].split(" on :")[1].split(" ")[0])
        client = ServeClient(f"http://127.0.0.1:{port}", timeout_s=120.0)
        for prompt in ([3, 4, 5], list(range(40))):
            assert client.generate(prompt, 6)["tokens_out"] == 6
        steps = client.stats()["engine"]["engine_step"]
        assert steps == 12              # one engine step a new token
    finally:
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0, "".join(seen) + rest
    (line,) = [x for x in rest.splitlines()
               if x.startswith("kernel launches ")]
    counts = json.loads(line[len("kernel launches "):])
    L = cfg.num_layers
    assert counts.pop("flash_attention_fwd") == L * 2
    assert counts.pop("layer_norm_fwd") == (2 * L + 1) * (2 + steps)
    assert not any(counts.values()), counts


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,pipe,virtual", [("gpipe", 2, 1),
                                                   ("1f1b", 2, 1),
                                                   ("interleaved", 2, 2)])
def test_pipelined_step_on_card_matches_the_pallas_step(cuda_device,
                                                        schedule, pipe,
                                                        virtual):
    """One step of a small GPT as pipeline stages on the one card
    (``models/registry.build_gpt_pipeline``, 4 micro-batches) against the
    unpipelined pallas step from the same seed: the loss and gradients
    within chip_smoke.py's TRAIN_* tolerances, and the kernels launched
    as the schedule counts (each micro-batch through each layer; 1F1B
    and interleaved recompute each chunk's forward but the last's)."""
    from distributed_tensorflow_tpu_torch.models import gpt
    from distributed_tensorflow_tpu_torch.models.registry import (
        build_gpt_pipeline)
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    from distributed_tensorflow_tpu_torch.training.optimizers import (
        make_optimizer)

    width = dict(hidden_size=512, num_layers=4, num_heads=8,
                 intermediate_size=1024, max_position=256)
    cfg = gpt.GptConfig(**width, attention_backend="pallas", fused_ln=True)
    mesh = create_mesh(data=1, pipe=pipe, devices=[cuda_device] * pipe)
    M = 4
    b = build_gpt_pipeline(0.0, mesh, seq_len=256, n_micro=M,
                           attention_backend="pallas", fused_ln=True,
                           tx=make_optimizer("sgd", 0.0), schedule=schedule,
                           virtual_stages=virtual, width=width)
    state = b.place_state(mesh, b.state)
    step = (b.train_step_builder(mesh) if b.train_step_builder
            else build_sync_train_step(b.loss_fn))
    batch = gpt.synthetic_lm_batch(0, 8, 256, cfg)
    before = [tfa.launches, tfa.dq_launches, tfa.dkv_launches, ln.launches]
    state, m = step(state, batch)
    got = [a - b_ for a, b_ in zip([tfa.launches, tfa.dq_launches,
                                    tfa.dkv_launches, ln.launches], before)]
    L = cfg.num_layers
    if schedule == "gpipe":
        fwd, head = L * M, 1
    else:
        fwd, head = M * (2 * L - L // (pipe * virtual)), M
    assert got == [fwd, L * M, L * M, 2 * fwd + head]
    model = state.model
    per = L // len(model.stages)
    grads = {}
    for n, p in model.named_parameters():
        part, _, rest = n.partition(".")
        if part == "stages":
            c, _, l, leaf = rest.split(".", 3)
            rest = f"layers.{int(c) * per + int(l)}.{leaf}"
        grads[rest] = p.grad
    plain = gpt.GptLM(cfg, device=cuda_device, param_dtype=torch.float32)
    tokens = torch.as_tensor(batch["tokens"], device=cuda_device).long()
    loss, _ = gpt.lm_loss(plain(tokens), tokens)
    loss.backward()
    ga = torch.cat([grads[n].flatten() for n, _ in plain.named_parameters()])
    gb = torch.cat([p.grad.flatten() for p in plain.parameters()])
    assert abs(float(m["loss"]) - loss.item()) <= 1e-3
    assert abs(ga.norm() - gb.norm()) / gb.norm() <= 2e-3
    assert torch.nn.functional.cosine_similarity(ga, gb, dim=0) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("H,I,rows", [(128, 512, 4096), (2048, 8192, 1024)])
def test_tp_int8_mlp_per_shard_matches_the_unsharded_mlp_on_card(
        cuda_device, H, I, rows):
    """``int8_gelu_mlp_tp`` over two shards (K4/K5 a shard, fp32
    partials, the whole K's scales; at gpt_mini's width the 512-wide
    K-blocks span both shards: kernel A with given scales) against
    ``int8_gelu_mlp`` on the same bf16 inputs: the output and every
    gradient within the int8 step's tolerance (a flipped code moves a
    value by ~1/127 of its row's range: 2e-2 of the peak), and the
    launches K4 2 + 2, K5 2 + 2 a call pair."""
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    from distributed_tensorflow_tpu_torch.ops import quant_train as qt
    g = torch.Generator(device=cuda_device).manual_seed(H)
    bf = torch.bfloat16

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=cuda_device) * scale
    x = rand(rows, H).to(bf).requires_grad_()
    w_in = rand(H, I, scale=H ** -0.5).requires_grad_()
    b_in = rand(I, scale=0.1).requires_grad_()
    w_out = rand(I, H, scale=I ** -0.5).requires_grad_()
    b_out = rand(H, scale=0.1).requires_grad_()
    gy = rand(rows, H).to(bf)
    y = qt.int8_gelu_mlp(x, w_in, b_in, w_out, b_out)
    want = torch.autograd.grad(y, (x, w_in, b_in, w_out, b_out), gy)
    wi = [t.detach().clone().requires_grad_() for t in w_in.chunk(2, 1)]
    bi = [t.detach().clone().requires_grad_() for t in b_in.chunk(2)]
    wo = [t.detach().clone().requires_grad_() for t in w_out.chunk(2, 0)]
    xs = x.detach().clone().requires_grad_()
    bo = b_out.detach().clone().requires_grad_()
    before = (qmm.launches, qmm.nt_launches)
    y_tp = qt.int8_gelu_mlp_tp(xs, wi, bi, wo, bo)
    got = torch.autograd.grad(y_tp, (xs, *wi, *bi, *wo, bo), gy)
    assert (qmm.launches - before[0], qmm.nt_launches - before[1]) == (4, 4)

    def close(a, b):
        err = (a.float() - b.float()).abs().max().item()
        assert err <= 2e-2 * b.float().abs().max().item(), err
    close(y_tp, y)
    close(got[0], want[0])
    close(torch.cat(got[1:3], 1), want[1])
    close(torch.cat(got[3:5]), want[2])
    close(torch.cat(got[5:7]), want[3])
    close(got[7], want[4])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prologue", [None, "dgelu_fold"])
def test_quantize_blocks_with_given_scales_matches_plain_on_card(
        cuda_device, dtype, prologue):
    """Kernel A with given scales (a K-block split over tensor-parallel
    shards) bit for bit against its plain version, codes, scales and g."""
    from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
    g = torch.Generator(device=cuda_device).manual_seed(1)
    M, K, bk = 300, 512, 256
    a = torch.randn(M, K, generator=g, device=cuda_device).to(dtype)
    sx = torch.rand(K // bk, M, generator=g, device=cuda_device) * 0.05 \
        + 1e-3
    kw = {}
    if prologue:
        kw = dict(pre=torch.randn(M, K, generator=g,
                                  device=cuda_device).to(dtype),
                  sf=torch.rand(K, generator=g, device=cuda_device) + 0.5,
                  want_g=True)
    got = qmm.quantize_blocks(a, bk, sx=sx, **kw)
    want = qmm.quantize_blocks_reference(a, bk, sx=sx, **kw)
    for x, y in zip(got, want):
        if y is not None:
            assert torch.equal(x, y)


# The config ladder's attention (slice 7b): BERT-tiny's 2 heads of 64 at
# S=128, non-causal, under a ragged key-padding mask (the first row half
# padded), and ViT-tiny's 4 heads of 32 over 64 patches (shorter than
# one 128-row tile), no mask; B=100, the CLI's default batch.
@pytest.mark.cuda
@pytest.mark.parametrize("model", ["bert", "vit"])
def test_flash_kernels_at_the_ladders_shapes_on_card(cuda_device, model):
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B = 100
    S, H, D = (128, 2, 64) if model == "bert" else (64, 4, 32)
    q, k, v = _fused_qkv(g, cuda_device, B, S, H, D)
    mask = None
    if model == "bert":
        lengths = torch.randint(S // 4, S + 1, (B,), generator=g,
                                device=cuda_device)
        lengths[0] = S // 2
        mask = (torch.arange(S, device=cuda_device)[None, :]
                < lengths[:, None]).to(torch.int32)
    counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    out, lse = _check_forward(q, k, v, mask, False, 0)
    dout = torch.randn(B, S, H, D, generator=g, device=cuda_device
                       ).to(torch.bfloat16)
    _check_backward(q, k, v, mask, out, lse, dout, False, 0)
    assert (tfa.launches - counts[0], tfa.dq_launches - counts[1],
            tfa.dkv_launches - counts[2]) == (1, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["bert_tiny", "vit_tiny"])
def test_ladder_train_step_on_card_launches_every_kernel(cuda_device,
                                                         model):
    """registry.build_bert_tiny / build_vit_tiny on the kernels: one sync
    step launches K1, K2a and K2b once a layer and K3 at each LayerNorm
    of the forward (BERT: ln_emb, two a layer, mlm_ln; ViT: two a layer,
    ln_final); the step's loss and gradients within chip_smoke's TRAIN_*
    of the plain versions' step."""
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_sync_train_step)
    kw = dict(attention_backend="pallas", fused_ln=True, device=cuda_device)
    if model == "bert_tiny":
        bundle = registry.build_bert_tiny(1e-3, seq_len=128, **kw)
    else:
        bundle = registry.build_vit_tiny(1e-3, **kw)
    m = bundle.state.model
    plain = type(m)(dataclasses.replace(m.cfg, attention_backend="xla",
                                        fused_ln=False), device=cuda_device)
    plain.load_state_dict(m.state_dict())
    batch = bundle.load_datasets("/nonexistent").train.next_batch(16)

    def loss_and_grads(model):
        model.zero_grad(set_to_none=True)
        loss, _ = bundle.loss_fn(model, batch)
        loss.backward()
        return float(loss), torch.cat([p.grad.float().flatten() for _, p in
                                       sorted(model.named_parameters())])
    (la, ga), (lb, gb) = loss_and_grads(m), loss_and_grads(plain)
    assert abs(la - lb) <= 1e-3
    assert float((ga.norm() - gb.norm()).abs() / gb.norm()) <= 2e-3
    assert float(torch.nn.functional.cosine_similarity(ga, gb, dim=0)) \
        >= 0.999
    L = m.cfg.num_layers
    counts = (tfa.launches, tfa.dq_launches, tfa.dkv_launches, ln.launches)
    state, metrics = build_sync_train_step(bundle.loss_fn)(bundle.state,
                                                           batch)
    assert torch.isfinite(metrics["loss"])
    assert (tfa.launches - counts[0], tfa.dq_launches - counts[1],
            tfa.dkv_launches - counts[2], ln.launches - counts[3]) == (
                L, L, L, 2 * L + (2 if model == "bert_tiny" else 1))


@pytest.mark.cuda
def test_resnet_sync_batch_norm_on_card(cuda_device, monkeypatch):
    """ResNet-20's stateful step on the card: the running statistics
    move, and the step's loss is the CPU step's from the same weights
    (cuDNN's convolutions without TF32 for this test only)."""
    from distributed_tensorflow_tpu_torch.models import registry
    from distributed_tensorflow_tpu_torch.parallel.sync import (
        build_stateful_sync_train_step)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    card = registry.build_resnet20(0.1, device=cuda_device)
    host = registry.build_resnet20(0.1, device="cpu")
    host.state.model.load_state_dict({k: v.cpu() for k, v in
                                      card.state.model.state_dict().items()})
    batch = card.load_datasets("/nonexistent").train.next_batch(32)
    before = {k: v.clone() for k, v in card.state.model_state.items()}
    s, m = build_stateful_sync_train_step(card.stateful_loss_fn)(card.state,
                                                                 batch)
    _, mh = build_stateful_sync_train_step(host.stateful_loss_fn)(
        host.state, batch)
    assert abs(float(m["loss"]) - float(mh["loss"])) <= 1e-4
    assert any(not torch.equal(s.model_state[k], v)
               for k, v in before.items())
    for k, v in s.model_state.items():
        assert v.is_cuda
        torch.testing.assert_close(v.cpu(), host.state.model_state[k],
                                   atol=1e-4, rtol=1e-4)
