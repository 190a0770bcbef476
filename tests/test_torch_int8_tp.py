"""Int8 matmuls beside the port's tensor parallelism
(distributed_tensorflow_tpu_torch/ops/quant_train.int8_gelu_mlp_tp,
int8_matmul_column / int8_matmul_row, ops/quant_matmul.split_k_codes,
models/gpt.Dense.column/row with int8, train.py --tensor_parallel with
--gpt_matmul_int8).

In the JAX package GSPMD partitions the unsharded int8 program, so the
port's shards must compute its global function: they are held to the
port's own unsharded int8 functions, which tests/test_torch_quant_train.py
holds to JAX.  Tolerances, on the CPU (the kernels' plain versions):

- the per-row int8 matmuls (``Int8Dense``, the ``attn_int8``
  projections) sum the shards' int32 products exactly before their one
  rescale: bit-equal outputs and input gradients, weight gradients within
  1e-6 (fp32 products of the same operands, blocked per shard);
- the fused MLP (K4/K5 per shard) sums fp32 partials: within 1e-5 of the
  unsharded MLP in fp32, on the gpt_mini width whose mlp_out K-block of
  512 spans both shards of 256 (its scale the max over the two parts,
  ``split_k_codes``) and on a width whose blocks align;
- a whole tp2 int8 train step, against the unsharded int8 step from the
  same weights: the loss within 1e-3 and the gradients' cosine above
  0.9999 (a re-associated fp32 sum, the row-parallel attention output's
  among them, can flip an int8 code downstream)."""

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm
from distributed_tensorflow_tpu_torch.ops import quant_train as qt
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.training import optimizers as topt
from distributed_tensorflow_tpu_torch.training.state import TrainState

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(*shape, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g) * scale


@pytest.mark.parametrize("K,n,block_k", [(512, 2, 1024), (768, 2, 1024),
                                         (8192, 2, 1024), (512, 4, 512)])
def test_split_k_codes_are_the_whole_ks(K, n, block_k):
    """Each shard's codes and scales are the unsharded pass's restricted
    to its columns, a K-block spanning shards included (K=512 at tp2,
    768's blocks of 256 over shards of 384, 8192's aligned blocks)."""
    M = 8
    a = _rand(M, K, seed=K)
    a[3, 5] = 40.0                 # a row whose block max sits in shard 0
    bk = qmm._block_k(K, block_k)
    q, sx, _ = qmm.quantize_blocks(a, bk)
    codes, sub = qmm.split_k_codes(list(a.chunk(n, dim=1)), block_k)
    torch.testing.assert_close(torch.cat([c[0] for c in codes], dim=1), q,
                               rtol=0, atol=0)
    whole = sx.repeat_interleave(bk // sub, dim=0)
    torch.testing.assert_close(torch.cat([c[1] for c in codes]), whole,
                               rtol=0, atol=0)


def test_given_scales_reproduce_the_fold_and_gelu_prologue():
    """Kernel A's plain version with given scales (K5's prologue: gelu'
    and the fold, with g) gives the whole pass's codes and g."""
    M, K = 4, 512
    da, pre, sf = _rand(M, K, seed=1), _rand(M, K, seed=2), _rand(K, seed=3)
    q, sx, g = qmm.quantize_blocks(da, 512, pre, sf, want_g=True)
    parts, _ = qmm.split_k_codes(list(da.chunk(2, dim=1)), 512,
                                 list(pre.chunk(2, dim=1)),
                                 list(sf.chunk(2)), want_g=True)
    torch.testing.assert_close(torch.cat([p[0] for p in parts], 1), q,
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([p[2] for p in parts], 1), g,
                               rtol=0, atol=0)


@pytest.mark.parametrize("H,I,n", [(128, 512, 2), (128, 2048, 2)])
def test_fused_mlp_per_shard_is_the_unsharded_mlp(H, I, n):
    """int8_gelu_mlp_tp over n shards against int8_gelu_mlp: forward and
    every gradient within 1e-5 (fp32).  (128, 512): gpt_mini's width,
    mlp_out's K-block of 512 and mlp_in's dgrad K-block of 512 span both
    shards; (128, 2048): aligned blocks."""
    M = 256
    assert qt.use_fused_mlp(M, H, I)
    x = _rand(M, H, seed=4).requires_grad_()
    w_in = (_rand(H, I, seed=5) / H ** 0.5).requires_grad_()
    b_in = (_rand(I, seed=6) * 0.1).requires_grad_()
    w_out = (_rand(I, H, seed=7) / I ** 0.5).requires_grad_()
    b_out = (_rand(H, seed=8) * 0.1).requires_grad_()
    gy = _rand(M, H, seed=9)
    y = qt.int8_gelu_mlp(x, w_in, b_in, w_out, b_out)
    want = torch.autograd.grad(y, (x, w_in, b_in, w_out, b_out), gy)

    wi = [t.detach().clone().requires_grad_() for t in w_in.chunk(n, 1)]
    bi = [t.detach().clone().requires_grad_() for t in b_in.chunk(n)]
    wo = [t.detach().clone().requires_grad_() for t in w_out.chunk(n, 0)]
    xs = x.detach().clone().requires_grad_()
    bo = b_out.detach().clone().requires_grad_()
    y_tp = qt.int8_gelu_mlp_tp(xs, wi, bi, wo, bo)
    got = torch.autograd.grad(y_tp, (xs, *wi, *bi, *wo, bo), gy)
    tol = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y_tp, y, **tol)
    torch.testing.assert_close(got[0], want[0], **tol)
    torch.testing.assert_close(torch.cat(got[1:1 + n], 1), want[1], **tol)
    torch.testing.assert_close(torch.cat(got[1 + n:1 + 2 * n]), want[2],
                               **tol)
    torch.testing.assert_close(torch.cat(got[1 + 2 * n:1 + 3 * n]),
                               want[3], **tol)
    torch.testing.assert_close(got[-1], want[4], **tol)


@pytest.mark.parametrize("kind", ["column", "row"])
def test_per_row_int8_matmuls_per_shard_are_bit_equal(kind):
    """int8_matmul_column / _row against int8_matmul: outputs and input
    gradients bit-equal (exact int32 sums), weight gradients 1e-6."""
    M, K, N = 16, 64, 96
    x = _rand(M, K, seed=10).requires_grad_()
    w = (_rand(K, N, seed=11) / 8).requires_grad_()
    gy = _rand(M, N, seed=12)
    y = qt.int8_matmul(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), gy)
    xs = x.detach().clone().requires_grad_()
    if kind == "column":
        ws = [t.detach().clone().requires_grad_() for t in w.chunk(2, 1)]
        ys = qt.int8_matmul_column(xs, ws)
        got = torch.autograd.grad(ys, (xs, *ws), list(gy.chunk(2, 1)))
        torch.testing.assert_close(torch.cat(ys, 1), y, rtol=0, atol=0)
        torch.testing.assert_close(torch.cat(got[1:], 1), dw, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(got[0], dx, rtol=0, atol=0)
    else:
        parts = [t.detach().clone().requires_grad_()
                 for t in x.chunk(2, 1)]
        ws = [t.detach().clone().requires_grad_() for t in w.chunk(2, 0)]
        y_tp = qt.int8_matmul_row(parts, ws)
        got = torch.autograd.grad(y_tp, (*parts, *ws), gy)
        torch.testing.assert_close(y_tp, y, rtol=0, atol=0)
        torch.testing.assert_close(torch.cat(got[:2], 1), dx, rtol=0,
                                   atol=0)
        torch.testing.assert_close(torch.cat(got[2:], 0), dw, rtol=1e-6,
                                   atol=1e-6)


SMALL = dict(vocab_size=64, hidden_size=128, num_layers=2, num_heads=4,
             intermediate_size=512, max_position=64, dtype="float32",
             attention_backend="pallas", fused_ln=True)


def _state(**kw):
    cfg = tgpt.GptConfig(**{**SMALL, **kw})
    model = tgpt.GptLM(cfg, device="cpu", seed=1, param_dtype=torch.float32)
    return TrainState.create(model, topt.make_optimizer("adam", 1e-3),
                             params_to_tree=tgpt.params_to_jax,
                             params_from_tree=tgpt.params_from_jax)


def _grads(model, tokens):
    model.zero_grad(set_to_none=True)
    t = torch.as_tensor(tokens).long()
    loss, _ = tgpt.lm_loss(model(t), t)
    loss.backward()
    g = tsh.gather_named(model, {n: p.grad for n, p in
                                 model.named_parameters()})
    return loss.item(), torch.cat([v.flatten() for _, v in sorted(g.items())])


@pytest.mark.parametrize("arch", [dict(matmul_int8=True),
                                  dict(matmul_int8=True, attn_int8=True),
                                  dict(matmul_int8=True,
                                       activation="swiglu")])
def test_tp2_int8_step_matches_the_unsharded_int8_step(arch):
    """The tp2 int8 model (Megatron split, K4/K5 per shard where the
    fused gate admits the global shapes: B=4 x S=64 = 256 rows) against
    the unsharded int8 model from the same weights: loss 1e-3, gradient
    cosine 0.9999 and norms 1e-3 relative."""
    tokens = tgpt.synthetic_lm_batch(0, 4, 64, tgpt.GptConfig(**SMALL))[
        "tokens"]
    plain = _state(**arch)
    tp = _state(**arch)
    mesh = tmesh.create_mesh(data=1, model=2, devices=[CPU] * 2)
    tsh.shard_state(mesh, tp, tgpt.gpt_sharding_rules())
    la, ga = _grads(plain.model, tokens)
    lb, gb = _grads(tp.model, tokens)
    assert abs(la - lb) <= 1e-3
    cos = torch.nn.functional.cosine_similarity(ga, gb, dim=0).item()
    assert cos >= 0.9999, cos
    assert abs(ga.norm() - gb.norm()) / ga.norm() <= 1e-3


@pytest.fixture
def standalone(monkeypatch):
    from distributed_tensorflow_tpu_torch.cluster.server import Server
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def test_cli_trains_tp2_with_int8_matmuls(tmp_path, standalone, capsys):
    result = ttrain.app.run(ttrain.main, [
        "--job_name=worker", "--task_index=0", "--worker_hosts=localhost:0",
        "--ps_hosts=", "--device=cpu", "--model=gpt_mini",
        "--fused_layer_norm", "--attention_backend=pallas",
        "--bert_seq_len=32", "--batch_size=8", "--train_steps=6",
        "--log_every=2", "--validation_every=0", "--sync_replicas=true",
        "--tensor_parallel=2", "--gpt_matmul_int8", "--log_sharding",
        f"--logdir={tmp_path}/run"])
    assert result.final_global_step == 6
    assert np.isfinite(result.last_loss)
    out = capsys.readouterr().out
    assert ("param layer0/mlp_out/kernel (512, 128) -> PartitionSpec("
            "'model', None)") in out
