"""The port's ring-attention train step (build_gpt_mini(attention_backend=
"ring") on a data=2, seq=4 mesh of the CPU, TrainState, the sync step)
against the JAX package's sync step under attention_mesh(create_mesh(
data=2, seq=4)) on the 8 fake CPU devices: three steps from the same
weights.  Port-only: the ring step equals the pallas step (both exact
attention; one process sums every shard's contribution to the replicated
weights, so the step needs no all-reduce of its own), and remat gives the
same gradients with the mesh captured at the first call.  The JAX
side's Pallas kernels run in interpret mode; the port's on the CPU are
the plain versions."""

import dataclasses
import functools

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.models import registry as jreg
from distributed_tensorflow_tpu.ops import attention as jattn
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu_torch.models import gpt as tgpt
from distributed_tensorflow_tpu_torch.models import registry as treg
from distributed_tensorflow_tpu_torch.ops import attention as tattn
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt

SEQ = 32                      # 8 positions per seq shard
CPU8 = [torch.device("cpu")] * 8

# test_torch_gpt_training.py's tolerances for three steps against the JAX
# step (SGD at lr 0.5, so the parameters show the gradients' agreement):
# fp32 sums differ in order only; bf16 activations round at other places
# in the two frameworks.
TRAIN_CASES = {
    "float32": dict(loss_tol=1e-6, param_atol=1e-6, min_cos=0.99999),
    "bfloat16": dict(loss_tol=3e-3, param_atol=3e-3, min_cos=0.999),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(state_dict):
    return torch.cat([v.detach().float().flatten()
                      for _, v in sorted(state_dict.items())])


@functools.lru_cache(maxsize=None)
def _jax_bundle():
    """The JAX f32 ring bundle, built once (its eager init runs Pallas in
    interpret mode) under the mesh, as the CLI builds it."""
    with jattn.attention_mesh(jmesh.create_mesh(data=2, seq=4)):
        return jreg.build_gpt_mini(1e-3, seq_len=SEQ, dtype="float32",
                                   attention_backend="ring", fused_ln=True,
                                   tx=optax.sgd(0.5))


def _jax_bf16_loss_fn():
    model = jgpt.GptLM(dataclasses.replace(
        jgpt.mini(), dtype="bfloat16", attention_backend="ring",
        fused_ln=True))

    def loss_fn(params, batch):
        logits = model.apply({"params": params}, batch["tokens"])
        loss, acc = jgpt.lm_loss(logits, batch["tokens"])
        return loss, {"accuracy": acc}
    return loss_fn


def _port_bundle(dtype, backend="ring", **kw):
    mesh = tmesh.create_mesh(data=2, seq=4, devices=CPU8)
    return treg.build_gpt_mini(
        1e-3, tx=topt.make_optimizer("sgd", 0.5), seq_len=SEQ, dtype=dtype,
        attention_backend=backend, fused_ln=True, device="cpu",
        mesh=mesh if backend == "ring" else None, **kw)


@pytest.mark.parametrize("dtype", sorted(TRAIN_CASES))
def test_three_ring_train_steps_match_jax_sync_step(dtype):
    tol = TRAIN_CASES[dtype]
    jb = _jax_bundle()
    jloss = jb.loss_fn if dtype == "float32" else _jax_bf16_loss_fn()
    js = jb.state
    tb = _port_bundle(dtype)
    model = tb.state.model
    model.load_state_dict(tgpt.params_from_jax(jax.device_get(
        jb.state.params)))
    jstep = jsync.build_sync_train_step(None, jloss, donate=False,
                                        log_grad_norm=True)
    tstep = tsync.build_sync_train_step(tb.loss_fn, log_grad_norm=True)
    ts = tb.state
    jdata, tdata = jb.load_datasets(None).train, tb.load_datasets(None).train
    before = _flat(model.state_dict())
    for i in range(3):
        jbatch, tbatch = jdata.next_batch(8), tdata.next_batch(8)
        np.testing.assert_array_equal(jbatch["tokens"], tbatch["tokens"])
        with jattn.attention_mesh(jmesh.create_mesh(data=2, seq=4)):
            js, jm = jstep(js, jbatch)
        ts, tm = tstep(ts, tbatch)
        assert tm["global_step"] == int(jm["global_step"]) == i + 2
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=tol["loss_tol"])
        # One of the 8 x 31 argmax predictions may flip between two nearly
        # equal logits.
        np.testing.assert_allclose(float(tm["accuracy"]),
                                   float(jm["accuracy"]),
                                   atol=1.01 / (8 * (SEQ - 1)))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-2)
        want = tgpt.params_from_jax(jax.device_get(js.params))
        got = model.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].float().numpy(), w.numpy(),
                                       atol=tol["param_atol"], rtol=0,
                                       err_msg=f"step {i}: {name}")
        after = _flat(got)
        cos = torch.nn.functional.cosine_similarity(
            after - before, _flat(want) - before, dim=0)
        assert cos >= tol["min_cos"], (i, float(cos))


def _loss_and_grads(model, tokens):
    model.zero_grad(set_to_none=True)
    loss, _ = tgpt.lm_loss(model(tokens), tokens)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def test_ring_step_equals_pallas_step():
    """Ring attention is exact: from the same weights and batch, the ring
    model's loss and gradients are the pallas model's (fp32; the order of
    fp32 sums only).  The replicated weights' gradients are the sums of
    all eight shards' contributions, which one process's autograd forms
    (the step needs no all-reduce of its own)."""
    ring, pallas = _port_bundle("float32"), _port_bundle("float32",
                                                         "pallas")
    pallas.state.model.load_state_dict(ring.state.model.state_dict())
    tokens = torch.from_numpy(
        ring.load_datasets(None).train.next_batch(8)["tokens"]).long()
    (l_ring, g_ring), (l_pallas, g_pallas) = (
        _loss_and_grads(b.state.model, tokens) for b in (ring, pallas))
    torch.testing.assert_close(l_ring, l_pallas, atol=1e-6, rtol=1e-6)
    for name in g_ring:
        torch.testing.assert_close(g_ring[name], g_pallas[name], atol=1e-6,
                                   rtol=1e-5, msg=name)


def test_ring_remat_gives_the_same_gradients_with_the_mesh_captured():
    """remat=True recomputes each block in the backward, outside any
    attention_mesh: the blocks captured the mesh at their first call."""
    cfg = tgpt.GptConfig(vocab_size=32, hidden_size=32, num_layers=2,
                         num_heads=2, intermediate_size=64, max_position=32,
                         dtype="float32", attention_backend="ring",
                         fused_ln=True)
    mesh = tmesh.create_mesh(data=2, seq=4, devices=CPU8)
    tokens = torch.from_numpy(tgpt.synthetic_lm_batch(
        1, 4, 16, cfg)["tokens"]).long()
    grads = []
    for remat in (False, True):
        model = tgpt.GptLM(dataclasses.replace(cfg, remat=remat),
                           device="cpu", seed=0, param_dtype=torch.float32)
        assert model.layers[0].mesh is None
        with tattn.attention_mesh(mesh):
            loss, _ = tgpt.lm_loss(model(tokens), tokens)
        assert all(layer.mesh is mesh for layer in model.layers)
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   atol=1e-6, rtol=1e-5, msg=name)
