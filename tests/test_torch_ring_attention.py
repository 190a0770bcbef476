"""Ring attention of the port (distributed_tensorflow_tpu_torch/parallel/
ring.py, parallel/mesh.py, the ring branch of ops/attention.py) against
the JAX package's: the port's ring on create_mesh(data=2, seq=4,
devices=[cpu] * 8) (one process drives all eight shards) against JAX's
shard_map ring on the 8 fake CPU devices of tests/conftest.py, forward
and q/k/v gradients, for causal attention, a padding mask, a sliding
window (the truncated, reversed ring) and fully masked rows.  Port-only:
the flash and einsum paths agree, the mesh's rules and errors, and the
attention entry point's dispatch.  On the CPU the flash path runs the
chunk functions' plain versions; the JAX side runs its Pallas chunk
kernels in interpret mode.

Tolerance: fp32 on both sides, the same schedule and online-softmax
steps; only the order of fp32 sums differs: outputs to 1e-5, gradients
(sums over every hop) to 1e-4, absolute and relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel import ring as jring
from distributed_tensorflow_tpu_torch.ops import attention as tattn
from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import ring as tring

B, S, H, D = 4, 64, 2, 32          # local shards [2, 16, 2, 32]
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CPU8 = [torch.device("cpu")] * 8

# name -> (causal, window, mask kind)
CASES = {
    "causal": (True, 0, None),
    "padding_mask": (False, 0, "padding"),
    "window": (True, 20, "padding"),       # 3 of 4 hops, reversed
    "fully_masked_rows": (False, 0, "batch0"),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs in parallel workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int, mask_kind):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if mask_kind == "padding":
        mask = rng.random((B, S)) > 0.3
        mask[:, 0] = True
    elif mask_kind == "batch0":
        mask = np.ones((B, S), bool)
        mask[0] = False
    return q, k, v, do, mask


def _jax_ring(q, k, v, do, mask, causal, window):
    ring = jring.make_ring_attention(jmesh.create_mesh(data=2, seq=4),
                                     causal=causal, window=window,
                                     use_flash=True)
    jmask = None if mask is None else jnp.asarray(mask)
    out, vjp = jax.vjp(lambda q, k, v: ring(q, k, v, jmask),
                       *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]


def _port_ring(q, k, v, do, mask, causal, window, use_flash=None):
    ring = tring.make_ring_attention(
        tmesh.create_mesh(data=2, seq=4, devices=CPU8), causal=causal,
        window=window, use_flash=use_flash)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    out = ring(tq, tk, tv, tmask)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    return [x.detach().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_matches_jax_ring_forward_and_gradients(case):
    causal, window, mask_kind = CASES[case]
    args = _inputs(sorted(CASES).index(case), mask_kind)
    counts = (tfa.chunk_launches, tfa.launches)
    got = _port_ring(*args, causal, window)
    assert (tfa.chunk_launches, tfa.launches) == counts   # CPU: no kernel
    want = _jax_ring(*args, causal, window)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == (B, S, H, D) and np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, err_msg=name,
                                   **(OUT_TOL if name == "out"
                                      else GRAD_TOL))
    if case == "fully_masked_rows":
        assert not got[0][0].any()                 # zeros, not NaN
        assert not got[1][0].any() and not got[2][0].any()


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 20),
                                           (False, 0)])
def test_ring_flash_and_einsum_paths_agree(causal, window):
    """The chunk-function ring with its hand-rolled backward and the
    einsum ring differentiated by autograd compute the same attention."""
    args = _inputs(11, "padding")
    flash = _port_ring(*args, causal, window, use_flash=True)
    einsum = _port_ring(*args, causal, window, use_flash=False)
    for name, a, b in zip(("out", "dq", "dk", "dv"), flash, einsum):
        np.testing.assert_allclose(a, b, err_msg=name,
                                   **(OUT_TOL if name == "out"
                                      else GRAD_TOL))


def test_ring_rejects_what_it_cannot_take():
    mesh = tmesh.create_mesh(data=2, seq=4, devices=CPU8)
    x = torch.zeros(4, 10, 2, 32)
    with pytest.raises(ValueError, match="not divisible"):
        tring.make_ring_attention(mesh)(x, x, x)
    with pytest.raises(ValueError, match="window"):
        tring.make_ring_attention(mesh, window=4)(x[:, :8], x[:, :8],
                                                  x[:, :8])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tring.make_ring_attention(
            tmesh.create_mesh(data=2, seq=2, model=2, devices=CPU8),
            heads_sharded=True)


@pytest.mark.parametrize("window", [0, 20, 40])
def test_ring_schedule_matches_jax(window):
    for n, sk in ((4, 16), (8, 8), (2, 32)):
        want = jring._ring_schedule(n, sk, True, window)
        got = tring._ring_schedule(n, sk, True, window)
        assert got[:2] == want[:2]
        assert all(got[2](my, t) == want[2](my, t)
                   for my in range(n) for t in range(got[0]))


def test_create_mesh_follows_jax_rules_and_may_repeat_a_device():
    mesh = tmesh.create_mesh(data=2, seq=4, devices=CPU8)
    want = jmesh.create_mesh(data=2, seq=4)
    assert mesh.shape == {a: want.shape[a] for a in tmesh.AXIS_ORDER}
    assert mesh.axis_names == tmesh.AXIS_ORDER
    assert tmesh.create_mesh(seq=4, devices=CPU8[:4]).shape[
        tmesh.DATA_AXIS] == 1                      # data=-1 inferred
    assert tmesh.create_mesh(data=-1, seq=2, devices=CPU8).shape == {
        "data": 4, "seq": 2, "model": 1}
    with pytest.raises(ValueError, match="At most one"):
        tmesh.create_mesh(data=-1, seq=-1, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.create_mesh(data=-1, seq=3, devices=CPU8)
    with pytest.raises(ValueError, match="Mesh of 6 devices but 8"):
        tmesh.create_mesh(data=2, seq=3, devices=CPU8)


def test_attention_entry_point_dispatches_the_ring():
    """backend="ring" with the mesh of attention_mesh (or mesh=) runs the
    ring; shapes that do not tile the mesh take the dense path; no mesh,
    a full mask or ulysses raise."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)) for _ in range(3))
    mesh = tmesh.create_mesh(data=2, seq=4, devices=CPU8)
    dense = tattn.dot_product_attention(q, k, v, causal=True)
    with tattn.attention_mesh(mesh):
        assert tattn.default_mesh() is mesh
        ring = tattn.dot_product_attention(q, k, v, causal=True,
                                           backend="ring")
        ragged = tattn.dot_product_attention(q[:, :62], k[:, :62],
                                             v[:, :62], causal=True,
                                             backend="ring")
    assert tattn.default_mesh() is None
    torch.testing.assert_close(ring, dense, **OUT_TOL)
    torch.testing.assert_close(
        ragged, tattn.dot_product_attention(q[:, :62], k[:, :62], v[:, :62],
                                            causal=True))
    torch.testing.assert_close(
        tattn.dot_product_attention(q, k, v, causal=True, backend="ring",
                                    mesh=mesh), ring, atol=0, rtol=0)
    with pytest.raises(ValueError, match="needs mesh"):
        tattn.dot_product_attention(q, k, v, backend="ring")
    with pytest.raises(ValueError, match="full"):
        tattn.dot_product_attention(q, k, v, mask=torch.ones(1, 1, S, S),
                                    backend="ring", mesh=mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tattn.dot_product_attention(q, k, v, backend="ulysses", mesh=mesh)
