"""The port's ulysses attention (distributed_tensorflow_tpu_torch/parallel/
ulysses.py: the head/sequence all-to-all over a single-process mesh of
[cpu] * 8, the gathered sequence through ops/flash_attention's function,
whose plain version runs on the CPU) against the JAX package's
make_ulysses_attention on the 8 fake CPU devices of tests/conftest.py
(its flash path in Pallas interpret mode), on the JAX test_ulysses.py
cases: dense, padding, causal, window, fully masked rows, tensor-parallel
heads, gradients, bf16, the raises, ulysses = ring, and the dispatch of
ops/attention with its dense fallback.  Inputs from seeded numpy
generators.  Tolerances: f32 outputs 1e-5 and gradients 2e-4, as the JAX
tests hold JAX's ulysses to its dense path (both sides exact attention;
the sums differ in order only); bf16 0.05 against the f32 dense result,
as JAX's bf16 case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops.attention import (
    dot_product_attention as jattention)
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.parallel.ulysses import (
    make_ulysses_attention as jmake)
from distributed_tensorflow_tpu_torch.ops import attention as tattn
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel.ring import (
    make_ring_attention)
from distributed_tensorflow_tpu_torch.parallel.ulysses import (
    make_ulysses_attention, ulysses_attention_local)

CPU8 = [torch.device("cpu")] * 8
OUT = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B=4, S=16, H=4, D=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _mask(seed, B, S, p=0.3):
    m = np.random.default_rng(seed).random((B, S)) > p
    m[:, 0] = True                 # at least one key a row
    return m


def _meshes(**axes):
    n = int(np.prod(list(axes.values())))
    return (jmesh.create_mesh(devices=jax.devices()[:n], **axes),
            tmesh.create_mesh(devices=CPU8[:n], **axes))


def _both(arrays, kw, axes, mask=None):
    jm, tm = _meshes(**axes)
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a) for a in arrays]
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    return (np.asarray(jmake(jm, **kw)(*jargs, jmask)),
            make_ulysses_attention(tm, **kw)(*targs, tmask).numpy())


@pytest.mark.parametrize("case,axes,shape,kw,mask_seed", [
    ("dense", dict(data=2, seq=4), {}, {}, None),
    ("padding", dict(data=2, seq=4), {}, {}, 9),
    ("causal", dict(data=1, seq=8), dict(B=2, S=32, H=8), dict(causal=True),
     None),
    ("window", dict(data=2, seq=4), dict(S=32), dict(causal=True, window=6),
     None),
    ("flash_path", dict(data=2, seq=4), dict(S=64), dict(causal=True), 5),
    ("dense_local", dict(data=2, seq=4), dict(S=64),
     dict(causal=True, use_flash=False), 5),
    ("tp_heads", dict(data=2, seq=2, model=2), dict(B=2, S=8, H=4),
     dict(heads_sharded=True), None),
    ("tp_heads_causal", dict(data=1, seq=2, model=2), dict(B=2, S=16, H=8),
     dict(heads_sharded=True, causal=True), 3),
])
def test_ulysses_matches_jax(case, axes, shape, kw, mask_seed):
    arrays = _qkv(len(case), **shape)
    B, S = arrays[0].shape[:2]
    mask = None if mask_seed is None else _mask(mask_seed, B, S)
    want, got = _both(arrays, kw, axes, mask)
    np.testing.assert_allclose(got, want, **OUT)


def test_fully_masked_rows_are_zero_not_nan():
    arrays = _qkv(3)
    mask = np.zeros((4, 16), bool)
    mask[1:] = True                 # batch 0: every key masked
    want, got = _both(arrays, {}, dict(data=2, seq=4), mask)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got[0], 0.0, atol=1e-6)
    np.testing.assert_allclose(got, want, **OUT)


@pytest.mark.parametrize("kw,shape", [
    ({}, dict(B=2, S=8)),
    (dict(causal=True), dict(S=64)),
    (dict(causal=True, heads_sharded=True), dict(B=2, S=16, H=8)),
])
def test_gradients_match_jax(kw, shape):
    axes = (dict(data=1, seq=2, model=2) if kw.get("heads_sharded")
            else dict(data=2, seq=4))
    jm, tm = _meshes(**axes)
    q, k, v = _qkv(5, **shape)
    jfn = jmake(jm, **kw)
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jfn(*a))), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.sin(make_ulysses_attention(tm, **kw)(*ts)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD)


def test_bf16_close_to_dense():
    jm, tm = _meshes(data=2, seq=4)
    arrays = _qkv(7)
    out = make_ulysses_attention(tm)(*(torch.from_numpy(a).to(
        torch.bfloat16) for a in arrays))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jattention(*map(jnp.asarray, arrays), backend="xla"))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0.05,
                               atol=0.05)


def test_raises_as_jax():
    jm, tm = _meshes(data=2, seq=4)
    for shape, match in ((dict(S=10), "not divisible"),
                         (dict(H=2), "heads")):
        arrays = _qkv(8, **shape)
        with pytest.raises(ValueError, match=match) as want:
            jmake(jm)(*map(jnp.asarray, arrays))
        with pytest.raises(ValueError, match=match) as got:
            make_ulysses_attention(tm)(*map(torch.from_numpy, arrays))
        assert str(got.value) == str(want.value)
    x = [torch.zeros(1, 2, 3, 4)] * 2
    with pytest.raises(ValueError, match=r"heads \(3\) divisible by the "
                       r"'seq' axis size \(2\)"):
        ulysses_attention_local(x, x, x, devices=CPU8[:2])
    with pytest.raises(ValueError, match="window"):
        ulysses_attention_local(x, x, x, devices=CPU8[:2], window=2)


def test_ulysses_equals_ring():
    """Both sequence-parallel backends compute the same exact attention."""
    tm = tmesh.create_mesh(data=2, seq=4, devices=CPU8)
    q, k, v = map(torch.from_numpy, _qkv(12, S=64))
    mask = torch.from_numpy(_mask(6, 4, 64, p=0.4))
    uly = make_ulysses_attention(tm, causal=True)
    ring = make_ring_attention(tm, causal=True)
    torch.testing.assert_close(uly(q, k, v, mask), ring(q, k, v, mask),
                               **OUT)
    grads = []
    for fn in (uly, ring):
        qq = q.clone().requires_grad_()
        (fn(qq, k, v, mask) ** 2).sum().backward()
        grads.append(qq.grad)
    torch.testing.assert_close(grads[0], grads[1], **GRAD)


def test_dispatch_and_its_dense_fallback():
    """backend="ulysses" + mesh through ops/attention, as models call it;
    on the CPU, head counts the all-to-all cannot split take the dense
    path, as in the JAX package (on the card they go to the ring:
    tests/test_torch_kernels_cuda.py)."""
    jm, tm = _meshes(data=2, seq=4)
    for seed, shape in ((13, {}), (14, dict(H=2))):
        arrays = _qkv(seed, **shape)
        want = np.asarray(jattention(*map(jnp.asarray, arrays), causal=True,
                                     backend="ulysses", mesh=jm))
        got = tattn.dot_product_attention(*map(torch.from_numpy, arrays),
                                          causal=True, backend="ulysses",
                                          mesh=tm)
        np.testing.assert_allclose(got.numpy(), want, **OUT)
    # With a model axis: heads sharded when they divide it.
    jm, tm = _meshes(data=2, seq=2, model=2)
    arrays = _qkv(15, B=2, S=8, H=4)
    want = np.asarray(jattention(*map(jnp.asarray, arrays),
                                 backend="ulysses", mesh=jm))
    with tattn.attention_mesh(tm):
        got = tattn.dot_product_attention(*map(torch.from_numpy, arrays),
                                          backend="ulysses")
    np.testing.assert_allclose(got.numpy(), want, **OUT)
    with pytest.raises(ValueError, match="needs mesh"):
        tattn.dot_product_attention(*map(torch.from_numpy, arrays),
                                    backend="ulysses")
