"""The port's flash attention (distributed_tensorflow_tpu_torch/ops/
flash_attention.py) against the JAX package's: ``_flash_forward`` (the
Pallas kernel in interpret mode on the CPU) for S = 128 and 256, and
``flash_attention``'s dense path for S = 48 (not a multiple the TPU
kernel tiles).  Inputs come from a seeded numpy generator.

On the CPU the port's wrapper takes its plain version;
test_torch_kernels_cuda.py holds the CUDA kernel against it on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops.pallas import flash_attention as jfa
from distributed_tensorflow_tpu_torch.ops import attention as tattn
from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa

# f32 on both sides: blockwise vs dense softmax differ in summation order.
TOL = 2e-5


def _qkv(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(3)]


def _mask(B, S, seed, first_masked=0):
    rng = np.random.default_rng(seed)
    m = rng.random((B, S)) > 0.3
    m[:, 0] = True
    m[0, :first_masked] = False
    return m


CASES = {
    "causal": dict(mask=False, window=0, first_masked=0),
    "causal_kv_mask": dict(mask=True, window=0, first_masked=0),
    "window": dict(mask=False, window=24, first_masked=0),
    "window_kv_mask": dict(mask=True, window=24, first_masked=0),
    # Causal rows 0..5 of batch 0 see no valid key: output 0, lse ~-1e30.
    "fully_masked_rows": dict(mask=True, window=0, first_masked=6),
}


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_forward_and_lse_match_jax_kernel(S, case):
    c = CASES[case]
    B, H, D = 2, 2, 32
    q, k, v = _qkv(B, S, H, D, seed=S)
    mask = _mask(B, S, seed=S + 1, first_masked=c["first_masked"]) \
        if c["mask"] else None
    want, want_lse = jfa._flash_forward(
        *map(jnp.asarray, (q, k, v)),
        None if mask is None else jnp.asarray(mask),
        causal=True, window=c["window"])
    got, got_lse = tfa.flash_attention(
        *map(torch.from_numpy, (q, k, v)),
        None if mask is None else torch.from_numpy(mask),
        causal=True, window=c["window"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    want_lse = np.asarray(want_lse)[:, 0]                 # [B*H, S]
    live = want_lse > -1e29
    assert np.array_equal(got_lse.numpy() > -1e29, live)
    np.testing.assert_allclose(got_lse.numpy()[live], want_lse[live],
                               atol=TOL, rtol=TOL)
    if c["first_masked"]:
        assert not live.all()
        np.testing.assert_array_equal(got.numpy()[0, :c["first_masked"]], 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_dense_path_matches_jax_at_untiled_length(case):
    c = CASES[case]
    B, S, H, D = 2, 48, 2, 16
    q, k, v = _qkv(B, S, H, D, seed=7)
    mask = _mask(B, S, seed=8, first_masked=c["first_masked"]) \
        if c["mask"] else None
    want = jfa.flash_attention(
        *map(jnp.asarray, (q, k, v)),
        None if mask is None else jnp.asarray(mask),
        causal=True, window=c["window"])
    got = tattn.dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        kv_mask=None if mask is None else torch.from_numpy(mask),
        causal=True, window=c["window"], backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_xla_backend_matches_jax_with_full_mask():
    from distributed_tensorflow_tpu.ops.attention import (
        dot_product_attention as jattn)
    B, S, H, D = 2, 16, 2, 8
    q, k, v = _qkv(B, S, H, D, seed=11)
    full = np.random.default_rng(12).random((B, 1, S, S)) > 0.5
    want = jattn(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(full))
    got = tattn.dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                      mask=torch.from_numpy(full))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_attention_rejects_unported_and_unknown_backends():
    q, k, v = map(torch.from_numpy, _qkv(1, 8, 1, 8, seed=4))
    # Both sequence-parallel backends are ported (parallel/ring.py,
    # parallel/ulysses.py) and need a mesh; with heads sharded over a
    # model axis (tensor parallelism) each model column attends over its
    # own heads, the dense result.
    with pytest.raises(ValueError, match="needs mesh"):
        tattn.dot_product_attention(q, k, v, causal=True, backend="ulysses")
    with pytest.raises(ValueError, match="needs mesh"):
        tattn.dot_product_attention(q, k, v, causal=True, backend="ring")
    from distributed_tensorflow_tpu_torch.parallel.mesh import create_mesh
    tp = create_mesh(data=1, model=2, devices=[torch.device("cpu")] * 2)
    two = [t.expand(1, 8, 2, 8) for t in (q, k, v)]
    torch.testing.assert_close(
        tattn.dot_product_attention(*two, causal=True, backend="ring",
                                    mesh=tp),
        tattn.dot_product_attention(*two, causal=True), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="Unknown"):
        tattn.dot_product_attention(q, k, v, backend="nope")
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, k, v, causal=False, window=4)
