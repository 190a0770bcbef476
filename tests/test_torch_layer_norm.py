"""The port's LayerNorm (distributed_tensorflow_tpu_torch/ops/layer_norm.py)
against the JAX package's fused LayerNorm, which runs its Pallas kernel in
interpret mode on the CPU.  Inputs come from a seeded numpy generator and
reach both frameworks as the same values.

On the CPU the port's wrapper takes its plain version;
test_torch_kernels_cuda.py holds the CUDA kernel against it on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.ops.pallas.layer_norm import fused_layer_norm
from distributed_tensorflow_tpu_torch.ops import layer_norm as ln

# fp32 statistics on both sides; only the summation order differs.
TOL = 1e-5


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 16, 128), (2, 7, 96), (8, 64)])
def test_layer_norm_matches_jax(shape, dtype):
    x, scale, bias = _inputs(shape, seed=len(shape) + shape[-1])
    want = fused_layer_norm(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                            jnp.asarray(bias))
    got = ln.layer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_layer_norm_module_carries_flax_names_and_fp32_params():
    m = ln.LayerNorm(32, fused=True, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in m.state_dict().items()} == {
        "scale": ((32,), torch.float32), "bias": ((32,), torch.float32)}
    x, scale, bias = _inputs((3, 32), seed=5)
    m.load_state_dict({"scale": torch.from_numpy(scale),
                       "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = m(torch.from_numpy(x).to(torch.bfloat16))
    want = fused_layer_norm(jnp.asarray(x).astype(jnp.bfloat16),
                            jnp.asarray(scale), jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_layer_norm_rejects_other_devices():
    x = torch.ones(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ln.layer_norm(x, torch.ones(8, device="meta"),
                      torch.zeros(8, device="meta"))
