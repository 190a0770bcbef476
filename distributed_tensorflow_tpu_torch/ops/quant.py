"""Weight-only int8 quantization and the KV-cache dtype table.

Counterpart of ``distributed_tensorflow_tpu/ops/quant.py``, on a flat
``state_dict``-style mapping (parameter name -> tensor) instead of a
pytree.  Decode is memory-bound: every generated token re-reads the whole
weight set, so storing weights as **per-channel symmetric int8** halves
those bytes.  The dequantize (``q * s``) runs inside each serving step,
so the stored tree stays int8.

:func:`quantize_tree` maps each eligible float leaf to a
``{"q": int8, "s": float32}`` dict (scale per output channel and per
small fused-projection axis, see :func:`quantize_leaf`); small or integer
leaves pass through unchanged.  :func:`dequantize_tree` restores a
compute-dtype mapping with the original names.
"""

from __future__ import annotations

from typing import Any

import torch

_QKEYS = frozenset({"q", "s"})


def resolve_kv_dtype(name: str):
    """KV-cache dtype from its CLI spelling, the one mapping shared by the
    model and the serving engine: "float8" is ``torch.float8_e4m3fn``.
    ``""`` means "the compute dtype" and maps to None (caller default)."""
    table = {"": None, "bfloat16": torch.bfloat16,
             "float8": torch.float8_e4m3fn}
    if name not in table:
        raise ValueError(
            f"kv_dtype must be '', 'bfloat16' or 'float8', got {name!r}")
    return table[name]


def validate_quantize(name: str) -> str:
    """Weight-storage mode from its CLI spelling."""
    if name not in ("", "int8"):
        raise ValueError(f"quantize must be '' or 'int8', got {name!r}")
    return name


def prepare_inference_tree(params: dict, quantize: str) -> dict:
    """Parameter mapping -> the mapping an inference path should CARRY
    between steps: per-channel int8 + scales under ``quantize="int8"``,
    the original mapping otherwise.  Pair with :func:`load_inference_tree`
    inside the step."""
    validate_quantize(quantize)
    return quantize_tree(params) if quantize == "int8" else params


def load_inference_tree(tree: dict, quantize: str,
                        dtype: torch.dtype) -> dict:
    """Inverse of :func:`prepare_inference_tree`, called inside each step."""
    if quantize == "int8":
        return dequantize_tree(tree, dtype)
    return tree


def _is_qleaf(x: Any) -> bool:
    return isinstance(x, dict) and frozenset(x.keys()) == _QKEYS


def quantize_leaf(w: torch.Tensor) -> dict:
    """Per-channel symmetric int8: ``w ~= q * s`` with |q| <= 127.

    Scales vary along the LAST axis plus any small inner axes (size <= 4,
    e.g. the fused-projection axis of GPT's qkv kernel [hidden, 3, H, D]:
    Q/K/V get distinct scales); every other axis, the contraction axes of
    the kernels, is reduced.  The port keeps the JAX package's kernel
    layouts, so the same rule groups the same values."""
    w32 = w.to(torch.float32)
    reduce_axes = tuple(i for i in range(w.dim() - 1)
                        if not (0 < i and w.shape[i] <= 4))
    amax = w32.abs().amax(dim=reduce_axes, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def quantize_tree(params: dict, *, min_size: int = 4096) -> dict:
    """Quantize every float leaf with >= ``min_size`` elements and >= 2
    dims; biases and norm gains stay in their original dtype."""
    def leaf(w):
        if (not isinstance(w, torch.Tensor) or not w.is_floating_point()
                or w.dim() < 2 or w.numel() < min_size):
            return w
        return quantize_leaf(w)
    return {name: leaf(w) for name, w in params.items()}


def dequantize_tree(qparams: dict, dtype=torch.bfloat16) -> dict:
    """Rebuild a compute-dtype mapping (each quantized leaf becomes
    ``(q * s).to(dtype)``; the rest pass through)."""
    return {name: ((x["q"].to(torch.float32) * x["s"]).to(dtype)
                   if _is_qleaf(x) else x)
            for name, x in qparams.items()}


def quantized_bytes(qparams: dict) -> int:
    """Total parameter bytes as stored (int8 + scales + passthrough)."""
    total = 0
    for x in qparams.values():
        for t in (x.values() if _is_qleaf(x) else (x,)):
            total += t.numel() * t.element_size()
    return total
