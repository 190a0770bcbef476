"""The restore half of ``distributed_tensorflow_tpu/tools/export_model.py``:
a trained GPT's parameters and config from its run directory, the recipe
the serving CLI (:mod:`.serve`) and ``train.py --mode=generate`` share.

Parameters are restored raw from the run's newest (or a requested)
checkpoint (:func:`.checkpoint_io.restore_raw`), EMA weights preferred,
pipeline-parallel trees merged back to the plain layout, and the config
inferred from the tree itself.  The artifact half of the JAX module
(``build_forward``, ``export_gpt_decode``, ``load_exported`` and its
``main``, which write ``jax.export`` StableHLO) is not ported yet: see
ROADMAP.md, section 1.
"""

from __future__ import annotations

import dataclasses
import math
import os

_RESTORE_MEMO: dict = {}


def clear_restore_memo() -> None:
    """Drop the restored-checkpoint memo (potentially GBs of host
    tensors); library callers that restore and keep running should call
    it, or the last restore stays pinned for the process lifetime."""
    _RESTORE_MEMO.clear()


def _restore_raw(logdir: str, step: int | None):
    """Raw restore of <logdir>/checkpoints -> ``(params, model_state,
    global_step)``, EMA weights preferred.

    Size-1 memo keyed on the RESOLVED step: a second restore of the same
    checkpoint reuses the first read instead of re-reading GBs from disk.
    ``step=None`` re-resolves "newest" against the directory (a cheap
    listing) on every call, so a long-lived process that restores, waits
    for training, and restores again gets the new checkpoint, not the
    memo."""
    from .checkpoint_io import open_checkpoints, restore_raw

    resolved = step
    if resolved is None:
        resolved = open_checkpoints(logdir)[-1]
    key = (os.path.abspath(logdir), resolved)
    if _RESTORE_MEMO.get("key") == key:
        return _RESTORE_MEMO["value"]
    restored, _, _ = restore_raw(logdir, resolved)
    global_step = int(restored["global_step"])
    params = restored.get("ema_params") or restored["params"]
    value = (params, restored.get("model_state"), global_step)
    _RESTORE_MEMO.clear()
    _RESTORE_MEMO.update(key=key, value=value)
    return value


def _stacked_layers(stages: dict, n_virtual: int) -> int:
    """A pipelined tree's depth: the product of a stage leaf's stacking
    dims ([n_pipe, per, ...], or [n_virtual, n_pipe, per, ...])."""
    leaf = stages
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return math.prod(leaf.shape[:3 if n_virtual > 1 else 2])


def merge_if_pipelined(tree: dict, n_virtual: int) -> dict:
    """A pipelined checkpoint tree in the plain layout (others as they
    are)."""
    from ..models import gpt as gpt_lib

    if "stages" not in tree:
        return tree
    return gpt_lib.merge_pipeline_params(
        tree, _stacked_layers(tree["stages"], n_virtual),
        n_virtual=n_virtual)


def _gpt_tree_and_cfg(params, *, gpt_positions: str = "auto",
                      attention_window: int = 0,
                      pipeline_virtual_stages: int = 1):
    """Checkpoint tree -> (GptConfig, plain-layout tree).

    Everything the checkpoint itself reveals is inferred: pipelined trees
    merge back to the plain layout; ``--gpt_positions=rope`` runs have no
    pos_emb table; the vocabulary, the widths
    (:func:`..models.gpt.infer_widths`, where the JAX package keeps
    ``mini()``'s) and GQA kv heads / swiglu / rmsnorm show in the tree.
    Only the attention window and virtual-stage count must be re-passed
    (not inferable from the tree)."""
    from ..models import gpt as gpt_lib

    tree = merge_if_pipelined(params, pipeline_virtual_stages)
    if gpt_positions == "auto":
        gpt_positions = "learned" if "pos_emb" in tree else "rope"
    layer0 = tree.get("layer0", {})
    arch = gpt_lib.infer_arch_from_layer0(layer0) if layer0 else {}
    cfg = dataclasses.replace(gpt_lib.mini(), pos_encoding=gpt_positions,
                              attention_window=attention_window,
                              **gpt_lib.infer_widths(tree), **arch)
    return cfg, tree


def kernel_config(cfg):
    """``cfg`` with the port's decode paths on the hand-written kernels:
    flash attention (K1) for every pass over a prompt and the LayerNorm
    kernel (K3) for every LayerNorm (RMSNorm has none).  On the CPU the
    kernels' wrappers run their plain versions."""
    return dataclasses.replace(cfg, attention_backend="pallas",
                               fused_ln=cfg.norm == "layernorm")
