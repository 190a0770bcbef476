"""The on-disk layout of one orbax ``StandardSave`` item, read and written
without orbax or jax.

An item directory (``<ckpt_dir>/<step>/default/``) holds ``_METADATA``, a
JSON object whose ``tree_metadata`` maps every leaf to its key path
(``key_type`` 2 is a dict key, 1 a sequence index) and its value type,
beside the layout flags ``use_ocdbt`` and ``use_zarr3``.  The arrays are
zarr v2 arrays named by the dotted key path (``params.layer0.qkv.kernel``):

- ``use_ocdbt: false``: one directory per array, holding ``.zarray`` and
  one file per chunk (``0.0`` for a rank-2 array, ``0`` for a scalar).
  numpy reads and writes these; chunks compressed with ``zlib`` use the
  standard library, ``zstd`` (orbax's default compressor) needs the
  ``zstandard`` package.
- ``use_ocdbt: true`` (orbax's default): every array inside one OCDBT
  key-value store (``manifest.ocdbt`` and B-tree files), which only the
  ``tensorstore`` package reads.
- ``use_zarr3: true``, or any other layout: refused.

Leaves come back as CPU tensors, because bfloat16 has no numpy dtype
without ``ml_dtypes``: its bytes are read as uint16 and viewed as
``torch.bfloat16``.  Sequences come back as lists and
Python scalars as Python numbers, as orbax's raw restore returns them.
The writer writes ``use_ocdbt: false`` with one uncompressed chunk per
array and value type ``np.ndarray``, which orbax restores.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import zlib

import numpy as np
import torch

METADATA_NAME = "_METADATA"

# The zarr dtype numpy lacks without ml_dtypes: its bytes are read as
# uint16 and viewed as torch's.
_BF16 = "bfloat16"
# Leaves orbax writes no array for (skip_deserialize).
_EMPTY_VALUES = {"None": lambda: None, "Dict": dict, "List": list,
                 "Tuple": tuple}
_ARRAY_VALUES = ("jax.Array", "np.ndarray", "scalar")
_DICT_KEY, _SEQUENCE_KEY = 2, 1


# ------------------------------------------------------------------ read


def read_item(item_dir: str):
    """The tree saved in ``item_dir``; raises on a layout it cannot read."""
    with open(os.path.join(item_dir, METADATA_NAME)) as fh:
        meta = json.load(fh)
    if meta.get("use_zarr3"):
        raise ValueError(f"{item_dir}: the zarr3 layout is not supported")
    ocdbt = meta.get("use_ocdbt")
    if ocdbt is True:
        read = _ocdbt_reader(item_dir)
    elif ocdbt is False:
        def read(name):
            return _read_zarr_v2(os.path.join(item_dir, name))
    else:
        raise ValueError(f"{item_dir}: unknown layout (use_ocdbt="
                         f"{ocdbt!r})")
    root = None
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if kind in _EMPTY_VALUES:
            leaf = _EMPTY_VALUES[kind]()
        elif kind in _ARRAY_VALUES:
            leaf = read(".".join(str(k["key"]) for k in keys))
            if kind == "scalar":
                leaf = leaf.item()
        else:
            raise ValueError(f"{item_dir}: leaf {keys} has value type "
                             f"{kind!r}, which this reader does not take")
        root = _insert(root, keys, leaf)
    return _finish(root)


class _Sequence(dict):
    """A sequence node while the tree is built (index -> child)."""


def _node(key_type: int) -> dict:
    if key_type == _DICT_KEY:
        return {}
    if key_type == _SEQUENCE_KEY:
        return _Sequence()
    raise ValueError(f"unknown key_type {key_type}")


def _insert(root, keys: list, leaf):
    if root is None:
        root = _node(keys[0]["key_type"])
    node = root
    for i, k in enumerate(keys):
        key = k["key"] if k["key_type"] == _DICT_KEY else int(k["key"])
        if i == len(keys) - 1:
            node[key] = leaf
        else:
            node = node.setdefault(key, _node(keys[i + 1]["key_type"]))
    return root


def _finish(node):
    if isinstance(node, _Sequence):
        return [_finish(node[i]) for i in sorted(node)]
    if isinstance(node, dict):
        return {k: _finish(v) for k, v in node.items()}
    return node


def _c_order(a: np.ndarray) -> np.ndarray:
    """``a`` C-contiguous and writable (0-d stays 0-d, unlike
    ``np.ascontiguousarray``)."""
    return np.require(a, requirements=("C", "W"))


def _to_tensor(a: np.ndarray, zarr_dtype: str | None = None) -> torch.Tensor:
    """A numpy array (of the raw bytes, for bfloat16) as a tensor."""
    if (zarr_dtype or a.dtype.name) == _BF16:
        return torch.from_numpy(_c_order(a).view("<u2")).view(torch.bfloat16)
    return torch.from_numpy(_c_order(a))


def _chunk_loader(spec, dtype: np.dtype, nbytes: int):
    """``load(path)`` -> a chunk file's values (flat), per compressor."""
    if spec is None:
        return lambda path: np.fromfile(path, dtype)
    cid = spec.get("id")
    if cid == "zlib":
        decompress = zlib.decompress
    elif cid == "zstd":
        try:
            import zstandard
        except ImportError as e:
            raise ImportError(
                "this checkpoint's chunks are zstd-compressed (orbax's "
                "default compressor); reading them needs the 'zstandard' "
                "package") from e
        dctx = zstandard.ZstdDecompressor()

        def decompress(raw):
            return dctx.decompress(raw, max_output_size=nbytes)
    else:
        raise ValueError(f"unsupported zarr compressor {spec!r}")

    def load(path):
        with open(path, "rb") as fh:
            return np.frombuffer(bytearray(decompress(fh.read())), dtype)
    return load


def _read_zarr_v2(array_dir: str) -> torch.Tensor:
    with open(os.path.join(array_dir, ".zarray")) as fh:
        z = json.load(fh)
    if z.get("zarr_format") != 2 or z.get("filters"):
        raise ValueError(f"{array_dir}: not a plain zarr v2 array")
    name = z["dtype"]
    dtype = np.dtype("<u2" if name == _BF16 else name)
    if z.get("order", "C") != "C" or not dtype.isnative:
        raise ValueError(f"{array_dir}: only C-order arrays of native byte "
                         f"order are read (order {z.get('order')!r}, "
                         f"dtype {name!r})")
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    sep = z.get("dimension_separator", ".")
    load = _chunk_loader(z.get("compressor"), dtype,
                         math.prod(chunks) * dtype.itemsize)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    paths = {idx: os.path.join(array_dir, sep.join(map(str, idx)) or "0")
             for idx in itertools.product(*grid)}
    if chunks == shape and all(map(os.path.exists, paths.values())):
        # One chunk covering the array (the writer's layout, and orbax's
        # for an unsharded array): no assembly.
        (path,) = paths.values()
        return _to_tensor(load(path).reshape(shape), name)
    fill = z.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dtype)
    for idx, path in paths.items():
        if not os.path.exists(path):
            continue                     # a missing chunk is fill_value
        chunk = load(path).reshape(chunks)
        # Edge chunks are stored at full size: crop to the array.
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return _to_tensor(out, name)


def _ocdbt_reader(item_dir: str):
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"{item_dir} is an OCDBT checkpoint (orbax's default layout); "
            "reading it needs the 'tensorstore' package") from e
    context = ts.Context()
    base = "file://" + os.path.abspath(item_dir)

    def read(name):
        store = ts.open({"driver": "zarr",
                         "kvstore": {"driver": "ocdbt", "base": base,
                                     "path": name + "/"}},
                        open=True, context=context).result()
        return _to_tensor(np.asarray(store.read().result()))
    return read


# ----------------------------------------------------------------- write


def _leaves(tree, path=()):
    """``(key_metadata, leaf)`` for every leaf, depth first."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _leaves(v, path + ((str(k), _DICT_KEY),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _leaves(v, path + ((str(i), _SEQUENCE_KEY),))
    else:
        yield path, tree


def _as_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as C-contiguous numpy bytes and its zarr dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("<u2"), _BF16
        a = t.numpy()
    else:
        a = _c_order(np.asarray(leaf))
    if a.dtype.name == _BF16:                    # an ml_dtypes array
        return a.view("<u2"), _BF16
    return a, a.dtype.str


def _write_array(array_dir: str, a: np.ndarray, name: str) -> None:
    os.makedirs(array_dir)
    zarray = {"chunks": [max(d, 1) for d in a.shape], "compressor": None,
              "dimension_separator": ".", "dtype": name, "fill_value": None,
              "filters": None, "order": "C", "shape": list(a.shape),
              "zarr_format": 2}
    with open(os.path.join(array_dir, ".zarray"), "w") as fh:
        json.dump(zarray, fh)
    if a.size:
        key = ".".join("0" for _ in a.shape) or "0"
        with open(os.path.join(array_dir, key), "wb") as fh:
            fh.write(memoryview(a).cast("B"))


def write_item(item_dir: str, tree) -> None:
    """Write ``tree`` (nested dicts, lists and tuples of tensors or numpy
    arrays, and None) into ``item_dir``, which must not exist."""
    os.makedirs(item_dir)
    entries = {}
    for path, leaf in _leaves(tree):
        if not path:
            raise ValueError("the tree must be a non-empty dict, list or "
                             "tuple")
        if leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        elif isinstance(leaf, dict):
            value = {"value_type": "Dict", "skip_deserialize": True}
        elif isinstance(leaf, (list, tuple)):
            value = {"value_type": type(leaf).__name__.title(),
                     "skip_deserialize": True}
        else:
            a, name = _as_numpy(leaf)
            _write_array(os.path.join(item_dir, ".".join(k for k, _ in path)),
                         a, name)
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
        keys = tuple(k for k, _ in path)
        entries[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in path],
            "value_metadata": value}
    meta = {"tree_metadata": entries, "use_ocdbt": False,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}
    with open(os.path.join(item_dir, METADATA_NAME), "w") as fh:
        json.dump(meta, fh)
