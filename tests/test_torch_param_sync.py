"""The port's cross-process parameter exchange
(``distributed_tensorflow_tpu_torch/cluster/param_sync.py``) against the
JAX package's.

**Mirrored cases.**  Every case of ``tests/test_param_sync.py`` and every
protocol case of ``tests/test_param_exchange.py`` runs against the port:
the JAX test modules are loaded with their imports of the JAX package's
exchange (``cluster``, ``parallel.sync``, ``utils``) pointed at the port,
and each of their test functions is one parametrised case here
(``test_mirrored``).  The one JAX case that needs a JAX mesh
(``test_jitted_intra_slice_psum_reduce_matches_host_mean``) has its port
counterpart below (``test_intra_slice_reduce_matches_host_mean``).  The
test bodies, inputs and tolerances are the JAX files', unchanged.

**Interop.**  The port and the JAX package share the wire: the same tree
fingerprint for the same tree (fp32 and bf16, JAX's ``<V2``), bit-equal
int8/bf16 shard blobs from the same input, and mixed JAX/port averagers
on one in-process coordination service reaching the same consensus as
JAX-only ones, bit for bit.
"""

import inspect
import os
import types

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.cluster import coordination as jcoord
from distributed_tensorflow_tpu.cluster import param_sync as jps
from distributed_tensorflow_tpu_torch.cluster import coordination as tcoord
from distributed_tensorflow_tpu_torch.cluster import param_sync as tps
from distributed_tensorflow_tpu_torch.parallel.sync import (
    build_intra_slice_reduce)

TESTS = os.path.dirname(os.path.abspath(__file__))

#: The JAX modules whose imports a mirrored test points at the port (the
#: exchange and what it stands on, the serving tier's host modules and
#: tools); any other JAX import stays JAX's.  A module path a test hands
#: to ``python -m`` is an import too: it spawns the port's CLI.
PORTED_IMPORTS = ("distributed_tensorflow_tpu.cluster",
                  "distributed_tensorflow_tpu.parallel.sync",
                  "distributed_tensorflow_tpu.parallel.async_replicas",
                  "distributed_tensorflow_tpu.serving",
                  "distributed_tensorflow_tpu.tools",
                  "distributed_tensorflow_tpu.training.elastic",
                  "distributed_tensorflow_tpu.utils")


def mirror_module(filename: str, replace=()) -> types.ModuleType:
    """The JAX test module ``filename`` with its :data:`PORTED_IMPORTS`
    pointed at the port, and each ``(old, new)`` of ``replace`` applied
    to its source (the file on disk is not changed)."""
    path = os.path.join(TESTS, filename)
    with open(path) as fh:
        src = fh.read()
    for old, new in replace:
        assert old in src, f"{filename} has no {old!r}"
        src = src.replace(old, new)
    for name in PORTED_IMPORTS:
        src = src.replace(name, name.replace("distributed_tensorflow_tpu",
                                             "distributed_tensorflow_tpu_torch",
                                             1))
    mod = types.ModuleType("mirror_" + filename[:-3])
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def run_mirrored(fn, request, given=None):
    """Call a mirrored test function with the fixtures it names, or the
    values in ``given`` (a parametrised case's arguments)."""
    given = given or {}
    kwargs = {p: given[p] if p in given else request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    return fn(**kwargs)


#: JAX cases with a port counterpart of their own in this file.
NEEDS_A_JAX_MESH = ("test_jitted_intra_slice_psum_reduce_matches_host_mean",)

MIRRORS = {name: mirror_module(name)
           for name in ("test_param_sync.py", "test_param_exchange.py")}
CASES = [(f, name) for f, mod in MIRRORS.items() for name in vars(mod)
         if name.startswith("test_") and name not in NEEDS_A_JAX_MESH]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("filename,name", CASES,
                         ids=[f"{f[5:-3]}::{n}" for f, n in CASES])
def test_mirrored(filename, name, request):
    run_mirrored(getattr(MIRRORS[filename], name), request)


def test_mirrors_cover_every_case():
    """Each JAX case is mirrored or has its counterpart here."""
    for filename, mod in MIRRORS.items():
        names = {n for n in vars(mod) if n.startswith("test_")}
        assert names - set(NEEDS_A_JAX_MESH) == {
            n for f, n in CASES if f == filename}
    assert len(CASES) >= 55


def test_intra_slice_reduce_matches_host_mean():
    """The port's ICI leg (the JAX mesh case's counterpart): the
    intra-slice reduction is one mean on the replicas' device, and the
    exporter's slice mean through it reaches the host-mean consensus."""
    FakeCoord = MIRRORS["test_param_exchange.py"].FakeCoord
    k = 8
    reduce_fn = build_intra_slice_reduce("cpu")
    rng = np.random.default_rng(0)
    stacked = rng.standard_normal((k, 1024)).astype(np.float32)
    np.testing.assert_allclose(reduce_fn(stacked), stacked.mean(axis=0),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(reduce_fn(torch.from_numpy(stacked)),
                               stacked.mean(axis=0), rtol=1e-5, atol=1e-6)

    def run(intra_fn):
        store = {}
        avgs = [tps.HierarchicalCompressedAverager(
            FakeCoord(store), t, k, slice_size=k,
            intra_reduce_fn=intra_fn if t == 0 else None)
            for t in range(k)]
        params = [{"w": np.full(512, float(t), np.float32)}
                  for t in range(k)]
        for _ in range(12):
            for t in range(k):
                params[t], _ = avgs[t].exchange(params[t])
        return np.asarray(params[0]["w"])

    np.testing.assert_allclose(run(reduce_fn), run(None), atol=1e-5)


# ---------------------------------------------------------------- interop


def _f32_tree(seed):
    rng = np.random.default_rng(seed)
    return {"sm": {"kernel": rng.standard_normal((16, 10)).astype(np.float32),
                   "bias": rng.standard_normal(10).astype(np.float32)},
            "hid": {"kernel": rng.standard_normal((64, 16)).astype(np.float32),
                    "bias": rng.standard_normal(16).astype(np.float32)}}


def _special_f32(n, seed):
    """Values that stress a bf16 cast: NaNs of both signs and payloads,
    infinities, subnormals, ties, and ordinary values."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    special = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFA3E7AC,
                        0x7FFFFFFF, 0x7F800000, 0xFF800000, 0x00000001,
                        0x80000001, 0x007FFFFF, 0x7F7FFFFF, 0x3F808000,
                        0x3F818000, 0x00008000, 0x00018000, 0, 0x80000000],
                       np.uint32)
    bits[:special.size] = special
    return bits.view(np.float32)


def _bf16_pair(seed):
    """The same bf16 tree in both packages' forms: ``ml_dtypes`` arrays
    (JAX) and :class:`BF16` words (the port)."""
    f = _f32_tree(seed)
    jtree = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), f)
    ttree = jax.tree.map(lambda a: tps.BF16(a.view(np.uint16)), jtree)
    return jtree, ttree


def test_bf16_cast_is_ml_dtypes_bit_for_bit():
    f = _special_f32(1 << 16, 1)
    with np.errstate(invalid="ignore"):
        want = f.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(np.asarray(tps.f32_to_bf16(f)), want)
    words = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    np.testing.assert_array_equal(
        tps.bf16_to_f32(words).view(np.uint32),
        words.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_fingerprint_equal_across_packages(dtype):
    if dtype == "float32":
        jtree = ttree = _f32_tree(0)
    else:
        jtree, ttree = _bf16_pair(0)
    assert tps.tree_fingerprint(ttree) == jps.tree_fingerprint(jtree)
    # A bf16 tensor tree (the card's leaves) fingerprints the same.
    if dtype == "bfloat16":
        tensors = jax.tree.map(
            lambda a: torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16), jtree)
        assert tps.tree_fingerprint(tensors) == jps.tree_fingerprint(jtree)
    # The flat bytes line up leaf for leaf (sorted keys, as jax.tree).
    np.testing.assert_array_equal(tps._flatten(ttree), jps._flatten(jtree))


@pytest.mark.parametrize("fmt", ["int8", "bf16"])
def test_shard_blobs_bit_equal_across_packages(fmt, tmp_path):
    values = (_special_f32(5000, 2) if fmt == "bf16" else
              np.random.default_rng(3).standard_normal(5000).astype(
                  np.float32))
    kw = dict(kind=jps.KIND_DELTA,
              fmt=jps.FMT_INT8 if fmt == "int8" else jps.FMT_BF16,
              round_=7, epoch=2, shard=1, nshards=3, mask=5, block=1024)
    with np.errstate(invalid="ignore"):     # ml_dtypes' cast of the NaNs
        want = jps.encode_shard(values, **kw)
    got = tps.encode_shard(values, **kw)
    assert [bytes(memoryview(p).cast("B")) for p in got] == \
        [bytes(memoryview(p).cast("B")) for p in want]
    for compress in (True, False):
        jf = jps.write_blob_file(str(tmp_path / "j"), "t", 1, want,
                                 compress=compress)
        tf = tps.write_blob_file(str(tmp_path / "t"), "t", 1, got,
                                 compress=compress)
        assert jf[1:] == tf[1:]
        with open(tmp_path / "j" / jf[0], "rb") as a, \
                open(tmp_path / "t" / tf[0], "rb") as b:
            assert a.read() == b.read()
    blob = b"".join(bytes(memoryview(p).cast("B")) for p in got)
    hdr_t, vals_t = tps.decode_shard(blob)
    hdr_j, vals_j = jps.decode_shard(blob)
    assert hdr_t == hdr_j
    np.testing.assert_array_equal(vals_t.view(np.uint32),
                                  vals_j.view(np.uint32))


@pytest.fixture
def coord_server():
    srv = tcoord.CoordinationServer(port=0, num_tasks=4,
                                    heartbeat_timeout=30.0)
    srv.start()
    yield srv
    srv.stop()


def _clients(srv, packages):
    """One coordination client a task: the JAX package's for a ``"jax"``
    worker, the port's for a ``"torch"`` one, on one service."""
    return [(jcoord if p == "jax" else tcoord).CoordinationClient(
        "127.0.0.1", srv.port, task_id=t) for t, p in enumerate(packages)]


@pytest.mark.parametrize("transport", ["kv", "binary"])
def test_mixed_param_averagers_reach_one_consensus(coord_server, tmp_path,
                                                   transport):
    kw = ({"exchange_dir": str(tmp_path), "binary_threshold": 1}
          if transport == "binary" else {})
    clients = _clients(coord_server, ["jax", "torch"])
    try:
        ja = jps.ParamAverager(clients[0], 0, 2, namespace="mix", **kw)
        ta = tps.ParamAverager(clients[1], 1, 2, namespace="mix", **kw)
        for dtype in ("float32", "bfloat16"):
            if dtype == "float32":
                jt, tt = _f32_tree(1), _f32_tree(2)
            else:
                jt, tt = _bf16_pair(1)[0], _bf16_pair(2)[1]
            ja.exchange(jt)
            assert ja.last_publish_transport == transport
            avg_t, peers = ta.exchange(tt)
            assert peers == 1
            avg_j, peers = ja.exchange(jt)
            assert peers == 1
            for (pj, lj), (pt, lt) in zip(
                    jax.tree_util.tree_flatten_with_path(avg_j)[0],
                    jax.tree_util.tree_flatten_with_path(avg_t)[0]):
                assert pj == pt
                np.testing.assert_array_equal(
                    np.asarray(lj).view(np.uint8),
                    np.asarray(lt).view(np.uint8))
            if dtype == "bfloat16":
                assert isinstance(avg_t["hid"]["kernel"], tps.BF16)
    finally:
        for c in clients:
            c.close()


def _run_exchange(packages, make, rounds, seed_base=0):
    store = {}

    class Coord:
        def kv_set(self, key, value):
            store[key] = value

        def kv_get(self, key):
            return store.get(key)

    n = len(packages)
    avgs = [make(jps if p == "jax" else tps, Coord(), t, n)
            for t, p in enumerate(packages)]
    params = [_f32_tree(seed_base + t) for t in range(n)]
    history = []
    for _ in range(rounds):
        for t in range(n):
            params[t], _ = avgs[t].exchange(params[t])
        history.append([jps._flatten(p).copy() for p in params])
    return history, avgs


@pytest.mark.parametrize("quant", ["int8", "bf16"])
def test_mixed_compressed_pair_matches_jax_pair(quant):
    def make(ps, coord, t, n):
        return ps.CompressedShardedAverager(coord, t, n, quant=quant)
    want, _ = _run_exchange(["jax", "jax"], make, 8)
    got, avgs = _run_exchange(["jax", "torch"], make, 8)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)
    assert avgs[1].rounds_completed >= 2


def test_mixed_hierarchical_set_matches_jax_set():
    def make(ps, coord, t, n):
        return ps.HierarchicalCompressedAverager(coord, t, n, slice_size=2)
    want, _ = _run_exchange(["jax"] * 4, make, 20)
    got, avgs = _run_exchange(["jax", "torch", "torch", "jax"], make, 20)
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(a, b)
    for x in got[-1][1:]:
        np.testing.assert_array_equal(got[-1][0], x)
    assert all(a.rounds_completed >= 3 for a in avgs)
