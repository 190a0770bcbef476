"""Cross-process asynchronous parameter averaging over the control plane.

Counterpart of ``distributed_tensorflow_tpu/cluster/param_sync.py``, and
interoperable with it on the wire: the same keys, the same blob format,
the same tree fingerprint and the same bytes for the same tree, so JAX and
PyTorch workers of one run average together.  Two things differ from the
JAX module:

- **Trees.**  Where JAX walks pytrees, this module walks nested dicts
  (and lists/tuples) in ``jax.tree.leaves`` order: dict keys sorted at
  every level (:mod:`..utils.pytree`).  Callers pass the flax-named tree
  (``training.state.checkpoint_tree``'s ``params``), never a module's
  ``state_dict``, whose order and names differ.
- **bfloat16.**  A bf16 leaf is held as its 16-bit words
  (:class:`BF16`, a ``uint16`` array), never through ``ml_dtypes``; its
  fingerprint string is ``<V2``, as JAX's, and every cast to bf16 rounds
  to nearest even with ``ml_dtypes``' NaN rule (:func:`f32_to_bf16`).
  A numpy array of another package's bf16 dtype (``dtype.name ==
  "bfloat16"``) is accepted as well.

The JAX module's description follows.


The reference's async mode is Hogwild through the parameter server: every
worker pushes and pulls at its own cadence, and the parameters survive
worker death on the PS (reference ``distributed.py:102``; SURVEY N2/N4).
TPU-natively the data plane moved into HBM + ICI collectives — but ICI
collectives are lockstep.  For *independent-cadence* async across worker
processes, this module re-creates the PS exchange at the control plane:

- each worker periodically publishes its (locally merged) parameters to the
  coordination service's KV store and averages in whatever peers have
  published — no barrier, bounded staleness, workers never wait on each
  other (the reference's stale-update semantics, without the races);
- published parameters survive on the service across worker restarts (and —
  with the coordinator's KV journal — across coordinator restarts too), so a
  rejoining worker pulls the collective's current state — the PS-durability
  role the reference relied on.

Payloads travel in the parameters' OWN dtype: a bf16 model moves half the
bytes a float32 encoding would (the r3 float32 pin doubled every bf16
exchange), and averaging upcasts to float32 per leaf before casting back.
The wire format is the concatenation of each leaf's native bytes; the
READER's template supplies dtypes/shapes.  Structural mismatches (a peer
running a different model or dtype — including same-byte-length
collisions) are detected via a per-publication ``tree_fingerprint``
carried on a ``<key>.fp`` side entry: the first mismatch logs one loud
ERROR naming the peer, after which the peer is skipped quietly until its
fingerprint matches again.  Payloads from pre-fingerprint publishers
(no ``.fp`` entry) fall back to the byte-length check alone.

Size: two transports, chosen per publication by payload size:

- **KV chunks** (small models, no shared-FS assumption): zlib-compressed
  native bytes, base64, chunked across KV entries with a meta entry written
  last as the commit point — model size bounded by coordinator memory, not
  the wire protocol's request-line cap.
- **Logdir binary side-channel** (``exchange_dir`` set and raw bytes ≥
  ``binary_threshold``): the flat native-dtype buffer is written to a
  sequence-numbered file in the shared run directory (the same shared-FS
  assumption checkpoints already make), committed by a KV pointer entry
  (``v2bin``) carrying length + CRC.  The coordinator socket then moves a
  ~60-byte pointer instead of gigabytes of base64 — this is what lets a
  100M+-parameter transformer exchange at disk bandwidth, matching the
  reference PS which moved full models every step (``distributed.py:145``).

Either way a torn read (meta/chunk/file mismatch while a peer republishes)
fails the checksum and that peer is skipped for the round; binary files are
sequence-numbered so a writer never truncates a file a reader may hold
open, and the last ``BINARY_GC_KEEP`` sequences are retained so a reader
whose pointer-fetch-to-file-read gap spans publish periods still finds its
file.  Skipped peers are counted (``fetch_skips``) and logged, so silent
participation loss is visible in worker output.

Traffic: the full-state exchange above moves O(N·P) native-dtype bytes
per period per worker.  :class:`CompressedShardedAverager` replaces the
steady state with a three-stage compressed, sharded protocol — delta
encoding against an agreed consensus, error-feedback int8/bf16
quantization with per-block scales (EQuARX, arXiv:2506.17615), and a
reduce-scatter of the flat buffer across the active membership (Xu et
al., arXiv:2004.13336) — cutting the wire to O(2·P/N) quantized bytes,
with the full-state path retained as the bootstrap fallback and the
periodic anchor.  docs/param_exchange.md specifies the wire format.
"""

from __future__ import annotations

import base64
import contextlib
import os
import struct
import time
import zlib
from typing import Any

import numpy as np

from ..parallel.sync import (contiguous_shard_bounds, slice_exporters,
                             slice_of_task, slice_topology)
from ..utils import faults, tracing
from ..utils.pytree import tree_flatten, tree_leaves, tree_map, tree_unflatten

KEY_FORMAT = "dtf/async_params/{}/task{}"
# Chunk size in base64 chars: comfortably under the coordinator's 8 MiB
# request-line cap and the client's initial response buffer.
CHUNK_CHARS = 512 * 1024
# Raw bytes at which publications switch to the binary side-channel (when
# the averager has an exchange_dir): past this, base64-through-one-socket
# is the bottleneck, not the model math.
BINARY_THRESHOLD_BYTES = 8 << 20
# Sequences of a task's binary files kept on disk; older ones are GC'd at
# publish time.  3 (current + two predecessors) tolerates a reader whose
# kv_get-to-read gap spans two publish periods on a slow shared FS.
BINARY_GC_KEEP = 3


class BF16(np.ndarray):
    """bfloat16 values held as their 16-bit words: a ``uint16`` array
    marked as bf16 (the host form of a bf16 leaf without ``ml_dtypes``).
    ``BF16(words)`` views ``uint16`` words; :func:`f32_to_bf16` and
    :func:`bf16_to_f32` convert values."""

    def __new__(cls, words):
        return np.require(words, np.uint16, "C").view(cls)


#: numpy's string for JAX's bf16 dtype (``ml_dtypes.bfloat16``), which the
#: tree fingerprint carries.
BF16_DTYPE_STR = "<V2"


def is_bf16(leaf) -> bool:
    """A bf16 leaf: :class:`BF16` words, or a numpy array of another
    package's bf16 dtype."""
    return isinstance(leaf, BF16) or getattr(
        getattr(leaf, "dtype", None), "name", "") == "bfloat16"


#: Elements a pass of the bf16 casts works on at a time: the scratch
#: stays in cache, so a GB-scale cast reads and writes memory once.
_CAST_CHUNK = 1 << 18


def _round_words(u: np.ndarray, r: np.ndarray) -> None:
    """``r`` = float32 bits ``u`` rounded to their upper 16 bits, nearest
    even (NaNs aside)."""
    np.right_shift(u, 16, out=r)
    r &= 1
    r += 0x7FFF
    r += u
    r >>= 16


def _quiet_nans(values: np.ndarray, words: np.ndarray) -> None:
    """Set the words of NaN values to the quiet NaN of their sign."""
    nan = np.isnan(values)
    if nan.any():
        words[nan] = np.where(values.view(np.uint32)[nan] >> 31,
                              0xFFC0, 0x7FC0)


def f32_to_bf16(values: np.ndarray) -> BF16:
    """Round float32 values to bf16 words: nearest even, a NaN to the quiet
    NaN of its sign (0x7fc0 / 0xffc0), as ``ml_dtypes`` casts."""
    v = np.asarray(values, np.float32)
    flat = np.ascontiguousarray(v.reshape(-1))
    u = flat.view(np.uint32)
    words = np.empty(flat.size, np.uint16)
    r = np.empty(min(_CAST_CHUNK, flat.size), np.uint32)
    for lo in range(0, flat.size, _CAST_CHUNK):
        hi = min(lo + _CAST_CHUNK, flat.size)
        _round_words(u[lo:hi], r[:hi - lo])
        words[lo:hi] = r[:hi - lo]
    _quiet_nans(flat, words)
    return BF16(words.reshape(v.shape))


def bf16_to_f32(words: np.ndarray) -> np.ndarray:
    """bf16 words (or another package's bf16 array) -> float32, exactly."""
    w = np.asarray(words).view(np.uint16)
    out = np.empty(w.shape, np.uint32)
    out[...] = w
    out <<= 16
    return out.view(np.float32)


def _mean_bf16(xs) -> BF16:
    """The float32 mean of bf16 leaves, rounded to bf16 words: each value
    widened exactly, summed in order and divided in float32, as JAX's
    ``_mean_leaves`` computes it with ``ml_dtypes``; a chunk at a time."""
    words = [np.ascontiguousarray(x).view(np.uint16).reshape(-1) for x in xs]
    n = words[0].size
    out = np.empty(n, np.uint16)
    acc = np.empty(min(_CAST_CHUNK, n), np.float32)
    tmp = np.empty(acc.size, np.uint32)
    for lo in range(0, n, _CAST_CHUNK):
        hi = min(lo + _CAST_CHUNK, n)
        a, t = acc[:hi - lo], tmp[:hi - lo]
        au = a.view(np.uint32)
        au[:] = words[0][lo:hi]
        au <<= 16
        for w in words[1:]:
            t[:] = w[lo:hi]
            t <<= 16
            a += t.view(np.float32)
        a /= len(xs)
        _round_words(au, t)
        out[lo:hi] = t
        _quiet_nans(a, out[lo:hi])
    return BF16(out.reshape(np.shape(xs[0])))


def _host(leaf):
    """A leaf as a contiguous host array, bf16 kept as :class:`BF16`."""
    if isinstance(leaf, BF16):
        return np.ascontiguousarray(leaf).view(BF16)
    try:
        import torch
    except ImportError:  # pragma: no cover - the port always has torch
        torch = None
    if torch is not None and isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return BF16(t.view(torch.int16).numpy().view(np.uint16))
        return np.ascontiguousarray(t.numpy())
    return np.ascontiguousarray(np.asarray(leaf))


def _to_f32(leaf) -> np.ndarray:
    """A float leaf's values as float32."""
    if is_bf16(leaf):
        return bf16_to_f32(leaf)
    return np.asarray(leaf).astype(np.float32, copy=False)


def _from_f32(values: np.ndarray, like):
    """float32 values cast to ``like``'s dtype (:class:`BF16` words for a
    bf16 leaf of this module's form)."""
    if isinstance(like, BF16):
        return f32_to_bf16(values)
    return values.astype(np.asarray(like).dtype)


def _leaf_meta(leaf) -> tuple[np.dtype | str, tuple, int]:
    """(dtype, shape, nbytes) without materializing device leaves; a bf16
    leaf's dtype is its fingerprint string ``<V2``."""
    shape = tuple(int(s) for s in getattr(leaf, "shape", ()))
    n = 1
    for s in shape:
        n *= s
    name = str(getattr(leaf, "dtype", ""))
    if is_bf16(leaf) or name == "torch.bfloat16":
        return BF16_DTYPE_STR, shape, 2 * n
    if name.startswith("torch."):          # a tensor leaf: numpy's name
        dt = np.dtype(name[len("torch."):])
    else:
        dt = np.dtype(leaf.dtype) if hasattr(leaf, "dtype") else np.dtype(
            type(leaf))
    return dt, shape, n * dt.itemsize


def _dtype_str(dt) -> str:
    return dt if isinstance(dt, str) else dt.str


def tree_fingerprint(params: Any) -> str:
    """8-hex digest of the tree's per-leaf (dtype, shape) sequence.

    Carried in the publication meta so a peer running a different model or
    dtype (e.g. a mixed-version worker still publishing float32 of a bf16
    model) is diagnosed with one clear error instead of being silently
    byte-length-skipped every round (ADVICE r4).
    """
    metas = "|".join(f"{_dtype_str(dt)}{shape}"
                     for dt, shape, _ in map(_leaf_meta,
                                             tree_leaves(params)))
    return format(zlib.crc32(metas.encode()), "08x")


def _flatten(params: Any) -> np.ndarray:
    """Concatenated native-dtype bytes of the tree's leaves (uint8)."""
    leaves = [np.asarray(_host(l)) for l in tree_leaves(params)]
    if not leaves:
        return np.zeros((0,), np.uint8)
    bufs = [l.reshape(-1).view(np.uint8) for l in leaves]
    if len(bufs) == 1:
        return bufs[0]  # GB-scale single-leaf trees skip the concat copy
    return np.concatenate(bufs)


def _unflatten(buf: np.ndarray, template: Any) -> Any | None:
    """Rebuild a tree shaped/typed like ``template`` from native bytes;
    None when the byte length doesn't match (peer published a different
    model/dtype — skip it)."""
    leaves, treedef = tree_flatten(template)
    metas = [_leaf_meta(l) for l in leaves]
    if buf.nbytes != sum(m[2] for m in metas):
        return None
    out, pos = [], 0
    for leaf, (dt, shape, nb) in zip(leaves, metas):
        piece = buf[pos:pos + nb]
        if dt == BF16_DTYPE_STR:
            piece = (piece.view(np.uint16).view(BF16)
                     if not is_bf16(np.asarray(leaf)) else
                     piece.view(np.asarray(leaf).dtype))
        else:
            piece = piece.view(dt)
        out.append(piece.reshape(shape))
        pos += nb
    return tree_unflatten(treedef, out)


def _encode_flat(flat: np.ndarray) -> str:
    # zlib/base64 accept the array's buffer directly: no .tobytes() copy of
    # the whole flat tree before compression (at GB scale that copy was a
    # second full-size host buffer on the hot path).
    return base64.b64encode(zlib.compress(flat.data, 1)).decode()


def _encode(params: Any) -> str:
    return _encode_flat(_flatten(params))


def _decode(value: str, template: Any) -> Any | None:
    try:
        raw = zlib.decompress(base64.b64decode(value))
    except Exception:
        return None
    return _unflatten(np.frombuffer(raw, np.uint8), template)


def _mean_leaves(*xs):
    """Average in float32, return in the leaves' own dtype.  Accumulates
    in place (one f32 buffer) rather than stacking — at GB-scale trees a
    stack of N f32 upcasts would multiply peak host memory by N."""
    if isinstance(xs[0], BF16):
        return _mean_bf16(xs)
    dt = xs[0].dtype
    acc = np.array(xs[0], np.float32)  # always a fresh buffer
    for x in xs[1:]:
        # Buffered mixed-dtype add: the ufunc streams the bf16->f32 cast
        # through cache-sized chunks instead of materializing another
        # full-size f32 temp per peer (~2x faster and allocation-stable
        # at GB-scale trees).
        np.add(acc, x, out=acc)
    acc /= len(xs)
    return acc.astype(dt)


def publish_chunked(coord, base_key: str, payload: str,
                    chunk_chars: int = CHUNK_CHARS, fp: str = "") -> int:
    """Write ``payload`` as ``<base>.c<i>`` chunks, then the ``<base>`` meta
    entry (``v1 <nchunks> <len> <crc32>``) as the commit point.  Returns the
    chunk count.

    ``fp`` (the publisher's ``tree_fingerprint``) rides a SEPARATE
    ``<base>.fp`` key, written before the meta commit point, NOT appended
    to the meta line: readers that predate the fingerprint parse the meta
    with strict field counts, and extending it would make every new
    publication unreadable to them — the rolling-upgrade scenario the
    fingerprint exists to diagnose."""
    nchunks = max(1, -(-len(payload) // chunk_chars))
    for i in range(nchunks):
        coord.kv_set(f"{base_key}.c{i}",
                     payload[i * chunk_chars:(i + 1) * chunk_chars])
    # Unconditional (empty fp clears a predecessor's entry): a stale .fp
    # left behind by an upgraded incarnation would otherwise permanently
    # exclude a downgraded-but-matching publisher.
    coord.kv_set(f"{base_key}.fp", fp)
    crc = zlib.crc32(payload.encode())
    coord.kv_set(base_key, f"v1 {nchunks} {len(payload)} {crc:08x}")
    return nchunks


def fetch_chunked(coord, base_key: str, meta: str | None = None
                  ) -> str | None:
    """Read a chunked payload; None when absent or torn (checksum/length
    mismatch against the meta entry).  ``meta``: the already-fetched meta
    entry, to save the extra coordinator round-trip."""
    if meta is None:
        meta = coord.kv_get(base_key)
    if meta is None:
        return None
    parts = meta.split()
    if len(parts) != 4 or parts[0] != "v1":
        return None
    try:
        nchunks, total, crc = int(parts[1]), int(parts[2]), int(parts[3], 16)
    except ValueError:
        return None
    chunks = []
    for i in range(nchunks):
        chunk = coord.kv_get(f"{base_key}.c{i}")
        if chunk is None:
            return None
        chunks.append(chunk)
    payload = "".join(chunks)
    if len(payload) != total or zlib.crc32(payload.encode()) != crc:
        return None
    return payload


def publish_binary(coord, base_key: str, flat: np.ndarray, exchange_dir: str,
                   task: int, seq: int,
                   gc_keep: int = BINARY_GC_KEEP, fp: str = "") -> str:
    """Write ``flat`` (native-dtype bytes, uint8) to
    ``<exchange_dir>/task{task}.{seq}.bin`` (atomic tmp+rename) and
    KV-commit a ``v2bin`` pointer with length + CRC (``fp`` rides the
    side ``<base>.fp`` key — see ``publish_chunked``).  Returns the file
    name.  The newest ``gc_keep`` sequences for this task survive; older
    files are garbage-collected — a reader holding a recent pointer can
    still finish its read even if it lags a couple of publish periods."""
    os.makedirs(exchange_dir, exist_ok=True)
    fname = f"task{task}.{seq}.bin"
    tmp = os.path.join(exchange_dir, fname + ".tmp")
    # No fsync: publications are throwaway state, not checkpoints.  The
    # close() below is what shared filesystems key visibility on
    # (close-to-open consistency), and the KV pointer's CRC rejects a
    # file whose data never survived a host crash — the reader skips that
    # peer for a round, which is this module's documented degradation
    # mode anyway.  An fsync here would serialize every publish on disk
    # bandwidth (~13 s/GB on a commodity disk) for durability nobody uses.
    with open(tmp, "wb") as fh:
        flat.tofile(fh)
    os.replace(tmp, os.path.join(exchange_dir, fname))
    coord.kv_set(f"{base_key}.fp", fp)  # unconditional — see publish_chunked
    crc = zlib.crc32(flat.data)
    coord.kv_set(base_key, f"v2bin {fname} {flat.nbytes} {crc:08x} {seq}")
    for old in os.listdir(exchange_dir):
        if not old.startswith(f"task{task}."):
            continue
        try:
            old_seq = int(old.split(".")[1])
        except (IndexError, ValueError):
            continue
        if old_seq <= seq - gc_keep:
            try:
                os.unlink(os.path.join(exchange_dir, old))
            except OSError:
                pass
    return fname


def fetch_binary(meta: str, exchange_dir: str) -> np.ndarray | None:
    """Resolve a ``v2bin`` pointer to its flat byte buffer (uint8); None
    when the file is missing/torn (length or CRC mismatch)."""
    parts = meta.split()
    if len(parts) != 5 or parts[0] != "v2bin":
        return None
    fname, nbytes, crc_hex = parts[1], parts[2], parts[3]
    if os.sep in fname or fname.startswith("."):
        return None  # pointer must stay inside the exchange dir
    path = os.path.join(exchange_dir, fname)
    try:
        flat = np.fromfile(path, np.uint8)
    except OSError:
        return None
    try:
        if flat.nbytes != int(nbytes) or zlib.crc32(flat.data) != int(
                crc_hex, 16):
            return None
    except ValueError:
        return None
    return flat


class ParamAverager:
    """Publish/average merged parameters through the coordination KV.

    ``namespace`` scopes the KV keys to one run (callers pass a digest of
    the run's logdir): a restarted worker of the SAME run rejoins its
    collective, while a fresh run against a still-running coordination
    service never adopts a dead run's weights.

    ``exchange_dir`` (usually ``<logdir>/async_exchange``) enables the
    binary side-channel for payloads of at least ``binary_threshold`` raw
    bytes; without it every publication rides the KV.  Readers handle both
    formats regardless — the WRITER's size decides the transport.

    Parameters keep their dtype end to end: a bf16 tree publishes bf16
    bytes (half the float32 volume) and the averaged result comes back
    bf16, with the mean computed in float32 per leaf.
    """

    def __init__(self, coord, task_index: int, num_workers: int,
                 namespace: str = "default",
                 exchange_dir: str | None = None,
                 binary_threshold: int = BINARY_THRESHOLD_BYTES,
                 print_fn=print):
        self._coord = coord
        self._task = task_index
        self._num_workers = num_workers
        self._ns = namespace
        self._dir = exchange_dir
        self._threshold = binary_threshold
        self._print = print_fn
        # Resume the sequence from files a previous incarnation left behind:
        # a restart starting over at 0 would strand the old high-sequence
        # files (model-size each) outside GC's reach for ~500 periods.
        self._seq = 0
        if exchange_dir is not None and os.path.isdir(exchange_dir):
            prefix = f"task{task_index}."
            for f in os.listdir(exchange_dir):
                if not f.startswith(prefix):
                    continue
                try:
                    if f.endswith(".bin"):
                        self._seq = max(self._seq, int(f.split(".")[1]))
                    elif f.endswith(".blob"):
                        # task<t>.<tag>.<seq>.blob (compressed exchange)
                        self._seq = max(self._seq,
                                        int(f.rsplit(".", 2)[1]))
                except (IndexError, ValueError):
                    pass
        #: transport and MB/s of the last publish (observability/bench)
        self.last_publish_transport = ""
        self.last_publish_mb_per_sec = 0.0
        #: bytes-on-wire accounting (docs/param_exchange.md): payload bytes
        #: this worker moved in its last exchange (out = published, in =
        #: fetched) and cumulatively — the quantity the compressed protocol
        #: exists to shrink and the bench/CI gate assert on.
        self.last_bytes_out = 0
        self.last_bytes_in = 0
        self.total_bytes_out = 0
        self.total_bytes_in = 0
        #: intra-slice (ICI/shared-memory-class) bytes of the last
        #: exchange — hierarchical mode only; NEVER part of the inter-host
        #: wire accounting above (docs/param_exchange.md, "Hierarchical
        #: exchange").
        self.last_intra_bytes = 0
        self.total_intra_bytes = 0
        self._wire_scope = "inter"
        #: full-state-equivalent bytes / bytes-on-wire of the last exchange
        #: (1.0-ish for the uncompressed path; >= 4 is the compressed
        #: protocol's acceptance bar).  None before the first exchange.
        self.last_ratio: float | None = None
        self._telemetry = None
        # One-shot extra fields for the next telemetry record (the
        # compressed subclass tags its full-state fallbacks this way
        # without emitting a second record).
        self._note_extra: dict[str, Any] = {}
        #: per-peer count of rounds skipped on a torn/missing payload —
        #: persistent skipping (ADVICE r3) shows up here and in the log
        self.fetch_skips: dict[int, int] = {}
        # Peers already diagnosed with a tree-fingerprint mismatch: the
        # structural error prints ONCE per peer (it will never heal on its
        # own), then the peer is skipped quietly.
        self._fp_mismatch_reported: set[int] = set()

    def _key(self, task: int) -> str:
        return KEY_FORMAT.format(self._ns, task)

    def attach_telemetry(self, telemetry) -> None:
        """Route per-exchange observability (``kind="param_exchange"``
        records, ``exchange_bytes``/``exchange_ratio`` gauges) through the
        run's telemetry bus (docs/param_exchange.md)."""
        self._telemetry = telemetry

    def _count_wire(self, direction: str, nbytes: int) -> None:
        if self._wire_scope == "intra":
            # Intra-slice hop of the hierarchical exchange: ICI-class
            # traffic, accounted apart from the inter-host wire bytes the
            # compressed protocol exists to shrink.
            self.last_intra_bytes += nbytes
            self.total_intra_bytes += nbytes
            return
        if direction == "out":
            self.last_bytes_out += nbytes
            self.total_bytes_out += nbytes
        else:
            self.last_bytes_in += nbytes
            self.total_bytes_in += nbytes

    @contextlib.contextmanager
    def _intra(self):
        """Route :meth:`_count_wire` to the intra-slice books inside."""
        prev, self._wire_scope = self._wire_scope, "intra"
        try:
            yield
        finally:
            self._wire_scope = prev

    def _note_exchange(self, *, peers: int, native_bytes: int,
                       compressed: bool, dur_ms: float,
                       **fields: Any) -> None:
        """Per-exchange accounting + telemetry record.  ``native_bytes`` is
        the tree's size in its own dtype; ``full_state_bytes`` is what the
        UNCOMPRESSED full-state exchange would have moved this period on
        the same transport — (1 publish + ``peers`` fetches) of the native
        bytes, with the KV path's base64 framing included so compressed
        and full-state wire bytes compare like for like."""
        wire = self.last_bytes_out + self.last_bytes_in
        if self._dir is not None and native_bytes >= self._threshold:
            unit = native_bytes            # binary side-channel: raw bytes
        else:
            unit = (native_bytes * 4 + 2) // 3   # KV: base64 chars
        full = unit * (1 + max(peers, 0))
        self.last_ratio = (full / wire) if wire else None
        extra, self._note_extra = self._note_extra, {}
        fields = {**extra, **fields}
        tel = self._telemetry
        if tel is None:
            return
        tel.gauge("exchange_bytes").set(wire)
        if self.last_ratio is not None:
            tel.gauge("exchange_ratio").set(round(self.last_ratio, 3))
        if fields.get("hierarchical"):
            # Hierarchical mode: surface the inter-host share and the
            # slice id live (the training loop folds these gauges into
            # the STATPUT summary, so tools/watch_run.py can flag a
            # worker silently falling back to the flat exchange).
            tel.gauge("exchange_inter_bytes").set(
                fields.get("inter_bytes", wire))
            if fields.get("slice") is not None:
                tel.gauge("exchange_slice").set(fields["slice"])
        else:
            # Flat/fallback period: CLEAR the placement gauges (-1 = the
            # "absent" sentinel the loop filters on).  Leaving the last
            # hierarchical values in place would keep stamping a stale
            # slice id into the live stats, and watch_run's flat-fallback
            # detector — which keys on the slice being ABSENT — could
            # never fire for exactly the worker it exists to catch.
            tel.gauge("exchange_inter_bytes").set(-1)
            tel.gauge("exchange_slice").set(-1)
        tel.counter("exchange_bytes_total").inc(wire)
        tel.histogram("exchange_ms").record(dur_ms)
        tel.emit("param_exchange", step=0, peers=peers,
                 bytes_out=self.last_bytes_out, bytes_in=self.last_bytes_in,
                 bytes_on_wire=wire, full_state_bytes=full,
                 ratio=(round(self.last_ratio, 3)
                        if self.last_ratio is not None else None),
                 compressed=compressed, dur_ms=round(dur_ms, 3), **fields)

    def _publish(self, host_merged: Any, fp: str | None = None) -> None:
        flat = _flatten(host_merged)
        if fp is None:
            fp = tree_fingerprint(host_merged)
        t0 = time.perf_counter()
        if self._dir is not None and flat.nbytes >= self._threshold:
            self._seq += 1
            publish_binary(self._coord, self._key(self._task), flat,
                           self._dir, self._task, self._seq, fp=fp)
            self.last_publish_transport = "binary"
            self._count_wire("out", flat.nbytes)
        else:
            payload = _encode_flat(flat)
            publish_chunked(self._coord, self._key(self._task), payload,
                            fp=fp)
            self.last_publish_transport = "kv"
            self._count_wire("out", len(payload))
        dt = time.perf_counter() - t0
        self.last_publish_mb_per_sec = (flat.nbytes / 1e6 / dt) if dt else 0.0

    def _fetch_peer(self, task: int, template: Any,
                    my_fp: str | None = None) -> Any | None:
        meta = self._coord.kv_get(self._key(task))
        if meta is None:
            return None  # peer hasn't published yet — normal, not a skip
        peer_fp = self._coord.kv_get(self._key(task) + ".fp")
        if peer_fp:  # empty/absent -> pre-fingerprint publisher, no check
            mine = my_fp if my_fp is not None else tree_fingerprint(template)
            if peer_fp != mine:
                # Structural mismatch (different model or dtype on the
                # wire): a torn read heals next round, this doesn't — say
                # so loudly ONCE per mismatch episode, then skip quietly.
                if task not in self._fp_mismatch_reported:
                    self._fp_mismatch_reported.add(task)
                    self._print(
                        f"[param_sync] ERROR: peer {task} publishes a "
                        f"different parameter tree (fingerprint {peer_fp} "
                        f"vs local {mine}) — mixed model/dtype versions in "
                        f"one run; this peer will be excluded from "
                        f"averaging until it matches")
                self.fetch_skips[task] = self.fetch_skips.get(task, 0) + 1
                return None
            # Healed (restarted with the right model): arm the one-time
            # error again so a LATER mismatch is a new loud episode.
            self._fp_mismatch_reported.discard(task)
        if meta.startswith("v2bin"):
            if self._dir is None:
                peer = None
            else:
                flat = fetch_binary(meta, self._dir)
                if flat is not None:
                    self._count_wire("in", flat.nbytes)
                peer = None if flat is None else _unflatten(flat, template)
        else:
            value = fetch_chunked(self._coord, self._key(task), meta=meta)
            if value is not None:
                self._count_wire("in", len(value))
            peer = None if value is None else _decode(value, template)
        if peer is None:
            # Published but unreadable (torn mid-republish, GC'd file,
            # shape/dtype mismatch): count and say so — persistent skipping
            # quietly shrinks averaging participation otherwise.
            n = self.fetch_skips.get(task, 0) + 1
            self.fetch_skips[task] = n
            self._print(f"[param_sync] task {self._task}: skipping peer "
                        f"{task} this round (unreadable payload, "
                        f"{n} skips total)")
        return peer

    def exchange(self, merged: Any, alive=None) -> tuple[Any, int]:
        """Publish ``merged`` (host-side average of local replicas), pull
        live peers' publications, and return
        ``(averaged_params, num_peers_included)``.

        Peers that haven't published yet (slower cadence, just restarted)
        are simply absent — nobody blocks; that IS the async contract.
        ``alive`` (per-task liveness bits from the heartbeat health cache)
        excludes dead/finished peers, whose frozen snapshots would otherwise
        anchor the average forever.
        """
        t0 = time.perf_counter()
        self.last_bytes_out = self.last_bytes_in = 0
        self.last_intra_bytes = 0
        host_merged = tree_map(_host, merged)
        my_fp = tree_fingerprint(host_merged)
        self._publish(host_merged, fp=my_fp)
        contributions = [host_merged]
        for task in range(self._num_workers):
            if task == self._task:
                continue
            if alive is not None and task < len(alive) and not alive[task]:
                continue
            peer = self._fetch_peer(task, host_merged, my_fp=my_fp)
            if peer is not None:
                contributions.append(peer)
        n = len(contributions)
        native_bytes = sum(m[2] for m in map(_leaf_meta,
                                             tree_leaves(host_merged)))
        self._note_exchange(peers=n - 1, native_bytes=native_bytes,
                            compressed=False,
                            dur_ms=(time.perf_counter() - t0) * 1000.0,
                            transport=self.last_publish_transport)
        if n == 1:
            return merged, 0
        avg = tree_map(_mean_leaves, *contributions)
        return avg, n - 1

    #: A rejoining worker reads a live peer's publication once; a read
    #: torn by the peer's republish (its meta, then chunks of the next
    #: publication) is read again, up to PULL_ATTEMPTS times PULL_RETRY_S
    #: apart (one publish period, at the trainer's pace, is well inside).
    PULL_ATTEMPTS = 50
    PULL_RETRY_S = 0.02

    def _fetch_settled(self, task: int, template: Any, my_fp: str):
        """:meth:`_fetch_peer`, read again while the peer has published
        but its payload reads torn (not when it has not published, nor on
        a fingerprint mismatch)."""
        for _ in range(self.PULL_ATTEMPTS - 1):
            peer = self._fetch_peer(task, template, my_fp=my_fp)
            if (peer is not None or task in self._fp_mismatch_reported
                    or self._coord.kv_get(self._key(task)) is None):
                return peer
            time.sleep(self.PULL_RETRY_S)
        return self._fetch_peer(task, template, my_fp=my_fp)

    def pull_latest(self, template: Any) -> Any | None:
        """Average of everything published in this run's namespace
        (restart-and-rejoin: a rejoining worker adopts the collective's
        state instead of step 1 — stale entries are exactly the durability
        this provides, so liveness is deliberately NOT checked here).  A
        peer that republishes while it is read (a live worker, every
        period) is read again until the read is whole
        (:meth:`_fetch_settled`): one torn read must not start this worker
        from its own initialisation."""
        template = tree_map(_host, template)
        my_fp = tree_fingerprint(template)
        contributions = []
        for task in range(self._num_workers):
            peer = self._fetch_settled(task, template, my_fp)
            if peer is not None:
                contributions.append(peer)
        if not contributions:
            return None
        return tree_map(_mean_leaves, *contributions)


# =====================================================================
# Compressed sharded exchange: delta encoding + error-feedback
# quantization + reduce-scatter over the KV plane (docs/param_exchange.md)
# =====================================================================
#
# The full-state exchange above moves O(N * P) native-dtype bytes per
# period per worker.  The compressed protocol replaces it with three
# stages, cutting the wire to O(2 * P / N) quantized bytes:
#
# 1. **delta** — each worker publishes its parameters as a delta against
#    the last agreed consensus (EQuARX-style per-block-scaled int8, or
#    bf16), with its own quantization error fed back into the next delta
#    through a residual accumulator (error feedback: compression error is
#    retransmitted, never compounded);
# 2. **sharded reduce** — the flat buffer is partitioned into
#    ``len(active)`` contiguous shards keyed off the membership epoch
#    (``parallel.sync.contiguous_shard_bounds``); the owner of shard j
#    (``active[j]``) fetches only shard j of each peer's delta, averages,
#    and publishes ONE frozen reduced record per (epoch, round, shard);
# 3. **assemble** — every worker rebuilds the next consensus from the N
#    frozen reduced shards (identical bytes for every reader, so the
#    consensus chain never diverges), applying it one period stale as a
#    delta correction — the same delayed-averaging math OverlappedAverager
#    already pins.
#
# Full-state records remain the FALLBACK (bootstrap, non-float trees,
# evicted self) and the periodic ANCHOR: the anchor chief (lowest active
# task) publishes the raw-f32 consensus every ``anchor_every`` rounds and
# on every membership-epoch change, so rejoining/elastic workers always
# have an exact bootstrap point and laggards resynchronize.

#: Self-describing blob header: every anchor/delta/reduced record starts
#: with these 12 little-endian u32 fields, so integrity/round/epoch checks
#: never depend on cross-key atomicity in the KV.
BLOB_HEADER = struct.Struct("<12I")
BLOB_MAGIC = 0x44544651  # "DTFQ"
# Version 2 (r13): contributor-mask bits became POSITIONS in the exchange
# group instead of raw task ids (see ``contributor_bit``).  The bump makes
# records from a pre-r13 worker (elastic rejoin on an old build) fail the
# structural check and fall into the existing skip paths, instead of its
# id-keyed mask bits being silently misread as positional — which could
# fake an "included" bit and drop a peer's progress without re-injection.
BLOB_VERSION = 2
KIND_ANCHOR, KIND_DELTA, KIND_REDUCED, KIND_CAST = 1, 2, 3, 4
FMT_RAW_F32, FMT_INT8, FMT_BF16 = 0, 1, 2
#: Per-block scale granularity of the int8 quantizer (elements/block).
DEFAULT_QUANT_BLOCK = 1024
#: Full-state anchor cadence (rounds) — bootstrap/resync points.
DEFAULT_ANCHOR_EVERY = 8
#: Streaming chunk for the blob file writer/reader (compress into the
#: file in pieces; never materialize a second full-size host buffer).
BLOB_IO_CHUNK = 4 << 20

DELTA_KEY = "dtf/async_delta/{}/task{}/s{}"
REDUCED_KEY = "dtf/async_reduced/{}/s{}"
ANCHOR_KEY = "dtf/async_anchor/{}"
# Hierarchical exchange (docs/param_exchange.md, "Hierarchical
# exchange"): a slice member's raw intra-slice delta, and the exporter's
# assembled-consensus broadcast back into the slice.  Both are
# ICI/shared-memory-class traffic — never quantized, never counted as
# inter-host wire bytes.
MEMBER_DELTA_KEY = "dtf/async_member/{}/g{}/task{}"
CAST_KEY = "dtf/async_cast/{}/g{}"
# Per-task tree fingerprint (compressed path): blob headers carry only
# element counts, and a mixed-version peer can match counts with a
# different leaf layout — which would corrupt the shared consensus
# silently.  The same once-loudly-then-skip rule as the legacy path.
FP_KEY = "dtf/async_fp/{}/task{}"


def _float_leaf(leaf) -> bool:
    return is_bf16(leaf) or np.asarray(leaf).dtype.kind == "f"


def contributor_bit(group, task: int) -> int:
    """Contributor-mask bit for ``task`` within its exchange ``group``.

    Bits are POSITIONS in the group's (sorted) member ordering, not raw
    task ids: the u32 mask then covers any <=32-member group whatever the
    ids — which is what lets the hierarchical inter-slice level carry
    exporter task ids from fleets of hundreds (32 slices x 32 members =
    1024 workers) without the flat protocol's id<32 restriction.  Every
    worker derives the same group from the membership epoch, so every
    side computes the same bit."""
    group = tuple(group)
    try:
        idx = group.index(task)
    except ValueError:
        # A task outside its group would alias another member's
        # positional bit — the mask would fake an "included" bit for a
        # DIFFERENT peer and its exclusion re-injection would silently
        # never fire.  That is a caller bug; refuse loudly (the same
        # id-vs-position confusion the BLOB_VERSION=2 bump rejects on
        # the wire).
        raise ValueError(
            f"task {task} is not a member of exchange group {group}")
    return 1 << min(idx, 31)


def _flatten_f32(tree: Any) -> np.ndarray:
    """Concatenated float32 view of a (float-leaved) tree's values."""
    leaves = tree_leaves(tree)
    if not leaves:
        return np.zeros((0,), np.float32)
    return np.concatenate([_to_f32(l).reshape(-1) for l in leaves])


def _unflatten_f32(vec: np.ndarray, template: Any) -> Any:
    """Rebuild a tree shaped/dtyped like ``template`` from a float32
    value vector (each leaf cast back to its own dtype)."""
    leaves, treedef = tree_flatten(template)
    out, pos = [], 0
    for leaf in leaves:
        size = int(np.prod(leaf.shape, dtype=np.int64))
        out.append(_from_f32(vec[pos:pos + size], leaf).reshape(leaf.shape))
        pos += size
    return tree_unflatten(treedef, out)


def quantize_int8(values: np.ndarray, block: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Per-block absmax int8 quantization: ``values`` (float32 ``[n]``) ->
    ``(scales float32 [ceil(n/block)], q int8 [n])`` with
    ``dequant = q * scale_of_block``.  An all-zero block keeps scale 1.0
    (its codes are zero anyway) so dequantization never divides by zero."""
    n = values.size
    if n == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int8)
    nblocks = -(-n // block)
    pad = nblocks * block - n
    v = np.pad(values, (0, pad)) if pad else values
    vb = v.reshape(nblocks, block)
    scales = np.abs(vb).max(axis=1).astype(np.float32) / 127.0
    scales[scales == 0.0] = 1.0
    q = np.rint(vb / scales[:, None]).clip(-127, 127).astype(np.int8)
    return scales, q.reshape(-1)[:n]


def dequantize_int8(scales: np.ndarray, q: np.ndarray,
                    block: int) -> np.ndarray:
    n = q.size
    if n == 0:
        return np.zeros((0,), np.float32)
    pad = scales.size * block - n
    qq = np.pad(q, (0, pad)) if pad else q
    out = qq.reshape(scales.size, block).astype(np.float32) * scales[:, None]
    return out.reshape(-1)[:n]


def encode_shard(values: np.ndarray, *, kind: int, fmt: int, round_: int,
                 epoch: int, shard: int, nshards: int, mask: int,
                 block: int) -> list:
    """Encode a float32 value vector as a self-describing blob: the
    48-byte header, then the format's payload (int8: the per-block f32
    scale array then the codes; bf16: the cast values; raw: exact f32).
    Returns a list of buffers (header, parts...) so large payloads stream
    into the writer without a concat copy."""
    header = BLOB_HEADER.pack(BLOB_MAGIC, BLOB_VERSION, kind, fmt,
                              round_ & 0xFFFFFFFF, epoch & 0xFFFFFFFF,
                              shard, nshards, mask & 0xFFFFFFFF,
                              block, values.size, 0)
    if fmt == FMT_RAW_F32:
        return [header, np.ascontiguousarray(values, np.float32).data]
    if fmt == FMT_INT8:
        scales, q = quantize_int8(values, block)
        return [header, scales.data, q.data]
    if fmt == FMT_BF16:
        bf = np.asarray(f32_to_bf16(values))
        # uint8 view: the buffer protocol has no bf16 format character.
        return [header, bf.view(np.uint8).data]
    raise ValueError(f"unknown shard format {fmt}")


def dequantize_parts(parts: list, fmt: int, block: int) -> np.ndarray:
    """The float32 values a reader of ``encode_shard``'s blob will decode,
    computed straight from the encoded buffers — no full-size join copy
    and no header re-parse.  The error-feedback residual needs the exact
    post-quantization values on every publish, so this sits on the hot
    path (bit-identical to ``decode_shard``: both read the same scale and
    code bytes)."""
    if fmt == FMT_RAW_F32:
        return np.frombuffer(parts[1], "<f4")
    if fmt == FMT_INT8:
        scales = np.frombuffer(parts[1], "<f4")
        q = np.frombuffer(parts[2], np.int8)
        return dequantize_int8(scales, q, block)
    if fmt == FMT_BF16:
        return bf16_to_f32(np.frombuffer(parts[1], np.uint16))
    raise ValueError(f"unknown shard format {fmt}")


def decode_shard(blob: bytes) -> tuple[dict, np.ndarray] | None:
    """Parse a blob back into ``(header_fields, float32 values)``; None on
    any structural problem (wrong magic/version, truncated payload)."""
    if blob is None or len(blob) < BLOB_HEADER.size:
        return None
    (magic, version, kind, fmt, round_, epoch, shard, nshards, mask,
     block, n, _reserved) = BLOB_HEADER.unpack_from(blob)
    if magic != BLOB_MAGIC or version != BLOB_VERSION:
        return None
    body = memoryview(blob)[BLOB_HEADER.size:]
    try:
        if fmt == FMT_RAW_F32:
            vals = np.frombuffer(body, "<f4", count=n).copy()
        elif fmt == FMT_INT8:
            if n and block < 1:
                return None  # malformed header, not a crash
            nblocks = -(-n // block) if n else 0
            scales = np.frombuffer(body, "<f4", count=nblocks)
            q = np.frombuffer(body, np.int8, count=n, offset=nblocks * 4)
            vals = dequantize_int8(scales, q, block)
        elif fmt == FMT_BF16:
            vals = bf16_to_f32(np.frombuffer(body, np.uint16, count=n))
        else:
            return None
    except ValueError:
        return None  # truncated payload
    header = {"kind": kind, "fmt": fmt, "round": round_, "epoch": epoch,
              "shard": shard, "nshards": nshards, "mask": mask,
              "block": block, "n_values": n}
    return header, vals


def write_blob_file(exchange_dir: str, tag: str, seq: int, parts: list,
                    compress: bool = True,
                    chunk: int = BLOB_IO_CHUNK) -> tuple[str, int, int]:
    """Stream ``parts`` (buffers) into ``<dir>/<tag>.<seq>.blob``
    (atomic tmp+rename), compressing chunk-wise INTO the file writer when
    ``compress`` — the payload is never materialized a second time on the
    host, whatever its size.  Returns ``(fname, file_bytes, crc32)`` where
    the CRC covers the file bytes as written (what a reader must verify
    BEFORE decoding)."""
    os.makedirs(exchange_dir, exist_ok=True)
    fname = f"{tag}.{seq}.blob"
    tmp = os.path.join(exchange_dir, fname + ".tmp")
    crc = 0
    written = 0
    # No fsync, same contract as publish_binary: publications are
    # throwaway state; the CRC in the pointer rejects a crash-torn file.
    with open(tmp, "wb") as fh:
        compressor = zlib.compressobj(1) if compress else None

        def emit(piece: bytes):
            nonlocal crc, written
            if piece:
                fh.write(piece)
                crc = zlib.crc32(piece, crc)
                written += len(piece)

        for part in parts:
            mv = memoryview(part).cast("B")
            for off in range(0, len(mv), chunk):
                piece = mv[off:off + chunk]
                emit(compressor.compress(piece) if compressor else piece)
        if compressor is not None:
            emit(compressor.flush())
    os.replace(tmp, os.path.join(exchange_dir, fname))
    return fname, written, crc


def read_blob_file(exchange_dir: str, fname: str, raw_len: int,
                   file_len: int, crc: int, compressed: bool,
                   chunk: int = BLOB_IO_CHUNK) -> bytes | None:
    """Resolve a ``v3blob`` pointer: verify length + CRC of the file bytes
    while streaming them (decompressing chunk-wise into the preallocated
    output), None when missing/torn."""
    if os.sep in fname or fname.startswith("."):
        return None  # pointer must stay inside the exchange dir
    path = os.path.join(exchange_dir, fname)
    out = bytearray(raw_len)
    pos = 0
    seen_crc = 0
    seen_len = 0
    decompressor = zlib.decompressobj() if compressed else None
    try:
        with open(path, "rb") as fh:
            while True:
                piece = fh.read(chunk)
                if not piece:
                    break
                seen_crc = zlib.crc32(piece, seen_crc)
                seen_len += len(piece)
                raw = decompressor.decompress(piece) if decompressor \
                    else piece
                if pos + len(raw) > raw_len:
                    return None
                out[pos:pos + len(raw)] = raw
                pos += len(raw)
    except (OSError, zlib.error):
        return None
    if seen_len != file_len or seen_crc != crc or pos != raw_len:
        return None
    return bytes(out)


class CompressedShardedAverager(ParamAverager):
    """Delta + error-feedback-quantized + sharded parameter exchange.

    Drop-in for :class:`ParamAverager` (same ``exchange``/``pull_latest``
    contract, same transports, wrappable by :class:`OverlappedAverager`),
    but the steady-state wire traffic is the quantized DELTA reduced
    across ``len(active)`` shards instead of N full-precision mirrors —
    see the protocol comment above and docs/param_exchange.md for the
    wire format.

    ``quant``: ``"int8"`` (per-block absmax scales, ``block`` elements
    per scale) or ``"bf16"``.  ``anchor_every``: full-state anchor
    cadence in consensus rounds.  ``epoch_fn`` supplies the membership
    view ``() -> (epoch, active_task_ids)`` (e.g. from
    ``CoordinationClient.members``); shard ownership is keyed ONLY on it,
    never on per-worker health views, so every worker derives the same
    owner map.  Without one, the membership is static (epoch 0, all
    tasks).

    Consistency invariant: reduced records are written ONCE per
    ``(epoch, round, shard)`` by the shard's owner, so every worker
    assembling round k reads identical bytes and the consensus chain is
    exact across the fleet.  A worker whose delta missed a frozen reduce
    re-injects that shard's transmitted values into its residual — its
    progress rides the next round instead of being lost.

    Host memory: three extra float32 model-size buffers (consensus,
    residual, snapshot) beyond the base class.
    """

    #: Largest exchange group the u32 contributor bitmask can name.  The
    #: flat protocol's group is the whole worker set; the hierarchical
    #: subclass exchanges over groups of <= 32 at each LEVEL (32 slices x
    #: 32 members) and raises its own ceiling accordingly.
    MAX_GROUP = 32

    def __init__(self, coord, task_index: int, num_workers: int,
                 namespace: str = "default",
                 exchange_dir: str | None = None,
                 binary_threshold: int = BINARY_THRESHOLD_BYTES,
                 print_fn=print, quant: str = "int8",
                 block: int = DEFAULT_QUANT_BLOCK,
                 anchor_every: int = DEFAULT_ANCHOR_EVERY,
                 epoch_fn=None):
        super().__init__(coord, task_index, num_workers, namespace=namespace,
                         exchange_dir=exchange_dir,
                         binary_threshold=binary_threshold,
                         print_fn=print_fn)
        if quant not in ("int8", "bf16"):
            raise ValueError(f"quant must be 'int8' or 'bf16', got {quant!r}")
        if num_workers > self.MAX_GROUP:
            # The contributor bitmask is a u32 header field; past 32 tasks
            # per exchange group the excluded-delta detection would
            # silently false-negative and drop training progress.  Refuse
            # loudly instead.
            raise ValueError(
                f"compressed sharded exchange supports at most "
                f"{self.MAX_GROUP} workers (contributor bitmask), got "
                f"{num_workers}; use the hierarchical exchange "
                f"(--slice_size) or the full-state exchange "
                f"(--async_compress=off)")
        self._fmt = FMT_INT8 if quant == "int8" else FMT_BF16
        self._block = max(int(block), 1)
        self._anchor_every = max(int(anchor_every), 1)
        self._epoch_fn = epoch_fn
        # Consensus chain state.
        self._consensus: np.ndarray | None = None  # f32 [n]
        self._residual: np.ndarray | None = None   # f32 [n] error feedback
        self._snap: np.ndarray | None = None       # base of my last delta
        self._k = 0                                # consensus round
        self._epoch = -1
        self._active: tuple[int, ...] = tuple(range(num_workers))
        self._pending_reduce: int | None = None
        self._published_round: int | None = None
        self._reduced_done: set[tuple[int, int, int]] = set()
        self._my_reduced: dict[tuple[int, int, int], np.ndarray] = {}
        # Fetched-record caches: delta/reduced records are immutable per
        # (epoch, round, shard) once written, so a round assembled over
        # several periods (peers on slower cadences) fetches each record
        # ONCE — retries cost nothing on the wire.
        self._peer_reduced: dict[tuple[int, int, int],
                                 tuple[np.ndarray, int]] = {}
        self._my_delta: tuple[int, np.ndarray] | None = None
        # Structural-safety state (FP_KEY): my cached fingerprint, whether
        # it is on the KV yet, and the per-peer fingerprints read so far.
        self._fp: str | None = None
        self._fp_published = False
        self._peer_fp: dict[int, str] = {}
        self._warned_nonfloat = False
        #: residual RMS after the last delta publish (telemetry; the
        #: error-feedback health signal — it should stay bounded).
        self.last_residual_rms = 0.0
        #: consensus rounds completed (bench/observability).
        self.rounds_completed = 0
        self.fallback_exchanges = 0
        # 1-based exchange-period index, fed to faults.on_round() at each
        # period's entry — the deterministic injection point for KV-shard
        # chaos (DTF_CHAOS kill_kv_shard=I,at_round=K).  A period counter,
        # not rounds_completed: fallback periods count too, so at_round is
        # reproducible whatever path each period takes.
        self._period_index = 0
        #: per-stage wall-ms decomposition of the last exchange
        #: (intra_reduce / quantize / inter_exchange / broadcast — the
        #: bench's scaling arm and the telemetry record read this).
        self.last_stage_ms: dict[str, float] = {}
        # Last file COMMITTED per blob tag (kv_set of the pointer
        # succeeded): generation GC must never collect it, however many
        # failed-commit orphans pile generations on top — under a sharded
        # coordination plane one instance's kv_sets can fail for a while
        # on their own, and the pointer that instance keeps serving must
        # keep resolving (docs/param_exchange.md, "Hierarchical
        # exchange"; the per-instance-safety regression test).
        self._blob_refs: dict[str, str] = {}
        # Post-failover replay state (docs/fault_tolerance.md, "KV-shard
        # HA").  A dead primary acknowledges KVSET before the standby's
        # pull loop replicates it (lag up to lease/4), so a SIGKILL can
        # lose acknowledged WRITE-ONCE records — and a lost frozen
        # REDUCED record stalls every non-owner's consensus chain for
        # good (the single per-shard key is overwritten next round).
        # Cure: cache the newest payload published under every key and,
        # when the plane's failover count moves, re-publish the lot —
        # records are immutable per (epoch, round, shard), so the replay
        # is idempotent whether or not the write survived.  Memory stays
        # bounded: newest-per-key, quantized parts, same order as the
        # residual/consensus buffers already held.
        self._replay_pub: dict[str, tuple[list, str, bool, str]] = {}
        self._replay_kv: dict[str, str] = {}
        self._plane_failovers_seen = 0
        # Periods to keep my frozen-reduce REPLAYED round visible before
        # the next freeze overwrites its key: stalled peers get this many
        # periods to re-read the round the failover may have eaten.
        self._freeze_hold = 0
        #: completed post-failover replays (observability/tests).
        self.replays_completed = 0

    # ------------------------------------------------------ blob transport

    def _blob_tag(self, what: str) -> str:
        return f"task{self._task}.{what}"

    def _publish_blob(self, base_key: str, parts: list, tag: str,
                      compress: bool = True) -> int:
        """Publish a self-describing blob, transport chosen by size (the
        same rule as full-state publications); returns bytes-on-wire."""
        # Replay cache BEFORE the attempt: a publish whose pointer commit
        # failed outright (instance down) heals on the next replay too.
        # Parts are copied — callers pass views over mutable arrays.
        self._replay_pub[base_key] = (
            [bytes(memoryview(p).cast("B")) for p in parts], tag, compress,
            self._wire_scope)
        raw_len = sum(len(memoryview(p).cast("B")) for p in parts)
        if self._dir is not None and raw_len >= self._threshold:
            self._seq += 1
            fname, file_len, crc = write_blob_file(
                self._dir, tag, self._seq, parts, compress=compress)
            try:
                self._coord.kv_set(
                    base_key, f"v3blob {fname} {raw_len} {file_len} "
                              f"{crc:08x} {self._seq} "
                              f"{'z' if compress else 'r'}")
            except BaseException:
                # Failed commit (e.g. this key's coordination-plane
                # instance is down): the file just written is an orphan no
                # pointer will ever name.  Sweep the tag anyway so repeated
                # failures cannot grow the exchange dir unboundedly — the
                # sweep protects the last COMMITTED pointer's file.
                self._gc_blobs(tag)
                raise
            self._blob_refs[tag] = fname
            self._gc_blobs(tag)
            wire = file_len
            self.last_publish_transport = "sharded-binary"
        else:
            blob = b"".join(bytes(memoryview(p).cast("B")) for p in parts)
            payload = base64.b64encode(zlib.compress(blob, 1)).decode()
            publish_chunked(self._coord, base_key, payload)
            wire = len(payload)
            self.last_publish_transport = "sharded-kv"
        self._count_wire("out", wire)
        return wire

    def _gc_blobs(self, tag: str,
                  gc_keep: int = BINARY_GC_KEEP) -> None:
        # Generation-based, not seq-arithmetic: ``_seq`` is shared across
        # every tag this publisher writes (one bump per shard/reduced/
        # anchor blob), so consecutive generations of one tag differ by
        # more than 1 and ``old_seq <= seq - gc_keep`` would collapse
        # keep-last-3 into keep-only-current.  Keep the newest
        # ``gc_keep`` files of THIS tag, whatever their seq spacing.
        prefix = tag + "."
        try:
            names = os.listdir(self._dir)
        except OSError:
            return
        gens = []
        for old in names:
            if not (old.startswith(prefix) and old.endswith(".blob")):
                continue
            try:
                gens.append((int(old.rsplit(".", 2)[1]), old))
            except (IndexError, ValueError):
                continue
        gens.sort()
        # The last committed pointer's file is sacrosanct whatever its
        # generation: failed commits (a down KV instance under the sharded
        # plane) bump generations without moving the pointer, and the
        # instance that retained the pointer will serve it again.
        committed = self._blob_refs.get(tag)
        for _, old in gens[:-gc_keep]:
            if old == committed:
                continue
            try:
                os.unlink(os.path.join(self._dir, old))
            except OSError:
                pass

    def _fetch_blob(self, base_key: str) -> bytes | None:
        meta = self._coord.kv_get(base_key)
        if meta is None:
            return None
        if meta.startswith("v3blob"):
            parts = meta.split()
            if len(parts) != 7 or self._dir is None:
                return None
            try:
                raw_len, file_len, crc = (int(parts[2]), int(parts[3]),
                                          int(parts[4], 16))
            except ValueError:
                return None
            blob = read_blob_file(self._dir, parts[1], raw_len, file_len,
                                  crc, compressed=(parts[6] == "z"))
            if blob is not None:
                self._count_wire("in", file_len)
            return blob
        value = fetch_chunked(self._coord, base_key, meta=meta)
        if value is None:
            return None
        try:
            blob = zlib.decompress(base64.b64decode(value))
        except Exception:
            return None
        self._count_wire("in", len(value))
        return blob

    def _peer_fp_matches(self, peer: int) -> bool:
        """Once-loudly-then-skip structural gate for a peer's compressed
        records (``FP_KEY``): same rule as the legacy ``_fetch_peer``.  A
        missing fingerprint (peer hasn't published one yet) passes — the
        delta headers still gate round/epoch/size.  Matching values are
        cached; a mismatch is re-read every round so a peer restarted
        with the right model heals."""
        if self._fp is None:
            return True
        theirs = self._peer_fp.get(peer)
        if theirs is None:
            got = self._coord.kv_get(FP_KEY.format(self._ns, peer))
            if not got:
                return True
            self._count_wire("in", len(got))
            theirs = got
        if theirs == self._fp:
            self._peer_fp[peer] = theirs
            self._fp_mismatch_reported.discard(peer)
            return True
        if peer not in self._fp_mismatch_reported:
            self._fp_mismatch_reported.add(peer)
            self._print(
                f"[param_sync] ERROR: peer {peer} publishes a different "
                f"parameter tree (fingerprint {theirs} vs local "
                f"{self._fp}) — mixed model/dtype versions in one run; "
                f"its deltas are excluded from the compressed reduce "
                f"until it matches")
        self.fetch_skips[peer] = self.fetch_skips.get(peer, 0) + 1
        return False

    # ------------------------------------------------------ protocol state

    def _epoch_view(self) -> tuple[int, tuple[int, ...]]:
        if self._epoch_fn is None:
            return max(self._epoch, 0), tuple(range(self._num_workers))
        try:
            epoch, active = self._epoch_fn()
            active = tuple(sorted(t for t in active
                                  if 0 <= t < self._num_workers))
            if not active:
                raise ValueError("empty active set")
            return int(epoch), active
        except Exception:
            # Control-plane hiccup: keep the last agreed view — changing
            # the shard map on a one-sided error would fork ownership.
            return max(self._epoch, 0), self._active

    def _is_chief(self, active) -> bool:
        return bool(active) and min(active) == self._task

    def _anchor_key(self) -> str:
        return ANCHOR_KEY.format(self._ns)

    def _publish_anchor(self, epoch: int) -> None:
        if self._fp is not None:
            # Before the payload: once the anchor is visible, so is the
            # structural fingerprint adopters vet it against.  ``.tfp``,
            # not ``.fp`` — the chunked-KV transport owns ``<key>.fp``
            # and would clear it on every publish.
            self._set_hint(self._anchor_key() + ".tfp", self._fp)
        c = np.ascontiguousarray(self._consensus, np.float32)
        parts = encode_shard(c, kind=KIND_ANCHOR, fmt=FMT_RAW_F32,
                             round_=self._k, epoch=epoch, shard=0,
                             nshards=1, mask=1 << min(self._task, 31),
                             block=0)
        # Raw (not zlib) stream: anchors are full-precision weights —
        # incompressible — and the point of the anchor is exactness.
        self._publish_blob(self._anchor_key(), parts,
                           tag=self._blob_tag("anchor"), compress=False)
        # Cheap hint AFTER the payload commit: readers only use it to
        # decide whether re-fetching the (big) anchor is worth it, so a
        # stale hint costs one period of delay, never consistency.
        self._set_hint(self._anchor_key() + ".hint",
                       f"{self._k} {epoch}")

    def _fetch_anchor(self, n: int) -> tuple[int, np.ndarray] | None:
        afp = self._coord.kv_get(self._anchor_key() + ".tfp")
        if afp:
            self._count_wire("in", len(afp))
        if afp and self._fp is not None and afp != self._fp:
            # Same-size different-layout anchors would corrupt the
            # adopter silently; -1 keys the once-per-episode report.
            if -1 not in self._fp_mismatch_reported:
                self._fp_mismatch_reported.add(-1)
                self._print(
                    f"[param_sync] ERROR: the published anchor carries a "
                    f"different parameter tree (fingerprint {afp} vs "
                    f"local {self._fp}) — mixed model/dtype versions in "
                    f"one run; not adopting it")
            return None
        self._fp_mismatch_reported.discard(-1)
        blob = self._fetch_blob(self._anchor_key())
        decoded = decode_shard(blob) if blob is not None else None
        if decoded is None:
            return None
        hdr, vals = decoded
        if hdr["kind"] != KIND_ANCHOR or hdr["n_values"] != n:
            return None
        return hdr["round"], vals

    def _anchor_hint_round(self) -> int | None:
        hint = self._coord.kv_get(self._anchor_key() + ".hint")
        if not hint:
            return None
        try:
            return int(hint.split()[0])
        except (ValueError, IndexError):
            return None

    # ------------------------------------------------- failover replay

    def _set_hint(self, key: str, value: str) -> None:
        """A replayable version-hint/fingerprint kv_set: recorded in the
        replay cache (newest per key) before hitting the wire."""
        self._replay_kv[key] = value
        self._coord.kv_set(key, value)

    def _check_plane_failover(self) -> None:
        """Once per period, before any freeze: if the coordination plane
        rode a failover since last period, re-publish every cached
        write-once record (the promoted standby may have lost writes the
        dead primary acknowledged inside its replication-lag window) and
        hold my frozen-reduce for a couple of periods so peers stalled on
        a lost round get to re-read the replayed one before the next
        freeze overwrites its key."""
        pf = getattr(self._coord, "plane_failovers", None)
        if pf is None:
            return
        n = pf()
        if n > self._plane_failovers_seen:
            # Replay first, THEN advance the watermark: a replay cut short
            # by a plane still flapping retries next period (idempotent —
            # identical bytes per key).
            replayed = self._replay_published()
            self._plane_failovers_seen = n
            self._freeze_hold = 2
            self.replays_completed += 1
            self._print(
                f"[param_sync] task {self._task}: coordination failover "
                f"detected — replayed {replayed} published record(s) "
                f"(acknowledged writes inside the dead primary's "
                f"replication lag may have been lost); holding frozen "
                f"reduces for {self._freeze_hold} periods")
            if self._telemetry is not None:
                self._telemetry.emit(
                    "recovery", step=0, action="kv_replay",
                    records=replayed, plane_failovers=n)
        elif self._freeze_hold:
            self._freeze_hold -= 1

    def _replay_published(self) -> int:
        """Re-publish the newest cached payload under every key this
        worker has written: tree fingerprints first (readers vet payloads
        against them), then blobs, then the version hints that gate blob
        re-fetches (hint-after-payload, the normal commit discipline)."""
        n = 0
        for key, value in self._replay_kv.items():
            if key.endswith(".tfp"):
                self._coord.kv_set(key, value)
                n += 1
        for key, (parts, tag, compress, scope) in \
                list(self._replay_pub.items()):
            prev, self._wire_scope = self._wire_scope, scope
            try:
                self._publish_blob(key, parts, tag, compress=compress)
            finally:
                self._wire_scope = prev
            n += 1
        for key, value in self._replay_kv.items():
            if not key.endswith(".tfp"):
                self._coord.kv_set(key, value)
                n += 1
        return n

    def _reset_protocol(self) -> None:
        self._pending_reduce = None
        self._published_round = None
        self._reduced_done.clear()
        self._my_reduced.clear()
        self._peer_reduced.clear()
        self._my_delta = None
        self._snap = None
        # Scrub the failover-replay caches: shard/exporter/chief roles are
        # re-keyed by the new active set, so a stale cached REDUCED/CAST/
        # anchor payload replayed later could clobber a key now owned by
        # ANOTHER task.  Keep only my structural fingerprint (its key is
        # mine alone and never re-published by the steady state).
        fp_key = FP_KEY.format(self._ns, self._task)
        fp_val = self._replay_kv.get(fp_key)
        self._replay_pub.clear()
        self._replay_kv.clear()
        if fp_val is not None:
            self._replay_kv[fp_key] = fp_val

    def _sync_epoch(self, epoch: int, active, vec: np.ndarray) -> bool:
        """Adopt the membership epoch's shard map; True when a consensus
        is in hand (anchor adopted, carried over, or chief-published)."""
        epoch_changed = epoch != self._epoch
        self._epoch = epoch
        self._active = active
        if epoch_changed:
            self._reset_protocol()
        n = vec.size
        if self._consensus is not None and self._consensus.size == n:
            if epoch_changed and self._is_chief(active):
                # Epoch-change anchor: survivors re-anchor so evicted/
                # rejoining workers bootstrap against the new shard map.
                self._publish_anchor(epoch)
            return True
        got = self._fetch_anchor(n)
        if got is not None:
            self._k, self._consensus = got[0], got[1].copy()
            return True
        if self._is_chief(active):
            self._consensus = vec.copy()
            self._publish_anchor(epoch)
            return True
        return False

    # --------------------------------------------------------- the stages

    def _publish_delta(self, base: np.ndarray, epoch: int, active) -> None:
        if self._published_round == self._k:
            # This round's delta is already on the wire; local progress
            # since keeps accumulating in the params and rides the NEXT
            # round's delta (republishing fresher bytes peers may never
            # read would roughly double steady-state publish traffic).
            return
        d = base - self._consensus
        d += self._residual
        bounds = contiguous_shard_bounds(d.size, len(active))
        mask = contributor_bit(active, self._task)
        dq = np.empty_like(d)
        for j, (lo, hi) in enumerate(bounds):
            parts = encode_shard(d[lo:hi], kind=KIND_DELTA, fmt=self._fmt,
                                 round_=self._k, epoch=epoch, shard=j,
                                 nshards=len(active), mask=mask,
                                 block=self._block)
            dq[lo:hi] = dequantize_parts(parts, self._fmt, self._block)
            self._publish_blob(
                DELTA_KEY.format(self._ns, self._task, j), parts,
                tag=self._blob_tag(f"d{j}"))
        # Error feedback: what the quantizer dropped rides the NEXT delta.
        self._residual = d - dq
        self.last_residual_rms = float(
            np.sqrt(np.mean(np.square(self._residual)))) if d.size else 0.0
        self._my_delta = (self._k, dq)
        self._snap = base.copy()
        # First publication of this round (the early-return above filters
        # re-entries): peers get a full period to publish theirs before
        # the frozen reduce (next period) runs.
        self._published_round = self._k
        self._pending_reduce = self._k

    def _reduce_round(self, r: int, epoch: int, active, alive) -> None:
        """Freeze the reduced record(s) for the shards this worker owns at
        round ``r``: average every matching delta visible NOW (write-once
        per (epoch, round, shard) — late deltas ride their publishers'
        residuals into the next round instead of forking the record)."""
        if self._consensus is None:
            return
        bounds = contiguous_shard_bounds(self._consensus.size, len(active))
        my_bit = contributor_bit(active, self._task)
        mine = (self._my_delta[1]
                if self._my_delta is not None and self._my_delta[0] == r
                else None)
        for j, (lo, hi) in enumerate(bounds):
            if active[j] != self._task:
                continue
            if (epoch, r, j) in self._reduced_done:
                continue
            contribs, mask = [], 0
            if mine is not None:
                contribs.append(mine[lo:hi])
                mask |= my_bit
            for peer in active:
                if peer == self._task:
                    continue
                if alive is not None and peer < len(alive) \
                        and not alive[peer]:
                    continue
                if not self._peer_fp_matches(peer):
                    continue
                blob = self._fetch_blob(
                    DELTA_KEY.format(self._ns, peer, j))
                decoded = decode_shard(blob) if blob is not None else None
                if decoded is None:
                    continue
                hdr, vals = decoded
                if (hdr["kind"] == KIND_DELTA and hdr["round"] == r
                        and hdr["epoch"] == epoch
                        and hdr["nshards"] == len(active)
                        and hdr["n_values"] == hi - lo):
                    contribs.append(vals)
                    mask |= contributor_bit(active, peer)
            if not contribs:
                # Nothing to freeze yet (own delta lost to a restart and
                # no peer visible): re-arm so the round isn't orphaned.
                self._pending_reduce = r
                continue
            reduced = (contribs[0] if len(contribs) == 1
                       else np.mean(np.stack(contribs), axis=0))
            parts = encode_shard(np.ascontiguousarray(reduced, np.float32),
                                 kind=KIND_REDUCED, fmt=self._fmt,
                                 round_=r, epoch=epoch, shard=j,
                                 nshards=len(active), mask=mask,
                                 block=self._block)
            blob = b"".join(bytes(memoryview(p).cast("B")) for p in parts)
            key = REDUCED_KEY.format(self._ns, j)
            self._publish_blob(key, [blob], tag=self._blob_tag(f"r{j}"))
            # Version hint AFTER the payload commit: peers retrying an
            # assembly check these few bytes instead of refetching a
            # whole stale shard every period.
            self._set_hint(key + ".v", f"{r} {epoch}")
            # Cache my own frozen record (exact published bytes + its
            # contributor mask): assembly must use what peers will read,
            # but re-reading my own write isn't wire.
            self._my_reduced[(epoch, r, j)] = (decode_shard(blob)[1], mask)
            self._reduced_done.add((epoch, r, j))
        # Bound the bookkeeping: rounds older than a few periods can
        # never be assembled again.
        for key in [k for k in self._reduced_done if k[1] < r - 4]:
            self._reduced_done.discard(key)
            self._my_reduced.pop(key, None)
        for key in [k for k in self._peer_reduced if k[1] < r - 4]:
            self._peer_reduced.pop(key, None)

    def _try_assemble(self, vec: np.ndarray, epoch: int, active
                      ) -> tuple[np.ndarray | None, int]:
        """Advance the consensus chain from the frozen reduced shards of
        round ``self._k``; ``(None, 0)`` while any shard is missing."""
        r = self._k
        n = self._consensus.size
        bounds = contiguous_shard_bounds(n, len(active))
        my_bit = contributor_bit(active, self._task)
        shards = []
        for j, (lo, hi) in enumerate(bounds):
            cached = self._my_reduced.get((epoch, r, j))
            if cached is not None:
                shards.append((lo, hi) + cached)
                continue
            peer_cached = self._peer_reduced.get((epoch, r, j))
            if peer_cached is not None:
                shards.append((lo, hi) + peer_cached)
                continue
            # Version hint first: a shard whose owner hasn't frozen this
            # round yet costs a few bytes to discover, not a blob fetch.
            hint = self._coord.kv_get(REDUCED_KEY.format(self._ns, j) + ".v")
            if hint is not None:
                self._count_wire("in", len(hint))
                try:
                    hint_round, hint_epoch = (int(x) for x in hint.split())
                except ValueError:
                    hint_round = hint_epoch = None
                if (hint_round, hint_epoch) != (r, epoch):
                    return None, 0
            blob = self._fetch_blob(REDUCED_KEY.format(self._ns, j))
            decoded = decode_shard(blob) if blob is not None else None
            if decoded is None:
                return None, 0
            hdr, vals = decoded
            if not (hdr["kind"] == KIND_REDUCED and hdr["round"] == r
                    and hdr["epoch"] == epoch
                    and hdr["nshards"] == len(active)
                    and hdr["n_values"] == hi - lo):
                return None, 0
            # Frozen records are immutable: cache so a retried assembly
            # (other shards still missing) never refetches this one.
            self._peer_reduced[(epoch, r, j)] = (vals, hdr["mask"])
            shards.append((lo, hi, vals, hdr["mask"]))
        new_c = self._consensus.copy()
        union = 0
        for lo, hi, vals, mask in shards:
            new_c[lo:hi] += vals
            union |= mask
            if (not (mask & my_bit)
                    and self._my_delta is not None
                    and self._my_delta[0] == r):
                # My delta missed this frozen reduce: re-inject the
                # transmitted values so my progress rides the next round
                # (otherwise adopting the consensus would drop it).
                self._residual[lo:hi] += self._my_delta[1][lo:hi]
        # Delayed averaging with delta correction (the OverlappedAverager
        # equivalence): the consensus step computed from round-r snapshots
        # lands on TODAY's params, preserving local progress since.
        base = self._snap if (self._snap is not None
                              and self._snap.size == n) else self._consensus
        result = vec + (new_c - base)
        self._consensus = new_c
        self._k = r + 1
        self.rounds_completed += 1
        if self._is_chief(active) and self._k % self._anchor_every == 0:
            self._publish_anchor(epoch)
        peers = bin(union & ~my_bit).count("1")
        return result, peers

    def _maybe_adopt_anchor(self, n: int) -> np.ndarray | None:
        """Anchor-miss recovery: a laggard whose round fell behind the
        published anchor resynchronizes by adopting it, shifted by the
        consensus displacement so local progress survives."""
        hint = self._anchor_hint_round()
        if hint is None or hint <= self._k:
            return None
        got = self._fetch_anchor(n)
        if got is None or got[0] <= self._k:
            return None
        round_, anchor = got
        displacement = anchor - self._consensus
        self._k = round_
        self._consensus = anchor.copy()
        self._reset_protocol()
        self._print(f"[param_sync] task {self._task}: resynced to anchor "
                    f"round {round_} (was behind the consensus chain)")
        return displacement

    # ----------------------------------------------------------- the API

    def exchange(self, merged: Any, alive=None) -> tuple[Any, int]:
        """One compressed exchange period: frozen reduce of the pending
        round, consensus assembly, then this period's delta publication —
        falling back to the full-state path whenever the compressed
        protocol cannot run (non-float tree, no consensus reachable
        yet); a worker outside the membership epoch trains solo until
        readmitted (the legacy records are stale after bootstrap).

        A KV-shard failover mid-period is a bounded stall, not a lost
        round (docs/fault_tolerance.md, "KV-shard HA"), on two legs: the
        router's per-shard endpoint walk replays the IN-FLIGHT kv_set
        against the promoted standby, and ``_check_plane_failover``
        replays every ACKNOWLEDGED write-once record next period — the
        dead primary's replication lag (up to lease/4) can eat writes it
        acked, and a lost frozen REDUCED record would otherwise stall
        every non-owner's chain for good.  Both replays are idempotent:
        records are immutable per (epoch, round, shard)."""
        self._period_index += 1
        faults.on_round(self._period_index)
        t0 = time.perf_counter()
        t0_unix = time.time()
        self.last_bytes_out = self.last_bytes_in = 0
        self.last_intra_bytes = 0
        host = tree_map(_host, merged)
        leaves = tree_leaves(host)
        if not leaves or not all(_float_leaf(l) for l in leaves):
            if not self._warned_nonfloat:
                self._warned_nonfloat = True
                self._print(f"[param_sync] task {self._task}: parameter "
                            "tree has non-float leaves — compressed "
                            "exchange disabled, using the full-state path")
            self.fallback_exchanges += 1
            self._note_extra = {"fallback": True, "reason": "non_float"}
            return super().exchange(merged, alive)
        if self._fp is None:
            self._fp = tree_fingerprint(host)
        if not self._fp_published:
            # On the wire BEFORE any delta/anchor of mine, so readers can
            # always vet my records structurally.
            self._set_hint(FP_KEY.format(self._ns, self._task), self._fp)
            self._count_wire("out", len(self._fp))
            self._fp_published = True
        epoch, active = self._epoch_view()
        if self._task not in active:
            # Evicted/not-yet-admitted this epoch: keep training SOLO.
            # The legacy full-state records were last refreshed during
            # bootstrap (steady-state compressed rounds never republish
            # them), so super().exchange() here would average live
            # weights with round-one-era snapshots and regress the loss;
            # readmission re-keys shard ownership at the next epoch and
            # the anchor resync picks this worker back up.
            self.fallback_exchanges += 1
            self._note_extra = {"fallback": True, "reason": "not_member",
                                "epoch": epoch}
            self._note_exchange(
                peers=0,
                native_bytes=sum(m[2] for m in map(_leaf_meta, leaves)),
                compressed=False,
                dur_ms=(time.perf_counter() - t0) * 1000.0)
            return merged, 0
        vec = _flatten_f32(host)
        native_bytes = sum(m[2] for m in map(_leaf_meta, leaves))
        if self._residual is None or self._residual.size != vec.size:
            self._residual = np.zeros(vec.size, np.float32)
        if not self._sync_epoch(epoch, active, vec):
            # No consensus reachable (anchor chief hasn't published yet):
            # the full-state exchange IS the bootstrap fallback.
            self.fallback_exchanges += 1
            self._note_extra = {"fallback": True, "reason": "no_anchor",
                                "round": self._k, "epoch": epoch}
            return ParamAverager.exchange(self, merged, alive)
        # Before any freeze this period: replay write-once records if the
        # plane rode a failover since last period (the dead primary's
        # replication lag may have eaten acknowledged writes).
        self._check_plane_failover()
        return self._run_protocol(merged, host, vec, epoch, active, alive,
                                  native_bytes, t0, t0_unix)

    def _run_protocol(self, merged, host, vec, epoch, active, alive,
                      native_bytes, t0, t0_unix):
        """One flat compressed period (consensus in hand): frozen reduce
        of the pending round, assembly, this period's delta publication.
        The seam the hierarchical subclass overrides with its two-level
        protocol."""
        tr0 = time.perf_counter()
        if self._pending_reduce is not None and not self._freeze_hold:
            pending, self._pending_reduce = self._pending_reduce, None
            try:
                self._reduce_round(pending, epoch, active, alive)
            except BaseException:
                # A transport blip must not orphan the round: without my
                # frozen shard the whole fleet's chain stalls forever.
                # Re-arm so the next period retries (idempotent — the
                # write-once ``_reduced_done`` guard skips frozen shards).
                self._pending_reduce = pending
                raise
        reduce_ms = (time.perf_counter() - tr0) * 1000.0
        ta0 = time.perf_counter()
        result, peers = self._try_assemble(vec, epoch, active)
        if result is None:
            displacement = self._maybe_adopt_anchor(vec.size)
            if displacement is not None:
                result = vec + displacement
        assemble_ms = (time.perf_counter() - ta0) * 1000.0
        tp0 = time.perf_counter()
        self._publish_delta(result if result is not None else vec,
                            epoch, active)
        publish_ms = (time.perf_counter() - tp0) * 1000.0
        dur_ms = (time.perf_counter() - t0) * 1000.0
        self.last_stage_ms = {
            "intra_reduce_ms": 0.0,
            "quantize_ms": round(publish_ms, 3),
            "inter_exchange_ms": round(reduce_ms + assemble_ms, 3),
            "broadcast_ms": 0.0,
        }
        tracer = tracing.active()
        if tracer is not None:
            span = tracer.emit_span("exchange", t0_unix, dur_ms,
                                    round=self._k, epoch=epoch, peers=peers)
            off = t0_unix
            for name, ms in (("exchange.reduce", reduce_ms),
                             ("exchange.assemble", assemble_ms),
                             ("exchange.publish", publish_ms)):
                tracer.emit_span(name, off, ms, parent_id=span)
                off += ms / 1000.0
        self._note_exchange(
            peers=peers, native_bytes=native_bytes, compressed=True,
            round=self._k, epoch=epoch, advanced=result is not None,
            residual_rms=round(self.last_residual_rms, 6),
            quant="int8" if self._fmt == FMT_INT8 else "bf16",
            stages=self.last_stage_ms,
            dur_ms=dur_ms)
        if result is None:
            return merged, 0
        return _unflatten_f32(result, host), peers

    def pull_latest(self, template: Any) -> Any | None:
        """Rejoin bootstrap: the anchor (the collective's agreed
        consensus) first, the legacy full-state average as fallback."""
        host = tree_map(_host, template)
        leaves = tree_leaves(host)
        if leaves and all(_float_leaf(l) for l in leaves):
            if self._fp is None:
                self._fp = tree_fingerprint(host)
            n = sum(l.size for l in leaves)
            got = self._fetch_anchor(n)
            if got is not None:
                return _unflatten_f32(got[1], host)
        return super().pull_latest(template)


class HierarchicalCompressedAverager(CompressedShardedAverager):
    """Two-level compressed exchange: intra-slice raw reduction, ONE
    quantized inter-slice shard exchange per slice (docs/param_exchange.md,
    "Hierarchical exchange").

    Workers group into **slices** via the topology map
    (``parallel.sync.slice_topology`` over the membership epoch's active
    set).  Within a slice the delta is reduced RAW — ICI/shared-memory is
    cheap, so no quantization and none of it counts as inter-host wire
    bytes; when the slice's members are local mesh replicas the reduce is
    one reduction on their device
    (``parallel.sync.build_intra_slice_reduce``), and
    when they are sibling worker processes it rides raw float32 records
    over the exchange dir/KV (the CI simulation of the ICI hop).  Exactly
    one **exporter** per slice (lowest task id) quantizes the
    slice-reduced delta with the inherited int8+error-feedback codec and
    runs the flat protocol's shard exchange against the other slices'
    exporters — so per-host inter-host bytes drop from O(2P/N·N) to
    O(2P/S) with S slices, and the consensus chain is keyed by
    (epoch, round, slice, shard) through the exporter identity.
    Non-exporters receive the assembled consensus via an intra-slice
    broadcast record and apply it with the same delayed-averaging delta
    correction.

    Slice membership and exporter election re-derive from the elastic
    epoch: an evicted exporter is just the PR-5 evicted-owner machinery
    one level up — the next epoch re-keys its slice to the surviving
    lowest task and the chief re-anchors.

    Contributor masks are POSITION-based per exchange group
    (:func:`contributor_bit`), so the u32 mask covers 32 slices of 32
    members each — the arithmetic that makes "hundreds of workers"
    plausible where the flat protocol stops at 32.
    """

    MAX_GROUP = 32 * 32

    def __init__(self, coord, task_index: int, num_workers: int,
                 namespace: str = "default",
                 exchange_dir: str | None = None,
                 binary_threshold: int = BINARY_THRESHOLD_BYTES,
                 print_fn=print, quant: str = "int8",
                 block: int = DEFAULT_QUANT_BLOCK,
                 anchor_every: int = DEFAULT_ANCHOR_EVERY,
                 epoch_fn=None, slice_size: int = 2,
                 intra_reduce_fn=None):
        super().__init__(coord, task_index, num_workers,
                         namespace=namespace, exchange_dir=exchange_dir,
                         binary_threshold=binary_threshold,
                         print_fn=print_fn, quant=quant, block=block,
                         anchor_every=anchor_every, epoch_fn=epoch_fn)
        if slice_size < 1:
            raise ValueError(f"slice_size must be >= 1, got {slice_size}")
        if slice_size > 32 or -(-num_workers // slice_size) > 32:
            raise ValueError(
                f"hierarchical exchange supports at most 32 slices of at "
                f"most 32 members (u32 contributor masks per level): "
                f"slice_size={slice_size} over {num_workers} workers "
                f"doesn't fit")
        self._slice_size = slice_size
        #: optional device reduction ``(stacked [k, n]) -> mean [n]``
        #: (``parallel.sync.build_intra_slice_reduce``) used for the slice
        #: mean when provided; host ``np.mean`` otherwise.
        self._intra_reduce_fn = intra_reduce_fn
        # Exporter bookkeeping: intra contributor mask per frozen round
        # (carried on that round's broadcast) and the one-period arming
        # that gives members a period to publish before the freeze.
        self._cast_mask: dict[int, int] = {}
        self._armed_round: int | None = None
        #: last period's placement (bench/observability).
        self.last_slice: int | None = None
        self.last_is_exporter = False

    def _reset_protocol(self) -> None:
        super()._reset_protocol()
        self._cast_mask.clear()
        self._armed_round = None

    def _slice_view(self, active):
        slices = slice_topology(active, self._slice_size)
        g = slice_of_task(slices, self._task)
        return slices, g

    def _cast_key(self, g: int) -> str:
        return CAST_KEY.format(self._ns, g)

    # ------------------------------------------------------ member side

    def _member_adopt(self, vec: np.ndarray, epoch: int, g: int,
                      members) -> tuple[np.ndarray | None, int]:
        """Adopt the exporter's consensus broadcast, if one for my round
        (or later — the laggard resync) is up; ``(None, 0)`` otherwise."""
        hint = self._coord.kv_get(self._cast_key(g) + ".v")
        if hint is not None:
            with self._intra():
                self._count_wire("in", len(hint))
            try:
                hint_round, hint_epoch = (int(x) for x in hint.split())
            except ValueError:
                return None, 0
            if hint_round < self._k or hint_epoch != epoch:
                return None, 0
        with self._intra():
            blob = self._fetch_blob(self._cast_key(g))
        decoded = decode_shard(blob) if blob is not None else None
        if decoded is None:
            return None, 0
        hdr, new_c = decoded
        if (hdr["kind"] != KIND_CAST or hdr["epoch"] != epoch
                or hdr["shard"] != g or hdr["n_values"] != vec.size):
            return None, 0
        r = hdr["round"]
        my_bit = contributor_bit(members, self._task)
        if r == self._k:
            # The round I contributed to assembled: delayed averaging
            # with delta correction against MY snapshot.
            base = self._snap if (self._snap is not None
                                  and self._snap.size == vec.size) \
                else self._consensus
            result = vec + (new_c - base)
            if (not (hdr["mask"] & my_bit)
                    and self._my_delta is not None
                    and self._my_delta[0] == r):
                # My raw delta missed the exporter's freeze: re-inject so
                # my progress rides the next round instead of being lost.
                self._residual += self._my_delta[1]
        elif r > self._k:
            # I lagged several rounds (slow cadence, restart): adopt by
            # consensus displacement, keeping local progress — the
            # intra-slice analogue of the anchor-miss resync.
            result = vec + (new_c - self._consensus)
            self._print(f"[param_sync] task {self._task}: resynced to "
                        f"slice {g} broadcast round {r} (was at round "
                        f"{self._k})")
        else:
            return None, 0
        self._consensus = new_c.copy()
        self._k = r + 1
        self.rounds_completed += 1
        self._published_round = None
        self._my_delta = None
        peers = bin(hdr["mask"] & ~my_bit).count("1")
        return result, peers

    def _member_publish(self, cur: np.ndarray, epoch: int, g: int,
                        members) -> None:
        """Publish my RAW float32 delta for the current round into the
        slice — once per round, error-free (raw), so the residual resets
        to the re-injection vehicle it is for members."""
        if self._published_round == self._k:
            return
        d = cur - self._consensus
        d += self._residual
        parts = encode_shard(np.ascontiguousarray(d, np.float32),
                             kind=KIND_DELTA, fmt=FMT_RAW_F32,
                             round_=self._k, epoch=epoch, shard=g,
                             nshards=len(members),
                             mask=contributor_bit(members, self._task),
                             block=0)
        with self._intra():
            self._publish_blob(
                MEMBER_DELTA_KEY.format(self._ns, g, self._task), parts,
                tag=self._blob_tag(f"m{g}"))
        self._my_delta = (self._k, d.copy())
        self._snap = cur.copy()
        self._residual = np.zeros_like(self._residual)
        self._published_round = self._k

    # ---------------------------------------------------- exporter side

    def _freeze_slice_delta(self, vec: np.ndarray, epoch: int, g: int,
                            members, exporters, alive) -> float:
        """Freeze the slice-reduced delta for the current round — mean of
        every member delta visible NOW plus my own — and publish it as my
        quantized inter-slice delta.  Returns the quantize+publish ms."""
        mask = contributor_bit(members, self._task)
        member_ds = []
        for peer in members:
            if peer == self._task:
                continue
            if alive is not None and peer < len(alive) and not alive[peer]:
                continue
            with self._intra():
                fp_ok = self._peer_fp_matches(peer)
            if not fp_ok:
                continue
            with self._intra():
                blob = self._fetch_blob(
                    MEMBER_DELTA_KEY.format(self._ns, g, peer))
            decoded = decode_shard(blob) if blob is not None else None
            if decoded is None:
                continue
            hdr, vals = decoded
            if (hdr["kind"] == KIND_DELTA and hdr["round"] == self._k
                    and hdr["epoch"] == epoch
                    and hdr["n_values"] == vec.size):
                member_ds.append(vals)
                mask |= contributor_bit(members, peer)
        own_d = vec - self._consensus
        if member_ds:
            stacked = np.stack([own_d] + member_ds)
            if (self._intra_reduce_fn is not None
                    and stacked.shape[0] == len(members)):
                # The device reduction — ONLY for a full house: it is
                # built for exactly len(members) rows and divides by that
                # count, so a partial set (a slow/evicted
                # member, a fingerprint mismatch) must take the host mean
                # below — with the CONTRIBUTOR count as divisor — rather
                # than crash the exchange or mis-scale the slice delta.
                slice_delta = np.asarray(self._intra_reduce_fn(stacked),
                                         np.float32)
            else:
                slice_delta = np.mean(stacked, axis=0, dtype=np.float32)
        else:
            slice_delta = own_d
        self._cast_mask[self._k] = mask
        tq0 = time.perf_counter()
        # The inherited flat protocol over the EXPORTER group: quantize
        # (int8 + error feedback at this level) and shard-publish.
        self._publish_delta(self._consensus + slice_delta, epoch,
                            exporters)
        # _publish_delta snapshots the virtual slice base; the delayed-
        # averaging correction for MY params needs MY base.
        self._snap = vec.copy()
        return (time.perf_counter() - tq0) * 1000.0

    def _broadcast_consensus(self, r: int, epoch: int, g: int,
                             members) -> None:
        """Publish the assembled consensus back into the slice (raw f32,
        intra-class traffic), carrying round r's intra contributor mask so
        excluded members self-detect."""
        if len(members) == 1:
            self._cast_mask.pop(r, None)
            return  # singleton slice: nobody to tell
        mask = self._cast_mask.pop(
            r, contributor_bit(members, self._task))
        parts = encode_shard(
            np.ascontiguousarray(self._consensus, np.float32),
            kind=KIND_CAST, fmt=FMT_RAW_F32, round_=r, epoch=epoch,
            shard=g, nshards=len(members), mask=mask, block=0)
        with self._intra():
            self._publish_blob(self._cast_key(g), parts,
                               tag=self._blob_tag(f"cast{g}"),
                               compress=False)
        self._set_hint(self._cast_key(g) + ".v", f"{r} {epoch}")

    # ---------------------------------------------------------- protocol

    def _run_protocol(self, merged, host, vec, epoch, active, alive,
                      native_bytes, t0, t0_unix):
        slices, g = self._slice_view(active)
        if g is None:  # unreachable (active membership checked upstream)
            return merged, 0
        members = slices[g]
        exporters = slice_exporters(slices)
        if len(slices) > 32 or len(members) > 32:
            raise ValueError(
                f"hierarchical exchange derived {len(slices)} slices with "
                f"a largest slice of {max(len(s) for s in slices)} members "
                f"— both must be <= 32 (u32 contributor masks); adjust "
                f"--slice_size")
        self.last_slice = g
        self.last_is_exporter = is_exporter = members[0] == self._task
        intra_ms = quant_ms = inter_ms = cast_ms = 0.0
        advanced_round = None
        if is_exporter:
            # Frozen inter-slice reduce of the pending round, then
            # assembly — the inherited machinery over the exporter group.
            ti0 = time.perf_counter()
            if self._pending_reduce is not None and not self._freeze_hold:
                pending, self._pending_reduce = self._pending_reduce, None
                try:
                    self._reduce_round(pending, epoch, exporters, alive)
                except BaseException:
                    self._pending_reduce = pending  # re-arm, never orphan
                    raise
            result, peers = self._try_assemble(vec, epoch, exporters)
            if result is None:
                displacement = self._maybe_adopt_anchor(vec.size)
                if displacement is not None:
                    result = vec + displacement
            else:
                advanced_round = self._k - 1
            inter_ms = (time.perf_counter() - ti0) * 1000.0
            tc0 = time.perf_counter()
            if advanced_round is not None:
                self._broadcast_consensus(advanced_round, epoch, g,
                                          members)
            cast_ms = (time.perf_counter() - tc0) * 1000.0
            # Freeze + publish the NEXT round's slice delta one period
            # after the round opened, so members have had a period to see
            # the broadcast and publish their deltas into the slice.
            ti1 = time.perf_counter()
            if self._published_round != self._k:
                if self._armed_round == self._k:
                    quant_ms = self._freeze_slice_delta(
                        vec, epoch, g, members, exporters, alive)
                else:
                    self._armed_round = self._k
            intra_ms += (time.perf_counter() - ti1) * 1000.0 - quant_ms
        else:
            tb0 = time.perf_counter()
            result, peers = self._member_adopt(vec, epoch, g, members)
            cast_ms = (time.perf_counter() - tb0) * 1000.0
            ti0 = time.perf_counter()
            self._member_publish(result if result is not None else vec,
                                 epoch, g, members)
            intra_ms = (time.perf_counter() - ti0) * 1000.0
        dur_ms = (time.perf_counter() - t0) * 1000.0
        self.last_stage_ms = {
            "intra_reduce_ms": round(max(intra_ms, 0.0), 3),
            "quantize_ms": round(quant_ms, 3),
            "inter_exchange_ms": round(inter_ms, 3),
            "broadcast_ms": round(cast_ms, 3),
        }
        tracer = tracing.active()
        if tracer is not None:
            span = tracer.emit_span("exchange", t0_unix, dur_ms,
                                    round=self._k, epoch=epoch,
                                    peers=peers, slice=g,
                                    exporter=is_exporter)
            # Child spans in each role's REAL execution order (exporter:
            # inter reduce/assemble -> broadcast -> member-delta fetch ->
            # quantize+publish; member: broadcast adopt -> raw publish),
            # so the exported timeline attributes latency to the stage
            # that actually occupied it.
            if is_exporter:
                order = (("exchange.inter_exchange", inter_ms),
                         ("exchange.broadcast", cast_ms),
                         ("exchange.intra_reduce", intra_ms),
                         ("exchange.quantize", quant_ms))
            else:
                order = (("exchange.broadcast", cast_ms),
                         ("exchange.intra_reduce", intra_ms))
            off = t0_unix
            for name, ms in order:
                tracer.emit_span(name, off, ms, parent_id=span)
                off += ms / 1000.0
        self._note_exchange(
            peers=peers, native_bytes=native_bytes, compressed=True,
            round=self._k, epoch=epoch, advanced=result is not None,
            residual_rms=round(self.last_residual_rms, 6),
            quant="int8" if self._fmt == FMT_INT8 else "bf16",
            hierarchical=True, slice=g, n_slices=len(slices),
            exporter=is_exporter,
            inter_bytes=self.last_bytes_out + self.last_bytes_in,
            intra_bytes=self.last_intra_bytes,
            stages=self.last_stage_ms,
            dur_ms=dur_ms)
        if result is None:
            return merged, 0
        return _unflatten_f32(result, host), peers


class OverlappedAverager:
    """Background-threaded parameter exchange — the GB-scale publish/
    fetch/average runs CONCURRENTLY with training instead of stalling it
    (VERDICT r4 #5: a 1.1 GB / 2-peer exchange measured 36 s of
    stop-the-world pause per sync period; the reference PS moved
    parameters concurrently with other workers' compute every step,
    ``distributed.py:145``).

    Protocol (delayed averaging with delta correction):

    - at each sync period the trainer hands over a host SNAPSHOT of its
      merged params and immediately keeps training;
    - the worker thread publishes the snapshot, fetches live peers, and
      averages — all while local steps continue;
    - at the NEXT period the trainer collects the finished average and
      applies it as a DELTA against the snapshot it came from
      (``params += avg - snapshot``): the consensus pull lands one
      period late, but the K local steps taken meanwhile are preserved
      instead of overwritten (plain stale adoption would silently undo
      them — that is the difference between "delayed averaging" and
      "losing a period of work").

    Equivalence: with the delta applied, the update at period n is
    exactly the synchronous exchange's update computed from period
    n-1's parameters — the same math one period stale, which is inside
    the bounded-staleness contract async mode already documents (peers
    read whatever publications exist; nobody waits).  Pinned by
    ``tests/test_param_sync.py::test_overlapped_matches_one_period_stale_sync``.

    One exchange is in flight at a time; if the previous one has not
    finished by the next period, the trainer simply keeps training and
    retries collection a period later (the exchange thread never blocks
    the step loop — that is the whole point).
    """

    def __init__(self, averager: ParamAverager, alive_fn=None,
                 print_fn=print):
        import queue
        import threading
        self._avg = averager
        self._alive_fn = alive_fn
        self._print = print_fn
        self._in: "queue.Queue" = queue.Queue(maxsize=1)
        self._out: "queue.Queue" = queue.Queue(maxsize=1)
        self._busy = False
        self._closed = False
        #: wall seconds the last background exchange took (observability)
        self.last_exchange_seconds = 0.0
        self.exchanges_completed = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="param-exchange")
        self._thread.start()

    def _loop(self):
        import queue
        import time
        while True:
            snapshot = self._in.get()
            if snapshot is None or self._closed:
                return
            t0 = time.perf_counter()
            try:
                alive = self._alive_fn() if self._alive_fn else None
                avg, peers = self._avg.exchange(snapshot, alive=alive)
            except Exception as e:
                # Control-plane hiccups (a peer evicted mid-exchange, an
                # unreachable coordinator) must not kill the thread; report
                # a no-op result so the trainer just continues.
                self._print(f"[param_sync] background exchange failed "
                            f"({type(e).__name__}: {e}); skipping period")
                avg, peers = snapshot, 0
            self.last_exchange_seconds = time.perf_counter() - t0
            if self._closed:
                return  # nobody will collect; exit instead of blocking
            try:
                self._out.put_nowait((avg, snapshot, peers))
            except queue.Full:  # pragma: no cover — busy-flag protocol
                pass            # prevents this; defensive against a leak

    @property
    def busy(self) -> bool:
        """True while an exchange is in flight AND its result has not
        been collected yet.  Callers should check this BEFORE
        materializing a snapshot — a device-to-host copy of a GB tree
        that ``submit`` would refuse is exactly the stall this class
        exists to hide."""
        return self._busy

    def poll(self) -> tuple[Any, Any, int] | None:
        """Collect the finished exchange, if any: ``(avg, snapshot,
        peers)`` — apply ``params += avg - snapshot`` when ``peers > 0``
        — or None while still in flight / nothing launched."""
        import queue
        if not self._busy:
            return None
        try:
            result = self._out.get_nowait()
        except queue.Empty:
            self._print("[param_sync] background exchange still in "
                        "flight; continuing to train (will collect "
                        "next period)")
            return None
        self._busy = False
        self.exchanges_completed += 1
        return result

    def submit(self, merged_host: Any) -> bool:
        """Launch the next background exchange with this host snapshot;
        False (snapshot unused) when one is already in flight."""
        if self._busy:
            return False
        self._in.put(merged_host)
        self._busy = True
        return True

    def step_period(self, merged_host: Any) -> tuple[Any, Any, int] | None:
        """poll() + submit() in one call, for callers whose snapshot is
        already host-side (tests, the bench overlap arm)."""
        result = self.poll()
        self.submit(merged_host)
        return result

    def drain(self, timeout: float | None = None):
        """Block for the in-flight exchange (end of training / tests).
        Returns the final ``(avg, snapshot, peers)`` or None."""
        import queue
        if not self._busy:
            return None
        try:
            result = self._out.get(timeout=timeout)
        except queue.Empty:
            return None
        self._busy = False
        self.exchanges_completed += 1
        return result

    def close(self, timeout: float = 30.0) -> bool:
        """Stop the worker thread and JOIN it.  Safe while an exchange is
        in flight (a peer evicted mid-exchange leaves the thread inside
        the coordination client's retry budget — it finishes or no-ops,
        sees the closed flag, and exits); the sentinel is delivered
        without blocking even if a snapshot is still queued.  Returns
        True when the thread is confirmed dead — the regression surface
        for the thread-leak bug where close() neither joined nor could
        outlive a full input queue."""
        import queue
        self._closed = True
        try:
            self._in.put_nowait(None)
        except queue.Full:
            pass  # worker is mid-get; it checks _closed on its next loop
        self._thread.join(timeout)
        return not self._thread.is_alive()


def run_namespace(logdir: str) -> str:
    """Stable per-run KV namespace: a digest of the run's logdir (shared by
    all of the run's workers and its restarts; different for fresh runs)."""
    import os
    import zlib as _zlib
    return format(_zlib.crc32(os.path.abspath(logdir).encode()), "08x")
