"""TensorBoard event-file summaries, dependency-free (SURVEY §5 observability).

Copied from ``distributed_tensorflow_tpu/utils/summary.py`` (numpy and the standard library
only; the port's imports).

The reference's ``tf.train.Supervisor`` (``/root/reference/distributed.py:110``)
carries a full summary-writing path (``summary_op``/``summary_writer``) but the
script defines no summaries — SURVEY §5 calls this out as the one observability
capability present-but-unused.  This module supplies it TPU-natively with zero
TensorFlow dependency: :class:`SummaryWriter` emits standard
``events.out.tfevents.*`` files any stock TensorBoard can load, by hand-encoding
the two tiny protos involved (``Event`` and ``Summary.Value`` with
``simple_value``) and framing them as TFRecords with masked CRC32C checksums.

:func:`iter_events` is the matching reader (checksums verified), so tests and
tools can consume event files without TensorBoard either.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, NamedTuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven pure Python.  Records are tens of bytes;
# throughput is irrelevant next to the train step.

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ byte) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding for Event / Summary.

def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_value(tag_name: str, value: float) -> bytes:
    # A Summary message body with one Value: Summary field 1 = Value message;
    # Summary.Value field 1 = tag (string), field 2 = simple_value (float).
    value_body = (_len_delimited(1, tag_name.encode("utf-8"))
                  + _tag(2, 5) + struct.pack("<f", float(value)))
    return _len_delimited(1, value_body)


def _packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _len_delimited(field, payload)


def _encode_histogram(tag_name: str, values, bins: int = 30) -> bytes:
    """Summary body with one histogram Value (Summary.Value field 5 = histo).

    HistogramProto: 1=min, 2=max, 3=num, 4=sum, 5=sum_squares (doubles),
    6=bucket_limit, 7=bucket (packed repeated double).  TensorBoard accepts
    any monotone bucket_limit sequence; uniform bins over [min, max] keep the
    encoding dependency-free.
    """
    import numpy as np

    arr = np.asarray(values, np.float64).ravel()
    arr = arr[np.isfinite(arr)]
    if arr.size == 0:
        arr = np.zeros(1)
    lo, hi = float(arr.min()), float(arr.max())
    if lo == hi:
        hi = lo + 1e-12
    counts, edges = np.histogram(arr, bins=bins, range=(lo, hi))
    histo = (_tag(1, 1) + struct.pack("<d", lo)
             + _tag(2, 1) + struct.pack("<d", hi)
             + _tag(3, 1) + struct.pack("<d", float(arr.size))
             + _tag(4, 1) + struct.pack("<d", float(arr.sum()))
             + _tag(5, 1) + struct.pack("<d", float(np.square(arr).sum()))
             + _packed_doubles(6, edges[1:])
             + _packed_doubles(7, counts))
    value_body = (_len_delimited(1, tag_name.encode("utf-8"))
                  + _len_delimited(5, histo))
    return _len_delimited(1, value_body)


def _encode_event(wall_time: float, step: int | None = None,
                  summary_values: bytes | None = None,
                  file_version: str | None = None) -> bytes:
    # Event: 1=wall_time (double), 2=step (int64), 3=file_version (string),
    # 5=summary (Summary message; its field 1 is the repeated Value)
    out = _tag(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _tag(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        out += _len_delimited(3, file_version.encode("utf-8"))
    if summary_values is not None:
        out += _len_delimited(5, summary_values)
    return out


def _frame_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", _masked_crc(header))
            + data + struct.pack("<I", _masked_crc(data)))


# ---------------------------------------------------------------------------
# Writer / reader.

class SummaryWriter:
    """Writes TensorBoard-compatible scalar summaries.

    One writer per process, chief-only in distributed runs (mirroring the
    Supervisor's chief-only summary thread).  ``scalar()`` buffers in the OS
    file buffer; ``flush()`` after checkpoint-worthy moments, ``close()`` at
    exit (both idempotent).  Also usable as a context manager.
    """

    def __init__(self, logdir: str | os.PathLike, filename_suffix: str = ""):
        self.logdir = os.fspath(logdir)
        os.makedirs(self.logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}{filename_suffix}")
        self.path = os.path.join(self.logdir, name)
        self._fh = open(self.path, "ab")
        self._write(_encode_event(time.time(), file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._fh.write(_frame_record(event))

    def scalar(self, tag: str, value: float, step: int) -> None:
        """Record one scalar point; NaN-safe (TensorBoard renders gaps)."""
        if self._fh is None:
            raise ValueError("SummaryWriter is closed")
        self._write(_encode_event(time.time(), step=int(step),
                                  summary_values=_encode_value(tag, value)))

    def scalars(self, values: dict[str, float], step: int) -> None:
        """Record several tags at one step (one Event per tag, like TB does)."""
        for tag, value in values.items():
            self.scalar(tag, value, step)

    def histogram(self, tag: str, values, step: int, bins: int = 30) -> None:
        """Record a histogram of ``values`` (any array-like; flattened)."""
        if self._fh is None:
            raise ValueError("SummaryWriter is closed")
        self._write(_encode_event(time.time(), step=int(step),
                                  summary_values=_encode_histogram(
                                      tag, values, bins=bins)))

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ScalarEvent(NamedTuple):
    wall_time: float
    step: int
    tag: str
    value: float


def _decode_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    pos = 0
    while pos < len(buf):
        key, pos = _decode_varint(buf, pos)
        field, wire_type = key >> 3, key & 7
        if wire_type == 0:
            value, pos = _decode_varint(buf, pos)
        elif wire_type == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        elif wire_type == 2:
            length, pos = _decode_varint(buf, pos)
            value, pos = buf[pos:pos + length], pos + length
        elif wire_type == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        yield field, wire_type, value


class HistogramEvent(NamedTuple):
    wall_time: float
    step: int
    tag: str
    min: float
    max: float
    num: float
    sum: float
    sum_squares: float
    bucket_limit: tuple[float, ...]
    bucket: tuple[float, ...]


def _iter_summary_values(path):
    """Yield ``(wall_time, step, value_buf)`` per Summary.Value, verifying
    record checksums.  A truncated *trailing* record (a hard-killed writer
    mid-flush — the preemption scenario) ends iteration cleanly, yielding the
    intact prefix, matching TensorBoard's tolerance; corruption of a complete
    record raises ``ValueError``."""
    with open(path, "rb") as fh:
        data = fh.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            return  # truncated tail: header/crc incomplete
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if _masked_crc(header) != hcrc:
            raise ValueError(f"header checksum mismatch at offset {pos}")
        if pos + 16 + length > len(data):
            return  # truncated tail: body/crc incomplete
        body = data[pos + 12:pos + 12 + length]
        (bcrc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
        if _masked_crc(body) != bcrc:
            raise ValueError(f"record checksum mismatch at offset {pos}")
        pos += 16 + length

        wall_time, step, summary = 0.0, 0, None
        for field, wire_type, value in _iter_fields(body):
            if field == 1 and wire_type == 1:
                (wall_time,) = struct.unpack("<d", value)
            elif field == 2 and wire_type == 0:
                step = value if value < (1 << 63) else value - (1 << 64)
            elif field == 5 and wire_type == 2:
                summary = value
        if summary is None:
            continue
        for field, wire_type, value_buf in _iter_fields(summary):
            if field == 1 and wire_type == 2:
                yield wall_time, step, value_buf


def iter_events(path: str | os.PathLike) -> Iterator[ScalarEvent]:
    """Yield scalar events from a tfevents file (see _iter_summary_values
    for the checksum/truncation contract).  Non-scalar values are skipped."""
    for wall_time, step, value_buf in _iter_summary_values(path):
        tag, simple_value = None, None
        for vfield, vwire, vvalue in _iter_fields(value_buf):
            if vfield == 1 and vwire == 2:
                tag = vvalue.decode("utf-8")
            elif vfield == 2 and vwire == 5:
                (simple_value,) = struct.unpack("<f", vvalue)
        if tag is not None and simple_value is not None:
            yield ScalarEvent(wall_time, step, tag, simple_value)


def _unpack_doubles(buf: bytes) -> tuple[float, ...]:
    return struct.unpack(f"<{len(buf) // 8}d", buf)


def iter_histograms(path: str | os.PathLike) -> Iterator[HistogramEvent]:
    """Yield histogram events from a tfevents file (scalars are skipped)."""
    for wall_time, step, value_buf in _iter_summary_values(path):
        tag, histo = None, None
        for vfield, vwire, vvalue in _iter_fields(value_buf):
            if vfield == 1 and vwire == 2:
                tag = vvalue.decode("utf-8")
            elif vfield == 5 and vwire == 2:
                histo = vvalue
        if tag is None or histo is None:
            continue
        fields = {1: 0.0, 2: 0.0, 3: 0.0, 4: 0.0, 5: 0.0}
        limits, buckets = (), ()
        for hfield, hwire, hvalue in _iter_fields(histo):
            if hfield in fields and hwire == 1:
                (fields[hfield],) = struct.unpack("<d", hvalue)
            elif hfield == 6 and hwire == 2:
                limits = _unpack_doubles(hvalue)
            elif hfield == 7 and hwire == 2:
                buckets = _unpack_doubles(hvalue)
        yield HistogramEvent(wall_time, step, tag, fields[1], fields[2],
                             fields[3], fields[4], fields[5], limits, buckets)


def latest_event_file(logdir: str | os.PathLike) -> str:
    """Path of the newest tfevents file in ``logdir``."""
    logdir = os.fspath(logdir)
    candidates = sorted(
        (os.path.join(logdir, name) for name in os.listdir(logdir)
         if name.startswith("events.out.tfevents.")),
        key=os.path.getmtime)
    if not candidates:
        raise FileNotFoundError(f"no tfevents files in {logdir}")
    return candidates[-1]
