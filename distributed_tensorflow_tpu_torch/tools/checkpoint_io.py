"""Raw checkpoint access, the checkpoint writer and integrity manifests:
the counterpart of ``distributed_tensorflow_tpu/tools/checkpoint_io.py``
without orbax or jax.

One implementation of "open <logdir>/checkpoints, pick the newest (or a
requested) step, restore raw arrays": raw (no target tree), so it is
agnostic to the training configuration that wrote the checkpoint
(optimizer slots, EMA, pipelined trees).  The JAX package writes these
checkpoints through orbax's ``StandardSave``; the layout and what reads
each variant of it (numpy alone, or ``zstandard`` / ``tensorstore``) are
described in :mod:`._zarr_layout`.  :func:`save_raw` writes the same
layout with numpy alone, and the JAX package's ``restore_raw`` restores
it.

The integrity half (docs/fault_tolerance.md) is the JAX package's, copied:
every finalized save gets a per-step **manifest** (``dtf.manifest.json``
inside the step directory) listing each file's byte size and CRC32,
written atomically (tmp + ``os.replace``) *after* the checkpoint
finishes.  ``verify_checkpoint`` replays the manifest against the files,
so a truncated or bit-flipped checkpoint is detected before it is
deserialized.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib

from ._zarr_layout import read_item, write_item

#: Manifest file name inside each checkpoint step directory.  The name is
#: filtered out of the checksummed file set (it describes the others).
MANIFEST_NAME = "dtf.manifest.json"
#: orbax's item directory inside a step (``CheckpointManager``'s default
#: item) and the step's own metadata file.
ITEM_NAME = "default"
CHECKPOINT_METADATA_NAME = "_CHECKPOINT_METADATA"
_ORBAX_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                  "StandardCheckpointHandler")


def open_checkpoints(logdir: str) -> list[int]:
    """The sorted steps under ``<logdir>/checkpoints``.

    Raises ``FileNotFoundError`` when the directory or any checkpoint is
    missing.  (The JAX package returns an orbax manager beside the steps;
    here there is no manager to own.)
    """
    ckpt_dir = os.path.join(logdir, "checkpoints")
    if not os.path.isdir(ckpt_dir):
        raise FileNotFoundError(f"no 'checkpoints' directory under {logdir}")
    steps = [step for step, _ in list_step_dirs(ckpt_dir)]
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return steps


def list_step_dirs(ckpt_dir: str) -> list[tuple[int, str]]:
    """``[(step, step_dir)]`` sorted ascending — the on-disk view of
    ``CheckpointManager.all_steps()`` (orbax names step dirs by the bare
    integer), usable without opening a manager."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        full = os.path.join(ckpt_dir, name)
        if os.path.isdir(full):
            try:
                out.append((int(name), full))
            except ValueError:
                continue
    return sorted(out)


def _iter_checkpoint_files(step_dir: str):
    """Yield ``(relpath, fullpath)`` for every data file under a step dir
    (the manifest itself and in-flight tmp files excluded)."""
    for root, _, files in os.walk(step_dir):
        for name in sorted(files):
            if name == MANIFEST_NAME or name.endswith(".tmp"):
                continue
            full = os.path.join(root, name)
            yield os.path.relpath(full, step_dir), full


def _crc32_file(path: str) -> str:
    crc = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return format(crc & 0xFFFFFFFF, "08x")


def write_manifest(step_dir: str) -> str:
    """Checksum every file under ``step_dir`` into its manifest.

    Called after the save is fully finished (the supervisor waits on the
    async checkpointer first); the tmp-write + ``os.replace`` finalize is
    atomic, so a crash mid-manifest leaves the previous state (or no
    manifest — an *unverified* checkpoint), never a half-written one.
    Returns the manifest path.
    """
    files = {}
    for rel, full in _iter_checkpoint_files(step_dir):
        files[rel] = {"bytes": os.path.getsize(full),
                      "crc32": _crc32_file(full)}
    payload = {
        "version": 1,
        "file_count": len(files),
        "total_bytes": sum(f["bytes"] for f in files.values()),
        "files": files,
    }
    path = os.path.join(step_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return path


def verify_checkpoint(step_dir: str, full: bool = True
                      ) -> tuple[str, str]:
    """Verify a step directory against its manifest -> ``(status, detail)``.

    ``status`` is one of:

    - ``"valid"`` — every manifest entry exists with the recorded size
      (and, with ``full=True``, the recorded CRC32);
    - ``"unverified"`` — no manifest (a pre-manifest / legacy checkpoint,
      or a crash between save-finalize and manifest write): nothing to
      check against, callers treat it as restorable;
    - ``"corrupt"`` — a file is missing, truncated, or checksum-mismatched
      (or the manifest itself is unreadable).

    ``full=False`` checks existence + byte sizes only (catches truncation,
    the dominant real-world corruption, without re-hashing gigabytes) —
    the retention path uses it; restore uses the full check.
    """
    if not os.path.isdir(step_dir):
        return "corrupt", "step directory missing"
    manifest_path = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.exists(manifest_path):
        return "unverified", "no integrity manifest"
    try:
        with open(manifest_path) as fh:
            manifest = json.load(fh)
        files = manifest["files"]
        if not isinstance(files, dict):
            raise KeyError("files")
    except (OSError, ValueError, KeyError) as e:
        return "corrupt", f"unreadable manifest: {e}"
    for rel, meta in files.items():
        path = os.path.join(step_dir, rel)
        # OSErrors map to "corrupt", not exceptions: a file can vanish
        # between the listing and the read (another process's retention
        # deleting this very step) and the caller's answer is the same —
        # this checkpoint is not restorable as manifested.
        try:
            size = os.path.getsize(path)
            if size != meta.get("bytes"):
                return "corrupt", (f"size mismatch {rel}: "
                                   f"{size} != {meta.get('bytes')}")
            if full and _crc32_file(path) != meta.get("crc32"):
                return "corrupt", f"checksum mismatch {rel}"
        except OSError as e:
            return "corrupt", f"unreadable file {rel}: {e}"
    mode = "checksums" if full else "sizes"
    return "valid", f"{len(files)} files verified ({mode})"


def restore_raw(logdir: str, step: int | None = None):
    """Restore raw arrays from ``<logdir>/checkpoints``.

    Returns ``(restored_dict, step, all_steps)``; array leaves are CPU
    tensors, sequences lists.  Raises ``FileNotFoundError`` when the
    directory or any checkpoint is missing, ``ValueError`` when the
    requested ``step`` does not exist or the layout is not one this reader
    takes, ``ImportError`` naming the package a layout needs.
    """
    steps = open_checkpoints(logdir)
    if step is None:
        step = steps[-1]
    if step not in steps:
        raise ValueError(f"step {step} not found (available: {steps})")
    item_dir = os.path.join(logdir, "checkpoints", str(step), ITEM_NAME)
    return read_item(item_dir), step, steps


def save_raw(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` as the checkpoint ``<ckpt_dir>/<step>`` in orbax's
    ``StandardSave`` layout (``use_ocdbt: false``); returns the step
    directory.

    ``tree`` is nested dicts, lists and tuples of tensors or numpy arrays
    (the JAX trainer's is ``{params, opt_state, global_step[, ...]}``).
    The item is written under ``<step>.orbax-checkpoint-tmp`` (which
    :func:`list_step_dirs` does not list), finalized by ``os.replace`` and
    then given its manifest, so a reader sees no half-written step.
    Raises ``FileExistsError`` when the step exists.
    """
    final = os.path.join(ckpt_dir, str(int(step)))
    if os.path.exists(final):
        raise FileExistsError(f"checkpoint {final} exists")
    tmp = final + ".orbax-checkpoint-tmp"
    shutil.rmtree(tmp, ignore_errors=True)    # an interrupted save's remains
    started = time.time_ns()
    write_item(os.path.join(tmp, ITEM_NAME), tree)
    with open(os.path.join(tmp, CHECKPOINT_METADATA_NAME), "w") as fh:
        json.dump({"item_handlers": {ITEM_NAME: _ORBAX_HANDLER},
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": started,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, fh)
    os.replace(tmp, final)
    write_manifest(final)
    return final
