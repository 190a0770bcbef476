"""Timing, device memory, the loop profiler and the MFU model; the
counterpart of ``distributed_tensorflow_tpu/utils/profiling.py`` (and of
the two functions of ``tools/check_mfu.py`` that the trainer's telemetry
uses), on ``torch.cuda`` and ``torch.profiler`` in place of XLA's.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator

import torch

#: Dense bf16 peak of one card by its name (NVIDIA's data sheet, SXM part,
#: no sparsity).  Cards not listed give no MFU.
PEAK_BF16_FLOPS = {"H100": 989e12}


class Timer:
    """Wall-clock timer (``with Timer() as t: ...; t.elapsed``)."""

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        self.elapsed = 0.0
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0


def device_memory_stats(device: torch.device) -> dict:
    """``bytes_in_use``, ``peak_bytes_in_use`` and ``bytes_limit`` of a
    CUDA device from the caching allocator; zeros on the CPU, which
    reports none."""
    if device.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory}


def peak_flops_per_device(device: torch.device) -> float | None:
    """The card's dense bf16 peak, or None (the CPU, unlisted cards)."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in PEAK_BF16_FLOPS.items():
        if key in name:
            return peak
    return None


def train_step_flops(n_params: int, tokens: int, *, num_layers: int = 0,
                     hidden_size: int = 0, seq_len: int = 0,
                     window: int = 0) -> float:
    """Analytic model FLOPs of ONE optimizer step over ``tokens`` examples
    (rows for classifiers, B*S for language models): a forward of ``2 *
    params * tokens`` plus, with the transformer dims, ``4 * L * tokens *
    kv_len * H`` of attention; a train step is 3 forwards (the JAX
    package's ``tools/check_mfu.train_step_flops``)."""
    fwd = 2.0 * n_params * tokens
    if num_layers and hidden_size and seq_len:
        kv_len = min(seq_len, window + 1) if window else seq_len
        fwd += 4.0 * num_layers * tokens * kv_len * hidden_size
    return 3.0 * fwd


@contextlib.contextmanager
def trace(profile_dir: str | os.PathLike, device: torch.device
          ) -> Iterator[None]:
    """Profile the enclosed work with ``torch.profiler`` (the card's
    kernels too on CUDA) into ``profile_dir``: a chrome trace
    (``trace.json``) and ``summary.json`` with the window's wall ms, the
    card's busy ms (the sum of its kernels' device times; user annotations
    are not kernels), their share of the window (null on the CPU) and the
    ten kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(profile_dir, exist_ok=True)
    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(device)
        window_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    kernels = []
    if cuda:
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if (us > 0 and e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)):
                kernels.append((e.key[:60], us / 1e3, e.count))
    kernels.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in kernels)
    summary = {"device": (torch.cuda.get_device_name(device) if cuda
                          else str(device)),
               "window_ms": window_ms,
               "device_busy_ms": busy_ms if cuda else None,
               "busy_share": busy_ms / window_ms if kernels else None,
               "top_kernels": [list(k) for k in kernels[:10]]}
    with open(os.path.join(profile_dir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
