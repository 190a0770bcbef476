"""Device time of a short kernel call, apart from the host's: the call
captured in a CUDA graph and replayed, so the card runs the launches back
to back whatever the host's cost of issuing them.  Used by the
measurement tools and ``chip_smoke.py``; needs a GPU."""

from __future__ import annotations

import torch


def graph_ms(fn, launches: int = 50, replays: int = 20) -> float:
    """Device milliseconds per call of ``fn``, from a CUDA graph of
    ``launches`` calls replayed ``replays`` times between CUDA events.
    ``fn`` must launch on the current stream and be safe to repeat."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)
