"""Thin serving client — the wire format of docs/serving.md as methods.

Stdlib-only (urllib over HTTP/1.1) so any process in the repo — tests,
bench legs, ci.sh snippets — can drive a serving process without extra
dependencies.  Errors map back from status codes:
:class:`Backpressure` (429), :class:`Overloaded` (503), ``ValueError``
(400), ``RuntimeError`` (500/other).

Connection-level failures (refused/reset — the target process is gone or
restarting, nothing was served) are retried with bounded exponential
backoff before surfacing as a typed :class:`ReplicaUnavailable`; a fleet
frontend (``serving/router.py``) failing over, or a replica respawning
behind it, is therefore invisible to a caller that rides out the backoff
window instead of seeing a raw socket error.  Timeouts are deliberately
NOT retried: a request that timed out mid-flight may still be executing,
and resending it is the caller's decision, not the transport's.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

from ..utils import tracing


class Backpressure(RuntimeError):
    """HTTP 429: the tenant's queue is at its bound — retry with backoff."""


class Overloaded(RuntimeError):
    """HTTP 503: the request waited past the server's timeout."""


class ReplicaUnavailable(RuntimeError):
    """No TCP conversation at all (connection refused/reset, retries
    exhausted): the serving process is dead or still booting.  A router
    treats this as "fail over to another replica"; a direct caller as
    "the server is down"."""


class ServeClient:
    """``ServeClient("http://127.0.0.1:8700").generate([1,2,3], 8)``.

    ``retries``/``backoff_s`` bound the connection-failure retry loop
    (``retries=0`` disables it — the router's forwarding path does this
    so ITS failover logic, not the transport, owns the retry decision).
    """

    def __init__(self, base_url: str, timeout_s: float = 180.0, *,
                 retries: int = 3, backoff_s: float = 0.1):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)

    def _request(self, path: str, payload: dict | None = None,
                 headers: dict[str, str] | None = None) -> dict:
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data,
            headers={"Content-Type": "application/json", **(headers or {})})
        delay = self.backoff_s
        for attempt in range(self.retries + 1):
            try:
                with urllib.request.urlopen(
                        req, timeout=self.timeout_s) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                try:
                    detail = json.loads(e.read()).get("error", "")
                except Exception:
                    detail = ""
                if e.code == 429:
                    raise Backpressure(detail or "queue full") from None
                if e.code == 503:
                    raise Overloaded(detail or "overloaded") from None
                if e.code == 400:
                    raise ValueError(detail or "bad request") from None
                raise RuntimeError(f"HTTP {e.code}: {detail}") from None
            except (urllib.error.URLError, ConnectionError) as e:
                reason = getattr(e, "reason", e)
                if isinstance(reason, TimeoutError) and not isinstance(
                        reason, ConnectionError):
                    # The server may still be working on the request —
                    # never auto-resend past a timeout.
                    raise
                if attempt < self.retries:
                    time.sleep(delay)
                    delay *= 2
                    continue
                raise ReplicaUnavailable(
                    f"{self.base_url}: {reason}") from None
        raise AssertionError("unreachable")  # loop always returns/raises

    def generate(self, prompt: list[int], num_tokens: int = 16, *,
                 tenant: str = "default", eos_id: int | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 speculative: bool = False, trace: str | None = None,
                 trace_parent: int = 0,
                 trace_sampled: bool = False) -> dict:
        """Returns the server's response dict (``tokens`` holds
        prompt + generation; latency fields ride along).
        ``speculative`` opts into the server's paged speculative arm
        (greedy-only; same tokens either way).  ``trace`` attaches
        cross-tier trace context as ``X-DTF-*`` headers (mint one with
        :func:`utils.tracing.mint_trace` or pass an upstream context
        through); every serving tier forwards it, so the whole stack's
        spans land in ONE trace."""
        headers = (tracing.wire_headers(trace, trace_parent, trace_sampled)
                   if trace is not None else None)
        return self._request("/generate", {
            "prompt": list(prompt), "num_tokens": num_tokens,
            "tenant": tenant, "eos_id": eos_id,
            "temperature": temperature, "top_k": top_k, "top_p": top_p,
            "seed": seed, "speculative": speculative}, headers=headers)

    def health(self) -> dict:
        return self._request("/healthz")

    def stats(self) -> dict:
        return self._request("/statz")

    def fleetz(self) -> dict:
        """The fleet membership view (router processes only): router
        stats + every member's identity, state, and last /statz
        snapshot — ``watch_serve --fleet``'s feed."""
        return self._request("/fleetz")

    def cellz(self) -> dict:
        """The cell membership view (global-router processes only,
        ``serving/cells.py``): global stats + every cell's identity,
        state, tenant homes, and last fleet-router snapshot —
        ``watch_serve --cells``'s feed."""
        return self._request("/cellz")
