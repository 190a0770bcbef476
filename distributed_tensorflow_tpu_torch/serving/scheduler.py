"""Multi-tenant admission control + fair scheduling for the decode engine.

Two jobs, both at the REQUEST granularity (the engine schedules tokens;
this module schedules whose request gets the next free slot):

- **Admission control / backpressure** — every tenant owns a bounded
  queue; a submit past the bound raises :class:`QueueFull`, which the
  frontend maps to HTTP 429 (the client's signal to back off).  Bounded
  queues are what keep an overloaded server's latency bounded instead of
  letting the queue — and every caller's tail latency — grow without
  limit.
- **Weighted fair ordering** — when a slot frees, the next request comes
  from the eligible tenant with the smallest *normalized service*
  (served tokens / weight): start-time fair queuing over token service.
  A flooding tenant saturates its share; a light tenant's occasional
  request schedules at the front because its normalized service lags.
  New tenants join at the CURRENT minimum service (not zero) so an
  idle-then-bursty tenant cannot claim infinite catch-up credit.

Thread-safe: HTTP handler threads submit; the engine thread pops.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Callable

#: Tenant a request lands in when it names none.
DEFAULT_TENANT = "default"


class QueueFull(RuntimeError):
    """The tenant's queue is at its bound — backpressure (HTTP 429)."""


@dataclasses.dataclass
class TenantConfig:
    name: str
    weight: float = 1.0          # share of service under contention
    max_queue: int = 64          # queued (not yet admitted) request bound

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.max_queue < 1:
            raise ValueError(f"tenant {self.name!r}: max_queue must be >= 1")


class Request:
    """One generate request's lifecycle record (queue -> slot -> done)."""

    _ids = itertools.count()

    def __init__(self, prompt: list[int], num_tokens: int, *,
                 tenant: str = DEFAULT_TENANT, eos_id: int | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 speculative: bool = False):
        self.id = next(Request._ids)
        self.tenant = tenant
        self.prompt = [int(t) for t in prompt]
        self.num_tokens = int(num_tokens)
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        # Opt-in to the engine's speculative decode arm (greedy-only;
        # honored when the server runs with spec_k >= 2, plain decode
        # otherwise — token-for-token identical either way).
        self.speculative = bool(speculative)
        self.spec_rounds = 0              # engine steps this lane rode
        self.tokens: list[int] = []       # generated tokens (appended live)
        self.error: str | None = None
        self.abandoned = False            # caller gave up; retire early
        self.event = threading.Event()    # set on completion/error
        # Latency waypoints (perf_counter seconds).  t_submit_unix is the
        # epoch twin of t_submit: request spans need absolute timestamps
        # so tools/export_trace.py can place them on the cluster timeline
        # (perf_counter is process-relative).
        self.t_submit = time.perf_counter()
        self.t_submit_unix = time.time()
        self.t_admit: float | None = None
        self.t_first_token: float | None = None
        self.t_done: float | None = None
        # Tracing anchors (utils/tracing.py): the root span id is
        # pre-allocated at first touch by a tracer-aware stage (queue pop
        # or admission) so children emitted live can parent under it; the
        # root span itself is emitted at retirement.
        self.span_root = 0
        self.trace: str | None = None     # "<run_id>/req<id>" when traced
        # Cross-tier wire context (X-DTF-* headers, docs/observability.md
        # "Cross-tier tracing"): wire_parent is the upstream tier's span
        # id the engine's root serve.request span nests under (0 = this
        # process IS the root); trace_forced means an upstream tier
        # already ruled the trace interesting, so the tail sampler must
        # keep it regardless of the local verdict.
        self.wire_parent = 0
        self.trace_forced = False

    # Derived latency figures (ms); None until the waypoint exists.
    @property
    def queue_ms(self) -> float | None:
        if self.t_admit is None:
            return None
        return (self.t_admit - self.t_submit) * 1e3

    @property
    def ttft_ms(self) -> float | None:
        """Time to first token, from SUBMIT (queue wait included — that is
        the latency the caller feels)."""
        if self.t_first_token is None:
            return None
        return (self.t_first_token - self.t_submit) * 1e3

    @property
    def tpot_ms(self) -> float | None:
        """Time per output token after the first (decode cadence)."""
        if (self.t_done is None or self.t_first_token is None
                or len(self.tokens) < 2):
            return None
        return ((self.t_done - self.t_first_token) * 1e3
                / (len(self.tokens) - 1))

    @property
    def e2e_ms(self) -> float | None:
        """Submit-to-done latency — the figure e2e SLOs are written on."""
        if self.t_done is None:
            return None
        return (self.t_done - self.t_submit) * 1e3


class _TenantState:
    __slots__ = ("config", "queue", "served_tokens", "admitted",
                 "rejected", "completed", "queued_hwm", "abandoned")

    def __init__(self, config: TenantConfig):
        self.config = config
        self.queue: collections.deque[Request] = collections.deque()
        self.served_tokens = 0.0   # service accounted so far
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.queued_hwm = 0        # queue-depth high-water mark
        self.abandoned = 0         # caller-gave-up retirements


class FairScheduler:
    """Bounded per-tenant queues + weighted min-service request pop."""

    def __init__(self, tenants: list[TenantConfig] | None = None,
                 default_max_queue: int = 64):
        self._lock = threading.Lock()
        self._default_max_queue = int(default_max_queue)
        self._tenants: dict[str, _TenantState] = {}
        self._depth_hwm = 0
        for cfg in tenants or ():
            self._tenants[cfg.name] = _TenantState(cfg)

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            # Unknown tenants are first-class (multi-tenant without
            # preregistration): default weight, default bound, and service
            # starting at the current minimum so they get no retroactive
            # catch-up credit.
            st = _TenantState(TenantConfig(
                tenant, max_queue=self._default_max_queue))
            floor = min((t.served_tokens / t.config.weight
                         for t in self._tenants.values()), default=0.0)
            st.served_tokens = floor * st.config.weight
            self._tenants[tenant] = st
        return st

    def submit(self, request: Request) -> None:
        """Queue the request, or raise :class:`QueueFull` (backpressure)."""
        with self._lock:
            st = self._state(request.tenant)
            if len(st.queue) >= st.config.max_queue:
                st.rejected += 1
                raise QueueFull(
                    f"tenant {request.tenant!r} queue is at its bound "
                    f"({st.config.max_queue}); retry with backoff")
            st.queue.append(request)
            st.queued_hwm = max(st.queued_hwm, len(st.queue))
            self._depth_hwm = max(self._depth_hwm, sum(
                len(t.queue) for t in self._tenants.values()))

    def next_request(self, admissible: Callable[[Request], bool]
                     = lambda r: True) -> Request | None:
        """Pop the head request of the min-normalized-service tenant whose
        head passes ``admissible`` (e.g. "fits the free KV pages").

        ``admissible`` runs UNDER the scheduler lock (the admissibility
        check and the pop must be atomic against concurrent submits), so
        it must be a cheap, lock-ordered predicate: it may take locks
        that are leaves in the acquisition order (the engine's
        ``can_admit`` -> ``PageAllocator`` lock) and must never call
        back into the scheduler — dtflint's lock-callback rule flags
        this site, baselined with exactly this contract, and a violating
        caller shows up under ``DTF_LOCKCHECK=1``.

        Heads that were abandoned while queued are dropped in passing.
        Head-of-line only — a tenant's own requests stay FIFO (its second
        request must not overtake its first into a freed slot)."""
        with self._lock:
            ranked = sorted(
                (st for st in self._tenants.values() if st.queue),
                key=lambda st: st.served_tokens / st.config.weight)
            for st in ranked:
                while st.queue and st.queue[0].abandoned:
                    st.queue.popleft()
                    st.abandoned += 1
                if st.queue and admissible(st.queue[0]):
                    st.admitted += 1
                    return st.queue.popleft()
            return None

    def account(self, tenant: str, tokens: int) -> None:
        """Charge generated tokens to the tenant's service total."""
        with self._lock:
            self._state(tenant).served_tokens += tokens

    def complete(self, tenant: str) -> None:
        with self._lock:
            self._state(tenant).completed += 1

    def note_abandoned(self, tenant: str) -> None:
        """Count an abandoned-caller retirement against the tenant (the
        engine retires the lane; this keeps the per-tenant books)."""
        with self._lock:
            self._state(tenant).abandoned += 1

    def drain(self) -> list[Request]:
        """Empty every queue and return the popped requests (fatal
        shutdown path).  Deliberately does NOT touch the admitted/
        completed tallies — these requests were never served, and a
        /statz scrape of the dead-but-still-listening server must not
        report them as if they were."""
        with self._lock:
            out: list[Request] = []
            for st in self._tenants.values():
                out.extend(st.queue)
                st.queue.clear()
            return out

    def depth(self) -> int:
        with self._lock:
            return sum(len(st.queue) for st in self._tenants.values())

    def depth_hwm(self) -> int:
        """All-tenants queue-depth high-water mark since startup."""
        with self._lock:
            return self._depth_hwm

    def stats(self) -> dict[str, dict]:
        with self._lock:
            return {
                name: {
                    "weight": st.config.weight,
                    "max_queue": st.config.max_queue,
                    "queued": len(st.queue),
                    "queued_hwm": st.queued_hwm,
                    "admitted": st.admitted,
                    "completed": st.completed,
                    "rejected": st.rejected,
                    "abandoned": st.abandoned,
                    "served_tokens": int(st.served_tokens),
                }
                for name, st in sorted(self._tenants.items())
            }


def parse_tenants(spec: str) -> list[TenantConfig]:
    """``"name[:weight[:max_queue]],..."`` -> tenant configs (the CLI
    flag format; an empty spec configures nothing — tenants then
    self-register at defaults on first request)."""
    out = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        fields = part.split(":")
        if len(fields) > 3 or not fields[0]:
            raise ValueError(f"bad tenant spec {part!r}; "
                             "want name[:weight[:max_queue]]")
        cfg = TenantConfig(
            fields[0],
            weight=float(fields[1]) if len(fields) > 1 else 1.0,
            max_queue=int(fields[2]) if len(fields) > 2 else 64)
        out.append(cfg)
    return out
