"""Per-tenant serving SLOs — sliding windows, error budgets, burn-rate
alerts (docs/observability.md, "Serving tracing & SLOs").

An *objective* states what fraction of a tenant's requests must be good:
``search:ttft_p95_ms<=50`` reads "95% of tenant ``search``'s requests
reach their first token within 50 ms".  The complement of the target
(here 5%) is the **error budget**; the **burn rate** is how fast the
live bad-event fraction is consuming it (``bad_fraction / budget`` — 1.0
means the budget is spent exactly at the allowed rate, 20 means the
tenant will exhaust a month's budget in ~36 hours).

Alerting follows the multi-window burn-rate recipe (Google SRE workbook
§5): an objective is ``burning`` only when BOTH a short and a long
sliding window exceed the burn threshold — the short window makes the
alert fast to clear when the problem stops, the long window keeps a
brief blip from paging.  Windows are wall-clock deques of (time, bad)
events in constant-ish memory (trimmed to the long window every
observation).

Objectives cover:

- latency percentiles — ``ttft``/``tpot``/``e2e`` against a millisecond
  threshold at a percentile target (``ttft_p95_ms<=50``); a request that
  errored counts bad, a request that legitimately lacks the figure (tpot
  on a 1-token generation) is skipped;
- ``error_rate<=X`` — engine-failed / timed-out requests over completions;
- ``reject_rate<=X`` — HTTP 429 backpressure rejections over submissions
  (the queue-bound budget).

The engine is transport-agnostic and clock-injectable (tests drive
``now`` explicitly); :class:`..serving.server.ServingServer` feeds it and
periodically emits ``kind="slo"`` telemetry records that
``tools/summarize_run.py`` rolls into the report and
``tools/watch_serve.py`` renders live.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import threading
import time
from typing import Any

#: Latency metrics an objective can target (value source on the request).
LATENCY_METRICS = ("ttft_ms", "tpot_ms", "e2e_ms")
RATE_METRICS = ("error_rate", "reject_rate")

_PCT_RE = re.compile(r"^(ttft|tpot|e2e)_p(\d{2,3})_ms<=([0-9.]+)$")
_RATE_RE = re.compile(r"^(error_rate|reject_rate)<=([0-9.]+)$")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One tenant's promise: ``target`` fraction of events good.

    ``tenant`` may be ``"*"`` (applies to every tenant, evaluated over
    the merged event stream).  For latency metrics ``threshold_ms``
    defines good; for rate metrics goodness is the event itself (ok
    completion / accepted submission) and ``target = 1 - max_rate``.
    """

    tenant: str
    metric: str               # ttft_ms | tpot_ms | e2e_ms | error_rate | ...
    target: float             # good-event fraction promised, in (0, 1)
    threshold_ms: float | None = None

    def __post_init__(self):
        if self.metric not in LATENCY_METRICS + RATE_METRICS:
            raise ValueError(f"unknown SLO metric {self.metric!r}")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1), "
                             f"got {self.target}")
        if (self.metric in LATENCY_METRICS) != (self.threshold_ms
                                                is not None):
            raise ValueError("latency objectives need threshold_ms; "
                             "rate objectives must not set it")

    @property
    def budget(self) -> float:
        """Allowed bad-event fraction (the error budget)."""
        return 1.0 - self.target

    @property
    def label(self) -> str:
        """The spec-string form, e.g. ``ttft_p95_ms<=50``."""
        if self.metric in LATENCY_METRICS:
            pct = f"{self.target * 100:g}".replace(".", "")
            return (f"{self.metric[:-3]}_p{pct}_ms"
                    f"<={self.threshold_ms:g}")
        return f"{self.metric}<={self.budget:g}"


def parse_slos(spec: str) -> list[Objective]:
    """``"tenant:objective,..."`` -> objectives (the ``--slo`` CLI flag).

    Objective grammar: ``{ttft|tpot|e2e}_p{50..999}_ms<=<ms>`` (p999 =
    99.9%) or ``{error_rate|reject_rate}<=<fraction>``.  Tenant ``*``
    applies to all tenants::

        --slo "search:ttft_p95_ms<=50,search:error_rate<=0.01,
               *:e2e_p99_ms<=2000"
    """
    out: list[Objective] = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        tenant, sep, obj = part.partition(":")
        if not sep or not tenant or not obj:
            raise ValueError(f"bad SLO spec {part!r}; "
                             "want tenant:objective<=value")
        m = _PCT_RE.match(obj)
        if m:
            stem, pct, threshold = m.groups()
            # Three digits means per-mille and ONLY p999 (99.9%) — p100,
            # p500 etc. are typos that would otherwise silently parse to
            # nonsense targets (p100 -> "10% of requests fast").
            if len(pct) == 3 and pct != "999":
                raise ValueError(
                    f"bad SLO percentile p{pct} in {obj!r}; two digits "
                    "(p50..p99) or p999 (= 99.9%)")
            target = int(pct) / (1000.0 if len(pct) == 3 else 100.0)
            out.append(Objective(tenant, f"{stem}_ms", target,
                                 threshold_ms=float(threshold)))
            continue
        m = _RATE_RE.match(obj)
        if m:
            metric, rate = m.groups()
            out.append(Objective(tenant, metric, 1.0 - float(rate)))
            continue
        raise ValueError(
            f"bad SLO objective {obj!r}; want e.g. ttft_p95_ms<=50, "
            "tpot_p99_ms<=20, e2e_p50_ms<=500, error_rate<=0.01, "
            "reject_rate<=0.05")
    return out


class SloEngine:
    """Sliding-window SLO evaluation + burn-rate alerting.

    Thread-safe: the engine loop observes completions, HTTP handler
    threads observe rejections, and ``/statz``/``/metricz`` handlers
    evaluate concurrently.  ``clock`` is injectable for tests (defaults
    to ``time.monotonic``).
    """

    def __init__(self, objectives: list[Objective] | None = None, *,
                 short_window_s: float = 60.0,
                 long_window_s: float = 600.0,
                 burn_threshold: float = 14.4,
                 clock=time.monotonic):
        if long_window_s < short_window_s:
            raise ValueError("long_window_s must be >= short_window_s")
        self.objectives = list(objectives or ())
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        #: Both windows must burn at or above this multiple of the budget
        #: rate to alert — 14.4 is the classic fast-burn page threshold
        #: (a 30-day budget gone in ~2 days).
        self.burn_threshold = float(burn_threshold)
        self._clock = clock
        self._lock = threading.Lock()
        # Per-objective event windows: deque[(t, bad)] trimmed to the
        # long window; plus per-tenant completion times for live QPS.
        self._events: list[collections.deque] = [
            collections.deque() for _ in self.objectives]
        self._done: dict[str, collections.deque] = {}
        self._ever_burning: set[str] = set()

    # ------------------------------------------------------ observation

    def _matching(self, tenant: str):
        for i, obj in enumerate(self.objectives):
            if obj.tenant == "*" or obj.tenant == tenant:
                yield i, obj

    def _push(self, idx: int, bad: bool, now: float) -> None:
        q = self._events[idx]
        q.append((now, bool(bad)))
        horizon = now - self.long_window_s
        while q and q[0][0] < horizon:
            q.popleft()

    def observe_request(self, tenant: str, *, ttft_ms: float | None,
                        tpot_ms: float | None, e2e_ms: float | None,
                        ok: bool = True, now: float | None = None) -> None:
        """Fold one finished request into every matching window."""
        now = self._clock() if now is None else float(now)
        values = {"ttft_ms": ttft_ms, "tpot_ms": tpot_ms, "e2e_ms": e2e_ms}
        with self._lock:
            dq = self._done.setdefault(tenant, collections.deque())
            dq.append(now)
            horizon = now - self.long_window_s
            while dq and dq[0] < horizon:
                dq.popleft()
            for i, obj in self._matching(tenant):
                if obj.metric == "error_rate":
                    self._push(i, not ok, now)
                elif obj.metric in LATENCY_METRICS:
                    value = values[obj.metric]
                    if not ok:
                        self._push(i, True, now)
                    elif value is not None:
                        self._push(i, value > obj.threshold_ms, now)
                    # ok but no figure (tpot on a 1-token reply): skip —
                    # the event carries no evidence either way.

    def observe_admission(self, tenant: str, rejected: bool,
                          now: float | None = None) -> None:
        """Fold one submission (accepted or 429-rejected) into the
        reject-rate windows."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            for i, obj in self._matching(tenant):
                if obj.metric == "reject_rate":
                    self._push(i, rejected, now)

    # ------------------------------------------------------- evaluation

    @staticmethod
    def _window_counts(q, horizon: float) -> tuple[int, int]:
        good = bad = 0
        for t, is_bad in reversed(q):
            if t < horizon:
                break
            if is_bad:
                bad += 1
            else:
                good += 1
        return good, bad

    def evaluate(self, now: float | None = None) -> list[dict[str, Any]]:
        """Per-objective window state + burn rates (JSON-ready; the
        ``kind="slo"`` record payloads)."""
        now = self._clock() if now is None else float(now)
        out: list[dict[str, Any]] = []
        with self._lock:
            for i, obj in enumerate(self.objectives):
                q = self._events[i]
                g_s, b_s = self._window_counts(q, now - self.short_window_s)
                g_l, b_l = self._window_counts(q, now - self.long_window_s)

                def burn(good: int, bad: int) -> float:
                    total = good + bad
                    if not total:
                        return 0.0
                    return (bad / total) / obj.budget

                burn_s, burn_l = burn(g_s, b_s), burn(g_l, b_l)
                # Burn is capped at 1/budget (100% of events bad), so a
                # generous budget (> 1/threshold, e.g. a p50 objective)
                # could never reach the global threshold — alert such
                # objectives at full budget burn instead of never.
                alert_at = min(self.burn_threshold, 1.0 / obj.budget)
                burning = ((g_s + b_s) > 0
                           and burn_s >= alert_at
                           and burn_l >= alert_at)
                if burning:
                    self._ever_burning.add(f"{obj.tenant}:{obj.label}")
                entry: dict[str, Any] = {
                    "tenant": obj.tenant,
                    "objective": obj.label,
                    "metric": obj.metric,
                    "target": obj.target,
                    "budget": round(obj.budget, 6),
                    "good_short": g_s, "bad_short": b_s,
                    "good_long": g_l, "bad_long": b_l,
                    "burn_short": round(burn_s, 3),
                    "burn_long": round(burn_l, 3),
                    "burn_alert_at": round(alert_at, 3),
                    "burning": burning,
                    "window_short_s": self.short_window_s,
                    "window_long_s": self.long_window_s,
                }
                if obj.threshold_ms is not None:
                    entry["threshold_ms"] = obj.threshold_ms
                out.append(entry)
        return out

    def tenant_qps(self, now: float | None = None) -> dict[str, float]:
        """Completions per second over the short window, per tenant."""
        now = self._clock() if now is None else float(now)
        horizon = now - self.short_window_s
        with self._lock:
            return {
                tenant: round(sum(1 for t in dq if t >= horizon)
                              / self.short_window_s, 3)
                for tenant, dq in sorted(self._done.items())
            }

    def snapshot(self, now: float | None = None) -> dict[str, Any]:
        """The ``/statz``-embedded view ``watch_serve`` renders."""
        evals = self.evaluate(now)
        with self._lock:
            ever = sorted(self._ever_burning)
        return {
            "objectives": evals,
            "burning": [f"{e['tenant']}:{e['objective']}"
                        for e in evals if e["burning"]],
            "ever_burning": ever,
            "burn_threshold": self.burn_threshold,
            "window_short_s": self.short_window_s,
            "window_long_s": self.long_window_s,
            "tenant_qps": self.tenant_qps(now),
        }

    def prometheus_lines(self, now: float | None = None) -> list[str]:
        """The objectives as ``/metricz`` samples."""
        from ..utils.telemetry import _prom_escape, _prom_num
        lines = [
            "# TYPE serve_slo_burn_rate gauge",
            "# TYPE serve_slo_burning gauge",
            "# TYPE serve_slo_bad_events gauge",
        ]
        for e in self.evaluate(now):
            labels = (f'tenant="{_prom_escape(e["tenant"])}",'
                      f'objective="{_prom_escape(e["objective"])}"')
            lines.append(f'serve_slo_burn_rate{{{labels},window="short"}} '
                         f'{_prom_num(e["burn_short"])}')
            lines.append(f'serve_slo_burn_rate{{{labels},window="long"}} '
                         f'{_prom_num(e["burn_long"])}')
            lines.append(f'serve_slo_burning{{{labels}}} '
                         f'{1 if e["burning"] else 0}')
            lines.append(f'serve_slo_bad_events{{{labels}}} '
                         f'{e["bad_long"]}')
        return lines
