"""Serving tier of the port: the continuous-batching engine
(:mod:`.engine`) over a paged KV pool (:mod:`.kv_pool`), fair
per-tenant queues (:mod:`.scheduler`), SLOs (:mod:`.slo`), and the HTTP
frontend and client (:mod:`.server`, :mod:`.client`); N replicas behind
one statz-routed, SLO-autoscaled frontend (:mod:`.router`) and cells
behind a global router (:mod:`.cells`).

Imports stay lazy at this level: the host-only modules load without
torch touching a device."""

from .kv_pool import OutOfPages, PageAllocator
from .router import AutoscalePolicy, Router, choose_replica, replica_load
from .scheduler import (DEFAULT_TENANT, FairScheduler, QueueFull, Request,
                        TenantConfig, parse_tenants)
from .slo import Objective, SloEngine, parse_slos

__all__ = [
    "AutoscalePolicy", "DEFAULT_TENANT", "FairScheduler", "Objective",
    "OutOfPages", "PageAllocator", "QueueFull", "Request", "Router",
    "SloEngine", "TenantConfig", "choose_replica", "parse_slos",
    "parse_tenants", "replica_load",
]
