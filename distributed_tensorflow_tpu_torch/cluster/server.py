"""Process bring-up, the ``tf.train.Server`` equivalent (N1 control plane);
the counterpart of ``distributed_tensorflow_tpu/cluster/server.py``.

Reference behaviour matched (``distributed.py:54-56,125``): constructing a
server starts the distributed runtime for this process; PS processes park
in ``join()``.  As in the JAX package, what is left of the PS is the
control plane: the process at the coordination address hosts the C++
coordination service (:mod:`.coordination`: discovery, barrier, health,
restart detection, KV), and every worker talks to it.

Where the JAX server forms the multi-host JAX runtime
(``jax.distributed.initialize`` at worker 0), this one forms a
``torch.distributed`` process group: ``init_method=tcp://<worker 0's
address>``, ``world_size = num_workers``, ``rank = task_index``, and a
finite ``timeout`` so a collective with a dead peer raises instead of
hanging.  The JAX policy is kept: only sync workers, only when
``num_workers > 1``, and not when ``DTF_TORCH_DISABLE_DISTRIBUTED=1`` (the
counterpart of ``DTF_TPU_DISABLE_JAX_DISTRIBUTED``; each worker then trains
alone, as the JAX multi-process tests run them).

**The backend rule**, chosen up front from the worker's device and
printed on its bring-up line, never a fallback taken after a failure:

- ``gloo`` for a CPU device;
- ``nccl`` for CUDA when every worker process has a card of its own
  (``num_workers <= torch.cuda.device_count()``: worker ``i`` of a cluster
  on one host takes card ``i``);
- ``gloo`` on CUDA tensors when the workers share a card: NCCL refuses two
  ranks on one device ("Duplicate GPU detected").
"""

from __future__ import annotations

import datetime
import os

import torch

from .spec import ClusterSpec, is_chief

#: Set to 1 to keep sync workers out of a process group.
DISABLE_ENV = "DTF_TORCH_DISABLE_DISTRIBUTED"
#: How long a collective (and the group's rendezvous) waits for a peer
#: before it raises: long enough for the chief's restore, finite so a dead
#: peer fails the step instead of hanging it.
COLLECTIVE_TIMEOUT_S = 300.0


def worker_device(name: str, task_index: int) -> torch.device:
    """The card a worker trains on: ``--device=cuda`` without an index
    means card ``task_index % device_count`` (one card a worker where
    there are enough); an explicit ``cuda:N`` or ``cpu`` is kept."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass --device=cpu to run on the CPU")
        device = torch.device("cuda", task_index % torch.cuda.device_count())
    return device


def choose_backend(device: torch.device, num_workers: int) -> tuple[str, str]:
    """``(backend, reason)`` by the module's rule."""
    if device.type != "cuda":
        return "gloo", f"{device.type} tensors"
    cards = torch.cuda.device_count()
    if num_workers <= cards:
        return "nccl", f"a card for each of {num_workers} workers"
    return "gloo", (f"{num_workers} workers share {cards} card(s); NCCL "
                    "refuses two ranks on one device")


class Server:
    """One per process.  Forms the process group and exposes the
    control-plane handle the supervisor layer uses.

    ``coord_instances > 1`` hosts the sharded coordination plane, as the
    JAX server does: instance ``i`` on the coordination port + ``i``
    carrying shard identity ``(i, N)``, instance 0 the control shard, and
    the workers talk to it through a
    :class:`.coordination.CoordinationRouter`.  ``coord_standbys`` wires
    warm-standby endpoint lists (a plain ``h:p,...`` list for the control
    shard, or ``0:h:p;1:h:p`` a KV shard), walked on a dead or demoted
    primary (:func:`.coordination.parse_standby_map`)."""

    def __init__(self, cluster: ClusterSpec, job_name: str, task_index: int,
                 *, device: torch.device | None = None,
                 initialize_distributed: bool | None = None,
                 coord_service: bool = True,
                 heartbeat_timeout: float = 10.0,
                 kv_persist_path: str | None = None,
                 coord_instances: int = 1,
                 coord_standbys: str | None = None):
        self.cluster = cluster
        self.job_name = job_name
        self.task_index = task_index
        self.is_chief = is_chief(task_index) and job_name == "worker"
        self._coord_server = None
        self._coord_extra_servers: list = []
        self._coord_client = None
        if coord_instances < 1:
            raise ValueError(
                f"coord_instances must be >= 1, got {coord_instances}")
        self.backend: str | None = None
        self.backend_reason = ""
        self.process_group = False

        num_workers = cluster.num_workers
        if initialize_distributed is None:
            initialize_distributed = (
                num_workers > 1 and job_name == "worker"
                and os.environ.get(DISABLE_ENV, "0") != "1")
        if initialize_distributed:
            import torch.distributed as dist
            if device is None:
                raise ValueError("a process group needs the worker's device")
            self.backend, self.backend_reason = choose_backend(device,
                                                               num_workers)
            if self.backend == "nccl":
                torch.cuda.set_device(device)
            dist.init_process_group(
                backend=self.backend,
                init_method=f"tcp://{cluster.task_address('worker', 0)}",
                world_size=num_workers, rank=task_index,
                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
            self.process_group = True

        if coord_service:
            from . import coordination
            addr = cluster.coordinator_address
            host, port = addr.rsplit(":", 1)
            if job_name == "ps" or (job_name == "worker" and self.is_chief
                                    and not cluster.job_tasks("ps")):
                # The process at the coordination address hosts the service
                # — the PS role's surviving responsibility — and, with
                # coord_instances > 1, the whole sharded plane.
                for i in range(coord_instances):
                    srv = coordination.CoordinationServer(
                        port=int(port) + i, num_tasks=max(num_workers, 1),
                        heartbeat_timeout=heartbeat_timeout,
                        persist_path=(f"{kv_persist_path}.shard{i}"
                                      if kv_persist_path and i else
                                      kv_persist_path),
                        shard=i, nshards=coord_instances)
                    srv.start()
                    if i == 0:
                        self._coord_server = srv
                    else:
                        self._coord_extra_servers.append(srv)
            if job_name == "worker":
                standby_map = coordination.parse_standby_map(coord_standbys)
                if coord_instances > 1:
                    spec = ",".join(f"{host}:{int(port) + i}"
                                    for i in range(coord_instances))
                    self._coord_client = coordination.CoordinationRouter(
                        spec, task_id=task_index, standbys=standby_map)
                else:
                    self._coord_client = coordination.CoordinationClient(
                        host, int(port), task_id=task_index,
                        standbys=standby_map.get(0))

    @property
    def coordination_client(self):
        return self._coord_client

    @property
    def world_size(self) -> int:
        if not self.process_group:
            return 1
        import torch.distributed as dist
        return dist.get_world_size()

    def join(self) -> None:
        """Block forever serving the control plane (PS parity,
        ``distributed.py:55-56``)."""
        if self._coord_server is not None:
            self._coord_server.join()
        else:  # pragma: no cover - degenerate config
            import threading
            threading.Event().wait()

    def shutdown(self) -> None:
        if self._coord_client is not None:
            # Voluntary departure: LEAVE shrinks the membership set at once;
            # best-effort (leave() swallows coordination errors).
            self._coord_client.leave()
            self._coord_client.close()
            self._coord_client = None
        if self.process_group:
            import torch.distributed as dist
            dist.destroy_process_group()
            self.process_group = False
        for srv in self._coord_extra_servers:
            srv.stop()
        self._coord_extra_servers = []
        if self._coord_server is not None:
            self._coord_server.stop()
            self._coord_server = None
