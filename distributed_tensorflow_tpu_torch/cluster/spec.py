"""Cluster spec & process bring-up (C4/C5, N1), copied from the JAX package.

The reference parses ``ps_hosts``/``worker_hosts`` into a ``tf.train.ClusterSpec``
and starts an in-process gRPC server (reference ``distributed.py:49-57``).  On
TPU there is no parameter server and no per-tensor gRPC transport: each
TPU-VM host runs one identical process, bulk data rides ICI collectives, and
only a thin control plane (discovery/barrier/health) crosses DCN.

:class:`ClusterSpec` keeps the same construction API so launch scripts port
unchanged; ``job_name='ps'`` is accepted and mapped onto the coordination
service role (the closest capability: a process that serves control-plane
state and blocks in ``join()``, ``distributed.py:55-56``).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ClusterSpec:
    """Named job → host list mapping (API parity with ``tf.train.ClusterSpec``)."""

    jobs: dict[str, list[str]] = field(default_factory=dict)

    def __init__(self, jobs: dict[str, list[str] | str]):
        parsed = {}
        for name, hosts in jobs.items():
            if isinstance(hosts, str):
                hosts = [h for h in hosts.split(",") if h]
            parsed[name] = list(hosts)
        self.jobs = parsed

    def job_tasks(self, job_name: str) -> list[str]:
        return self.jobs.get(job_name, [])

    def num_tasks(self, job_name: str) -> int:
        return len(self.jobs.get(job_name, []))

    @property
    def num_workers(self) -> int:
        # Reference: num_workers = len(worker_spec) (distributed.py:52).
        return self.num_tasks("worker")

    def task_address(self, job_name: str, task_index: int) -> str:
        tasks = self.job_tasks(job_name)
        if not 0 <= task_index < len(tasks):
            raise ValueError(f"task_index {task_index} out of range for job "
                             f"{job_name!r} with {len(tasks)} tasks")
        return tasks[task_index]

    @property
    def coordinator_address(self) -> str:
        """Control-plane address: first 'ps' host if present, else worker 0's
        host at port+1000.

        This is how the reference's PS address is reinterpreted: the host that
        used to own the parameters now merely hosts the coordination service.
        The port offset in the no-PS topology avoids colliding with worker 0's
        own port, which ``torch.distributed``'s TCP rendezvous binds as its store.
        """
        for job in ("ps", "coordinator"):
            tasks = self.job_tasks(job)
            if tasks:
                return tasks[0]
        host, port = self.task_address("worker", 0).rsplit(":", 1)
        return f"{host}:{int(port) + 1000}"


def is_chief(task_index: int) -> bool:
    """Chief election, reference semantics: task 0 (``distributed.py:58``)."""
    return task_index == 0
