"""The port's coordination service against the JAX package's: the port
builds its own copy of the native library (``csrc/coordination/
coord.cc``) and speaks the same protocol, so the port's client works
against the JAX package's server and the JAX client against the port's:
KV set, get and wait, barrier, health, registration.  Also the port's
cluster spec and the trainer server's backend rule."""

import threading
import time

import pytest
import torch

from distributed_tensorflow_tpu.cluster import coordination as jcoord
from distributed_tensorflow_tpu.cluster import spec as jspec
from distributed_tensorflow_tpu_torch.cluster import coordination as tcoord
from distributed_tensorflow_tpu_torch.cluster import server as tserver
from distributed_tensorflow_tpu_torch.cluster import spec as tspec

PAIRS = {"port client, JAX server": (tcoord, jcoord),
         "JAX client, port server": (jcoord, tcoord),
         "port client, port server": (tcoord, tcoord)}


@pytest.fixture(params=list(PAIRS), ids=list(PAIRS))
def pair(request):
    client_mod, server_mod = PAIRS[request.param]
    srv = server_mod.CoordinationServer(port=0, num_tasks=2,
                                        heartbeat_timeout=1.0)
    srv.start()
    clients = []

    def client(task):
        c = client_mod.CoordinationClient("127.0.0.1", srv.port, task)
        clients.append(c)
        return c
    yield client
    for c in clients:
        c.close()
    srv.stop()


def test_kv_barrier_and_health_across_packages(pair):
    c0, c1 = pair(0), pair(1)
    assert c0.register() == 0 and c1.register() == 0
    c0.kv_set("dtf/initialized", "7")
    assert c1.kv_get("dtf/initialized") == "7"
    assert c1.kv_get("missing") is None
    got = []
    waiter = threading.Thread(target=lambda: got.append(
        c1.kv_wait("late", timeout=10.0, poll_interval=0.05)))
    waiter.start()
    time.sleep(0.2)
    c0.kv_set("late", "value with spaces")
    waiter.join(timeout=10)
    assert got == ["value with spaces"]
    with pytest.raises(Exception, match="timed out"):
        c0.kv_wait("never", timeout=0.3, poll_interval=0.05)
    arrived = []
    t = threading.Thread(target=lambda: arrived.append(
        c1.barrier("b", timeout=10.0)))
    t.start()
    time.sleep(0.2)
    assert not arrived                      # waits for both tasks
    c0.barrier("b", timeout=10.0)
    t.join(timeout=10)
    assert len(arrived) == 1
    c0.heartbeat()
    c1.heartbeat()
    assert c0.health()[:2] == [True, True]
    time.sleep(1.5)                         # task 1 stops beating
    c0.heartbeat()
    assert c0.health()[:2] == [True, False]


def test_the_port_builds_its_own_native_library():
    import os
    import distributed_tensorflow_tpu_torch as port
    tcoord._load_library()
    root = os.path.dirname(port.__file__)
    assert tcoord._SRC == os.path.join(root, "csrc", "coordination",
                                       "coord.cc")
    assert tcoord._BUILD == os.path.join(root, "_build")
    with open(tcoord._SRC) as a, open(jcoord._SRC) as b:
        assert a.read() == b.read()           # one protocol


def test_cluster_spec_is_the_jax_packages():
    for jobs in ({"ps": "h0:2222", "worker": "h1:2223,h2:2224"},
                 {"worker": "localhost:2223"}):
        a, b = tspec.ClusterSpec(jobs), jspec.ClusterSpec(jobs)
        assert a.jobs == b.jobs
        assert a.coordinator_address == b.coordinator_address
        assert a.num_workers == b.num_workers
    assert tspec.is_chief(0) and not tspec.is_chief(1)


def test_backend_rule(monkeypatch):
    cpu = torch.device("cpu")
    assert tserver.choose_backend(cpu, 2)[0] == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cuda = torch.device("cuda", 0)
    backend, why = tserver.choose_backend(cuda, 2)
    assert backend == "gloo" and "share" in why
    assert tserver.choose_backend(cuda, 1)[0] == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tserver.choose_backend(cuda, 4)[0] == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tserver.worker_device("cuda", 5) == torch.device("cuda", 1)
    assert tserver.worker_device("cuda:3", 5) == torch.device("cuda", 3)
    assert tserver.worker_device("cpu", 1) == cpu
