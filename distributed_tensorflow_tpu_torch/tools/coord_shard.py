"""Sharded coordination plane launcher (docs/param_exchange.md,
"Hierarchical exchange") and coordinator-HA tooling
(docs/fault_tolerance.md, "Coordinator HA").

Copied from ``distributed_tensorflow_tpu/tools/coord_shard.py`` (standard
library only; the port's imports).

Brings up a set of coordination-service instances from one flag — the
multi-instance counterpart of the PS role's single server.  Instance
``i`` listens on ``--port + i`` and carries shard identity ``(i, N)``
(the ``SHARDINFO`` protocol command); instance 0 is the **control
shard** every membership/barrier/lease/stats command goes to, the rest
carry only the KV/blob traffic a :class:`..cluster.coordination.
CoordinationRouter` hashes their way.

Usage::

    python -m distributed_tensorflow_tpu_torch.tools.coord_shard \
        --port 2222 --instances 2 --num_tasks 4 \
        [--heartbeat_timeout 10] [--persist_dir DIR]

Workers then point a router at the printed spec, e.g.
``CoordinationRouter("host:2222,host:2223", task_id)`` — or pass
``--coord_instances=2`` to ``train.py``, which derives the same spec
from the coordinator address.

``--persist_dir`` journals each instance's KV store to
``<dir>/coord_shard<i>.journal`` (per-instance files: each shard's keys
are disjoint by construction, so there is nothing to merge).

**Coordinator HA**: ``--standby_of HOST:PORT`` launches this process as
a warm STANDBY of that instance instead — it snapshot-bootstraps,
applies the primary's journal stream, and promotes itself (coordinator
generation bump) once the leadership lease (``--lease_timeout``)
expires without primary contact::

    python -m distributed_tensorflow_tpu_torch.tools.coord_shard \
        --port 2232 --num_tasks 4 --standby_of host:2222

Workers take the standby set via ``train.py --coord_standbys=host:2232``
(an ordered endpoint list their clients walk on failure).

**KV-shard HA** (docs/fault_tolerance.md, "KV-shard HA"): standbys are
not limited to the control shard.  ``--shard_index I --nshards N`` runs
ONE instance carrying shard identity ``(I, N)`` as its own OS process —
so every member of a sharded plane (and every member's standby) is
separately launchable, probeable, and SIGKILLable::

    # shard 1 of 2: primary on 2223, warm standby on 2233
    python -m ...coord_shard --port 2223 --shard_index 1 --nshards 2 \
        --num_tasks 4
    python -m ...coord_shard --port 2233 --shard_index 1 --nshards 2 \
        --num_tasks 4 --standby_of host:2223

Workers wire the per-instance standby map via
``train.py --coord_standbys='0:host:2232;1:host:2233'``.

``--state_file PATH`` records this process's members in a JSON state
map (merged across processes) so chaos tooling
(``utils/faults.py``) can SIGKILL a specific instance's primary or
standby by pid.  ``--status HOST:PORT[,HOST:PORT...]`` probes each
listed instance's ``INFO``/``SHARDINFO`` and prints shard identity,
role, coordinator generation, standby count, replication lag (records
behind the primary), and last-promotion age — the one-glance check
that no shard of the plane is running standby-less.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading


def launch_instances(port: int, instances: int, num_tasks: int,
                     heartbeat_timeout: float = 10.0,
                     persist_dir: str | None = None,
                     host: str = "localhost",
                     standby_of: str | None = None,
                     lease_timeout: float = 2.0,
                     shard_index: int | None = None,
                     nshards: int | None = None):
    """Start ``instances`` CoordinationServers on consecutive ports;
    returns ``(servers, spec)`` where ``spec`` is the comma-separated
    address list a CoordinationRouter takes.  With ``standby_of`` set,
    the single instance launches as a warm standby of that primary.
    ``shard_index``/``nshards`` pin a SINGLE instance's shard identity
    (the standalone per-shard mode): primary or standby of any shard of
    a sharded plane, one OS process each."""
    from ..cluster.coordination import CoordinationServer

    if instances < 1:
        raise ValueError(f"instances must be >= 1, got {instances}")
    if shard_index is not None:
        if instances != 1:
            raise ValueError("--shard_index pins ONE instance's shard "
                             "identity; it cannot combine with "
                             "--instances > 1")
        if nshards is None or not 0 <= shard_index < nshards:
            raise ValueError(f"--shard_index {shard_index} needs "
                             f"0 <= shard_index < --nshards ({nshards})")
    elif standby_of and instances != 1:
        raise ValueError("--standby_of runs a single standby; launch one "
                         "process per shard member (--shard_index/"
                         "--nshards), not --instances > 1")
    servers = []
    try:
        for i in range(instances):
            shard = shard_index if shard_index is not None else i
            total = nshards if shard_index is not None else instances
            if persist_dir:
                # Standbys journal separately — same directory must not
                # collide with the primary's per-shard journal.
                name = (f"coord_shard{shard}.standby.journal" if standby_of
                        else f"coord_shard{shard}.journal")
                persist = os.path.join(persist_dir, name)
            else:
                persist = None
            srv = CoordinationServer(
                port=port + i if port else 0, num_tasks=num_tasks,
                heartbeat_timeout=heartbeat_timeout, persist_path=persist,
                shard=shard, nshards=total, standby_of=standby_of,
                lease_timeout=lease_timeout,
                # Peer standbys probe this address at promotion time;
                # with an ephemeral port the server's loopback default
                # (which knows the bound port) is the right answer.
                advertise_addr=f"{host}:{port + i}" if port else None)
            srv.start()
            servers.append(srv)
    except Exception:
        for srv in servers:
            srv.stop()
        raise
    spec = ",".join(f"{host}:{srv.port}" for srv in servers)
    return servers, spec


def write_state_map(state_file: str, servers, host: str,
                    standby_of: str | None = None,
                    shard_index: int | None = None,
                    nshards: int | None = None,
                    pid: int | None = None) -> dict:
    """Merge this process's members into the coord_shard state map — the
    JSON file chaos tooling (``utils/faults.kill_coord_instance``) reads
    to SIGKILL a specific instance's primary/standby by pid.  Entries are
    keyed by ``(instance, role, addr)``: a relaunched member replaces its
    stale row, distinct standbys of one shard coexist."""
    pid = os.getpid() if pid is None else pid
    role = "standby" if standby_of else "primary"
    mine = []
    for i, srv in enumerate(servers):
        instance = shard_index if shard_index is not None else i
        mine.append({"instance": instance, "role": role, "pid": pid,
                     "addr": f"{host}:{srv.port}",
                     "nshards": (nshards if shard_index is not None
                                 else len(servers))})
    state = {"kind": "coord_shard", "members": []}
    try:
        with open(state_file) as f:
            prior = json.load(f)
        if isinstance(prior.get("members"), list):
            state["members"] = [
                m for m in prior["members"]
                if not any(m.get("instance") == n["instance"]
                           and m.get("role") == n["role"]
                           and m.get("addr") == n["addr"] for n in mine)]
    except (OSError, ValueError):
        pass
    state["members"] += mine
    tmp = f"{state_file}.tmp.{pid}"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1)
    os.replace(tmp, state_file)
    return state


def print_status(spec: str, print_fn=print) -> int:
    """Probe each listed instance's INFO + SHARDINFO and print one
    status line per address (the ``--status`` mode) — shard identity
    first, then role/generation/replication health; returns non-zero
    when any instance is unreachable."""
    from ..cluster.coordination import CoordinationClient, CoordinationError

    rc = 0
    for addr in (a for a in spec.split(",") if a):
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            print_fn(f"{addr}: MALFORMED (want HOST:PORT)")
            rc = 1
            continue
        client = CoordinationClient.observer(host, int(port),
                                             retry_budget=2.0)
        try:
            info = client.info()
            try:
                si = client.shard_info()
                shard = f"{si.get('shard', '?')}/{si.get('nshards', '?')}"
            except CoordinationError:
                shard = "?/?"
            degraded = (info.get("role") == "primary"
                        and info.get("standbys") == 0)
            print_fn(
                f"{addr}: shard={shard} "
                f"role={info.get('role', '?')} "
                f"generation={info.get('generation', '?')} "
                f"standbys={info.get('standbys', '?')} "
                f"repl_lag={info.get('repl_lag', '?')} "
                f"repl_applied={info.get('repl_applied', '?')} "
                f"last_promotion_age_s="
                f"{info.get('last_promotion_age_s', '?')} "
                f"epoch={info.get('epoch', '?')}"
                + (" DEGRADED(no standby)" if degraded else ""))
        except CoordinationError as e:
            print_fn(f"{addr}: UNREACHABLE ({e})")
            rc = 1
        finally:
            client.close()
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--port", type=int, default=None,
                        help="base port; instance i listens on port+i "
                             "(0 = ephemeral ports, printed on stdout)")
    parser.add_argument("--instances", type=int, default=1,
                        help="coordinator instance count (default 1)")
    parser.add_argument("--num_tasks", type=int, default=None,
                        help="worker task count the control shard tracks")
    parser.add_argument("--heartbeat_timeout", type=float, default=10.0)
    parser.add_argument("--persist_dir", default=None,
                        help="journal each instance's KV store under "
                             "this directory")
    parser.add_argument("--host", default="localhost",
                        help="hostname used in the printed address spec")
    parser.add_argument("--standby_of", default=None, metavar="HOST:PORT",
                        help="run as a warm STANDBY of this instance "
                             "(docs/fault_tolerance.md, 'Coordinator HA' "
                             "/ 'KV-shard HA')")
    parser.add_argument("--lease_timeout", type=float, default=2.0,
                        help="leadership lease: seconds without primary "
                             "contact before a standby promotes itself "
                             "(default 2)")
    parser.add_argument("--shard_index", type=int, default=None,
                        help="standalone per-shard mode: run ONE instance "
                             "carrying shard identity (shard_index, "
                             "nshards) — primary, or standby with "
                             "--standby_of")
    parser.add_argument("--nshards", type=int, default=None,
                        help="total shard count for --shard_index")
    parser.add_argument("--state_file", default=None,
                        help="merge this process's {instance, role, pid, "
                             "addr} rows into a JSON state map for chaos "
                             "tooling (utils/faults.py)")
    parser.add_argument("--status", default=None,
                        metavar="HOST:PORT[,HOST:PORT...]",
                        help="probe the listed instances and print role/"
                             "generation/replication status, then exit")
    args = parser.parse_args(argv)

    if args.status:
        return print_status(args.status)
    if args.port is None or args.num_tasks is None:
        parser.error("--port and --num_tasks are required "
                     "(unless --status is given)")

    servers, spec = launch_instances(
        args.port, args.instances, args.num_tasks,
        heartbeat_timeout=args.heartbeat_timeout,
        persist_dir=args.persist_dir, host=args.host,
        standby_of=args.standby_of, lease_timeout=args.lease_timeout,
        shard_index=args.shard_index, nshards=args.nshards)
    if args.state_file:
        write_state_map(args.state_file, servers, args.host,
                        standby_of=args.standby_of,
                        shard_index=args.shard_index, nshards=args.nshards)
    shard_note = (f" shard {args.shard_index}/{args.nshards}"
                  if args.shard_index is not None else "")
    if args.standby_of:
        print(f"coord_shard: standby{shard_note} up at {spec} replicating "
              f"{args.standby_of} (lease {args.lease_timeout}s)",
              flush=True)
    else:
        print(f"coord_shard: {args.instances} instance(s){shard_note} up "
              f"at {spec} (control shard = instance 0)", flush=True)

    stop = threading.Event()

    def _stop(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    stop.wait()
    for srv in servers:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
