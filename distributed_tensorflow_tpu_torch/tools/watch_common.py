"""Shared plumbing for the live watchers (``watch_run``, ``watch_serve``,
``serve --watch``) — ONE implementation of the poll/render/exit contract.

Every watcher has the same shape: poll a snapshot, render it as a table
or dump it as JSON, sleep, repeat — with ``--once`` (one snapshot, exit
status says whether it was obtained) as the CI hook.  Before this module
each tool carried its own copy of that loop, and the copies had already
drifted: ``watch_serve`` routed unreachable-target messages to stderr so
``--once --json`` stdout stayed machine-readable, while ``watch_run``
and ``serve --watch`` printed them to stdout — corrupting exactly the
stream a CI gate pipes into ``json.loads`` (the duplicated-plumbing bug
class the dtflint telemetry-contract analyzer exists for;
docs/static_analysis.md).  The shared loop fixes the contract once:

- snapshot failures go to **stderr**, always;
- ``--once``: exit 0 on a rendered snapshot, 1 on failure;
- ``--json``: one compact JSON document per poll on stdout, nothing
  else on stdout ever.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Callable


def add_watch_args(parser: argparse.ArgumentParser,
                   interval: float = 2.0) -> None:
    """The watcher trio every tool shares: --interval/--once/--json."""
    parser.add_argument("--interval", type=float, default=interval,
                        help=f"seconds between polls (default {interval:g})")
    parser.add_argument("--once", action="store_true",
                        help="print one snapshot and exit (exit 1 if the "
                             "target is unreachable)")
    parser.add_argument("--json", action="store_true",
                        help="emit the snapshot as JSON instead of the "
                             "table (stdout carries ONLY the JSON)")


def watch_loop(fetch: Callable[[], Any], render: Callable[[Any], None], *,
               interval: float, once: bool, as_json: bool,
               describe: str, tool: str,
               transform: Callable[[Any], Any] | None = None,
               print_fn: Callable[[str], None] = print,
               sleep: Callable[[float], None] = time.sleep) -> int:
    """Poll ``fetch`` forever (or once), rendering each snapshot.

    ``fetch`` returns the raw snapshot (JSON-serializable when the tool
    supports ``--json``) or raises — ANY exception from ``fetch`` counts
    as "target unreachable", is reported to stderr (never stdout), and
    either exits 1 (``--once``) or waits out the interval and retries.
    ``transform`` (optional) post-processes the snapshot OUTSIDE that
    handler: an analysis bug must crash loudly as itself, not be
    misreported as an unreachable target.  ``describe`` names the
    target in the unreachable message; ``tool`` prefixes it.
    """
    while True:
        try:
            snapshot = fetch()
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — keep watching
            # stderr by contract: --json mode's stdout is a
            # machine-readable stream and must not be corrupted by
            # transient-failure notes.
            print(f"[{tool}] {describe} unreachable: {e}",
                  file=sys.stderr)
            if once:
                return 1
            sleep(interval)
            continue
        if transform is not None:
            snapshot = transform(snapshot)
        if as_json:
            print_fn(json.dumps(snapshot))
        else:
            render(snapshot)
        if once:
            return 0
        sleep(interval)
