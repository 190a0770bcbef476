"""Flag/config system (reference parity: C1/C2), copied from the JAX
package's ``config.py`` (host-only: argparse).

The reference declares 11 flags via ``tf.app.flags`` (reference
``distributed.py:8-34``) and validates ``job_name``/``task_index`` in ``main``
(``distributed.py:40-47``).  This module provides the same surface —
``flags.DEFINE_*`` + a module-level ``FLAGS`` object + ``app.run(main)`` —
without TensorFlow.  The help texts are the JAX package's, its TPU-VM
wording included; the port's ``train.py`` gives the flags of its ported
paths their meaning, and a flag of a path not ported yet raises naming
its entry in ROADMAP.md, section 1.

Unlike ``tf.app.flags`` this registry is instantiable, so tests can build
isolated flag sets.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Callable, Sequence


class FlagValues:
    """Holds flag definitions and parsed values (attribute access like TF's FLAGS)."""

    def __init__(self) -> None:
        object.__setattr__(self, "_defs", {})  # name -> (type_fn, default, help)
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_parsed", False)

    def _define(self, name: str, default: Any, help_str: str, type_fn: Callable) -> None:
        self._defs[name] = (type_fn, default, help_str)
        self._values[name] = default

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(f"Unknown flag: {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if name not in self._defs:
            raise AttributeError(f"Cannot set undefined flag {name!r}")
        self._values[name] = value

    def parse(self, argv: Sequence[str] | None = None) -> list[str]:
        """Parse argv (defaults to ``sys.argv[1:]``); returns leftover positional args."""
        if argv is None:
            argv = sys.argv[1:]
        parser = argparse.ArgumentParser(add_help=True, allow_abbrev=False)
        for name, (type_fn, default, help_str) in self._defs.items():
            if type_fn is bool:
                parser.add_argument(
                    f"--{name}", default=default, help=help_str,
                    type=_parse_bool, nargs="?", const=True)
            else:
                parser.add_argument(f"--{name}", default=default, help=help_str,
                                    type=type_fn)
        ns, leftover = parser.parse_known_args(list(argv))
        for name in self._defs:
            self._values[name] = getattr(ns, name)
        object.__setattr__(self, "_parsed", True)
        return leftover

    def as_dict(self) -> dict:
        return dict(self._values)


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool) or v is None:
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "t", "1", "yes", "y"):
        return True
    if s in ("false", "f", "0", "no", "n", ""):
        return False
    raise argparse.ArgumentTypeError(f"Not a boolean: {v!r}")


class _FlagsModule:
    """Mirrors the ``tf.app.flags`` API: DEFINE_* + FLAGS."""

    def __init__(self, flag_values: FlagValues | None = None) -> None:
        self.FLAGS = flag_values or FlagValues()

    def DEFINE_string(self, name: str, default: str | None, help_str: str) -> None:
        self.FLAGS._define(name, default, help_str, str)

    def DEFINE_integer(self, name: str, default: int | None, help_str: str) -> None:
        self.FLAGS._define(name, default, help_str, int)

    def DEFINE_float(self, name: str, default: float | None, help_str: str) -> None:
        self.FLAGS._define(name, default, help_str, float)

    def DEFINE_boolean(self, name: str, default: bool | None, help_str: str) -> None:
        self.FLAGS._define(name, default, help_str, bool)

    DEFINE_bool = DEFINE_boolean


# Module-level singleton, like tf.app.flags.
flags = _FlagsModule()
FLAGS = flags.FLAGS


def define_training_flags(f: _FlagsModule | None = None) -> FlagValues:
    """Declare the reference's 11 flags (``distributed.py:8-34``) with TPU defaults.

    ``ps_hosts``/``worker_hosts`` are kept for CLI compatibility but reinterpreted:
    ``worker_hosts`` lists the TPU-VM hosts (one process each) and ``ps_hosts[0]``
    doubles as the coordination-service address (there is no parameter server —
    parameters live sharded in TPU HBM).
    """
    f = f or flags
    f.DEFINE_string("data_dir", "/tmp/mnist-data", "Directory for storing mnist data")
    f.DEFINE_integer("hidden_units", 100, "Number of units in the hidden layer of the NN")
    f.DEFINE_integer("train_steps", 100000, "Number of training steps to perform")
    f.DEFINE_integer("batch_size", 100, "Training batch size (global)")
    f.DEFINE_float("learning_rate", 0.01, "Learning rate")
    f.DEFINE_string("ps_hosts", "localhost:2222",
                    "Coordination-service address (hostname:port). Kept for CLI parity "
                    "with the reference's parameter-server flag; no PS process exists.")
    f.DEFINE_string("worker_hosts", "localhost:2223",
                    "Comma-separated list of hostname:port pairs, one per TPU-VM host")
    f.DEFINE_string("job_name", None, "job name: worker or ps")
    f.DEFINE_integer("task_index", None, "Index of task within the job")
    f.DEFINE_boolean("sync_replicas", False,
                     "Use the sync_replicas (synchronized replicas) mode, wherein the "
                     "parameter updates from workers are aggregated (AllReduce over ICI) "
                     "before being applied, avoiding stale gradients")
    f.DEFINE_integer("replicas_to_aggregate", None,
                     "Number of replicas to aggregate before the parameter update is "
                     "applied (sync_replicas mode only; default: num_workers). "
                     "TPU-native semantics: R < num_workers enables masked "
                     "aggregation over the LIVE worker set (dead workers drop "
                     "on --heartbeat_timeout; slow ones on --straggler_lag), "
                     "renormalized each step — not literally 'first R of N' "
                     "(AllReduce has no first-R notion; see PARITY.md N3)")
    return f.FLAGS


def validate_role_flags(FLAGS: FlagValues) -> None:
    """Reference parity: hard error on missing job_name/task_index (``distributed.py:40-47``)."""
    if FLAGS.job_name is None or FLAGS.job_name == "":
        raise ValueError("Must specify an explicit job_name !")
    print(f"job_name : {FLAGS.job_name}")
    if FLAGS.task_index is None or FLAGS.task_index == "":
        raise ValueError("Must specify an explicit task_index!")
    print(f"task_index : {FLAGS.task_index}")


class app:
    """``tf.app.run`` equivalent: parse flags then call main(leftover_argv)."""

    @staticmethod
    def run(main: Callable, argv: Sequence[str] | None = None) -> Any:
        leftover = FLAGS.parse(argv)
        # Surface probable typos: unknown --flags are passed through to main
        # (tf.app.run leftover semantics) but never parsed by anyone.
        for arg in leftover:
            if arg.startswith("--"):
                print(f"WARNING: unrecognized flag {arg!r} ignored",
                      file=sys.stderr)
        return main(leftover)
