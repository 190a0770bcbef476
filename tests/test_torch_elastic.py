"""The port's elastic membership (``training/elastic.py``, the loop hook and
the masked-sync mask) against the JAX package's cases.

Every case of ``tests/test_elastic.py`` runs against the port, mirrored
as ``tests/test_torch_param_sync.py`` mirrors the exchange's: the JAX
module is loaded with its imports of the coordination client, the
elastic controller, the chaos harness, telemetry and ``parallel.sync``
pointed at the port.  The controller cases' supervisor is the port's
(checkpoints through ``save_raw``) over the port's MNIST MLP state: the
JAX module's ``_mlp_supervisor`` helper is replaced by
:func:`_port_mlp_supervisor`, which builds the same kind of state.
"""

import dataclasses

import pytest
import torch

from test_torch_param_sync import mirror_module, run_mirrored

from distributed_tensorflow_tpu_torch.models import mlp as tmlp
from distributed_tensorflow_tpu_torch.training.optimizers import (
    make_optimizer)
from distributed_tensorflow_tpu_torch.training.state import TrainState
from distributed_tensorflow_tpu_torch.training.supervisor import Supervisor
from distributed_tensorflow_tpu_torch.utils import faults


@dataclasses.dataclass
class _State(TrainState):
    """The port's TrainState with the JAX state's ``replace``, which the
    mirrored cases call to stage checkpoints at chosen steps."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


def _port_mlp_supervisor(tmp_path, coordination_client=None,
                         is_chief=True):
    model = tmlp.MnistMLP(16, device="cpu")
    state = _State.create(model, make_optimizer("sgd", 0.1),
                          params_to_tree=tmlp.params_to_jax,
                          params_from_tree=tmlp.params_from_jax)
    sv = Supervisor(is_chief=is_chief, logdir=str(tmp_path / "logdir"),
                    init_fn=lambda: state, save_interval_steps=1,
                    coordination_client=coordination_client)
    return sv, state, None


MIRROR = mirror_module("test_elastic.py")
MIRROR._mlp_supervisor = _port_mlp_supervisor
CASES = [name for name in vars(MIRROR) if name.startswith("test_")]


@pytest.fixture(autouse=True)
def _clear_injector():
    torch.set_num_threads(1)
    yield
    faults.clear()


@pytest.fixture
def server():
    """The JAX module's fixture, on the port's coordination service."""
    srv = MIRROR.CoordinationServer(port=0, num_tasks=4,
                                    heartbeat_timeout=30.0)
    srv.start()
    yield srv
    srv.stop()


@pytest.mark.parametrize("name", CASES)
def test_mirrored(name, request):
    run_mirrored(getattr(MIRROR, name), request)


def test_mirror_covers_the_controller_cases():
    for name in ("test_in_place_shrink_then_grow_flips_mask",
                 "test_replica_mask_from_tasks_combines_health_and_membership",
                 "test_controller_rejoins_and_restores_chief_checkpoint",
                 "test_controller_chaos_evict_then_rejoin",
                 "test_reshard_chief_publishes_spec_and_stops",
                 "test_reshard_non_chief_honors_published_stop_step",
                 "test_evict_at_step_and_partition_directives"):
        assert name in CASES
