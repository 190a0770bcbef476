"""The config ladder on the port: the JAX package's tests of the ladder's
models mirrored against distributed_tensorflow_tpu_torch (its
tests/test_models.py, test_vit.py, test_bert_dtype_remat.py, the BERT
cases of test_dropout.py, test_augmentation.py's ResNet CLI run and
test_config_ladder.py's rungs 3-5, fused LayerNorm and ring BERT), and
the trainer CLI's dispatch for models with non-trainable state (JAX
``train.py:944-1141``): async falls back to sync with JAX's message,
``--ema_decay`` raises JAX's ``ValueError``, ``--steps_per_call`` takes the
scanned stateful step.  Also ``--trainable_params`` beside
``--pipeline_parallel``: the JAX CLI trains the selected parameters (on
the CPU, ``--trainable_params=lm_head --pipeline_parallel=2``: "trains
33,024 of 924,672 parameters"), and so does the port, every schedule.
CPU, small step counts, torch on one thread."""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.cluster.server import Server
from distributed_tensorflow_tpu_torch.data.datasets import (
    DataSet, _one_hot, read_cifar10, read_data_sets, synthetic_classification)
from distributed_tensorflow_tpu_torch.data.mlm import make_mlm_datasets
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models import registry
from distributed_tensorflow_tpu_torch.models import vit as tvit
from distributed_tensorflow_tpu_torch.parallel import mesh as tmesh
from distributed_tensorflow_tpu_torch.parallel import sharding as tsh
from distributed_tensorflow_tpu_torch.parallel import sync
from distributed_tensorflow_tpu_torch.tools.checkpoint_io import restore_raw
from distributed_tensorflow_tpu_torch.training import optimizers as topt

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_cifar(monkeypatch):
    """The CIFAR stand-in with 400-image validation and test splits: the
    CLI evaluates its whole splits, which ResNet-20 on one CPU thread
    takes tens of seconds to do at 5000 images."""
    from distributed_tensorflow_tpu_torch.data import datasets as tdata
    full = tdata.read_cifar10

    def small(data_dir, **kw):
        d = full(data_dir, **kw)
        return tdata.Datasets(
            train=d.train, synthetic=d.synthetic,
            validation=tdata.DataSet(d.validation.images[:400],
                                     d.validation.labels[:400]),
            test=tdata.DataSet(d.test.images[:400], d.test.labels[:400]))
    monkeypatch.setattr(tdata, "read_cifar10", small)


@pytest.fixture
def standalone(monkeypatch):
    """Single-process CLI runs: no coordination service, no process
    group (``helpers.patch_standalone_server``'s counterpart)."""
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def _flags(**kw):
    base = dict(hidden_units=32, learning_rate=0.1, seed=0, optimizer="")
    base.update(kw)
    return types.SimpleNamespace(**base)


def run_main(tmp_path, *extra):
    """test_config_ladder.py's ``run_main`` on the port's CLI."""
    return ttrain.app.run(ttrain.main, [
        "--job_name=worker", "--task_index=0", "--data_dir=/nonexistent",
        "--worker_hosts=localhost:0", "--ps_hosts=localhost:0",
        "--batch_size=16", "--learning_rate=0.05", "--log_every=2",
        "--device=cpu", f"--logdir={tmp_path}/logdir", *extra])


# ------------------------------------------------------- test_models.py


def test_lenet5_trains():
    bundle = registry.build("lenet5", _flags(learning_rate=0.2), "cpu")
    step = sync.build_sync_train_step(bundle.loss_fn)
    ds = read_data_sets("/nonexistent")
    state, losses = bundle.state, []
    for _ in range(60):
        state, m = step(state, ds.train.next_batch(64))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8
    assert "conv1" in registry_tree(bundle)


def registry_tree(bundle):
    from distributed_tensorflow_tpu_torch.training.state import (
        checkpoint_tree)
    return checkpoint_tree(bundle.state)["params"]


def test_resnet20_stateful_trains():
    bundle = registry.build("resnet20", _flags(), "cpu")
    assert bundle.loss_fn is None and bundle.state.model_state is not None
    step = sync.build_stateful_sync_train_step(bundle.stateful_loss_fn)
    ds = read_cifar10("/nonexistent")
    before = {k: v.clone() for k, v in bundle.state.model_state.items()}
    state, losses = bundle.state, []
    for _ in range(10):
        state, m = step(state, ds.train.next_batch(64))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert any(not torch.allclose(state.model_state[k], v)
               for k, v in before.items())


def test_resnet20_param_count():
    bundle = registry.build("resnet20", _flags(), "cpu")
    n = sum(p.numel() for p in bundle.state.model.parameters())
    assert 250_000 < n < 300_000


def test_bert_tiny_forward_shapes():
    model = tbert.BertForMLM(tbert.tiny(), device="cpu")
    ids = torch.ones(2, 16, dtype=torch.long)
    assert model(ids, torch.ones_like(ids)).shape == (2, 16, 30522)


def test_bert_tiny_mlm_trains():
    bundle = registry.build("bert_tiny", _flags(learning_rate=1e-3,
                                                bert_seq_len=32,
                                                bert_dtype="float32"), "cpu")
    step = sync.build_sync_train_step(bundle.loss_fn)
    ds = make_mlm_datasets(tbert.tiny(), seq_len=32)
    state, losses = bundle.state, []
    for _ in range(60):
        state, m = step(state, ds.train.next_batch(16))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.6


def test_registry_unknown_model():
    with pytest.raises(ValueError, match="Unknown model"):
        registry.build("nope", _flags(), "cpu")


@pytest.mark.parametrize("model,group", [("resnet20", True),
                                         ("lenet5", False)])
def test_async_flag_forms_a_process_group_for_stateful_bundles_only(
        tmp_path, small_cifar, monkeypatch, model, group):
    """With ``--sync_replicas=false`` the workers form the trainer's
    process group exactly when the model's bundle carries non-trainable
    state (it then trains sync, and its BatchNorm statistics need the
    group); async workers meet only at the coordination service."""
    asked = []
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        asked.append(kw["initialize_distributed"])
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)
    run_main(tmp_path, f"--model={model}", "--sync_replicas=false",
             "--train_steps=1", "--batch_size=8", "--validation_every=0")
    assert asked == [None if group else False]


# ---------------------------------------------------------- test_vit.py


def small_vit(**kw):
    return dataclasses.replace(tvit.tiny(), hidden_size=32, num_layers=2,
                               num_heads=2, intermediate_size=64,
                               dtype="float32", **kw)


def test_vit_forward_shapes_and_flat_input():
    model = tvit.VitClassifier(small_vit(), device="cpu")
    x = torch.rand(2, 32, 32, 3)
    logits = model(x)
    assert logits.shape == (2, 10)
    torch.testing.assert_close(model(x.reshape(2, -1)), logits)


def test_vit_trains_on_synthetic_cifar():
    """The JAX test's model from the JAX test's initial weights (a jitted
    flax init from ``PRNGKey(0)``), Adam 1e-3, 30 steps of 64."""
    import jax
    import jax.numpy as jnp
    from distributed_tensorflow_tpu.models import vit as jvit
    jmodel = jvit.VitClassifier(dataclasses.replace(
        jvit.tiny(), hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, dtype="float32"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 3072)))["params"]
    model = tvit.VitClassifier(small_vit(), device="cpu")
    model.load_state_dict(tvit.params_from_jax(jax.device_get(params)))
    xs, ys = synthetic_classification(256, 32 * 32 * 3, 10, seed=0)
    ds = DataSet(xs, _one_hot(ys, 10), seed=0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    losses = []
    for _ in range(30):
        x, y = ds.next_batch(64)
        logp = torch.log_softmax(model(torch.from_numpy(x)), -1)
        loss = -(torch.from_numpy(y) * logp).sum(-1).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses[::10]


def test_vit_tensor_parallel_step():
    """One process, ``model=2``: qkv split over its heads, and the
    sharded step's loss and updated (gathered) parameters those of the
    unsharded step from the same weights."""
    mesh = tmesh.create_mesh(data=1, model=2, devices=[CPU] * 2)
    kw = dict(dtype="float32", tx=topt.make_optimizer("sgd", 0.1),
              device="cpu")
    sharded = registry.build_vit_tiny(1e-3, **kw)
    plain = registry.build_vit_tiny(1e-3, **kw)
    state = tsh.shard_state(mesh, sharded.state, sharded.sharding_rules)
    qkv = state.model.layer0.qkv
    assert tsh.shard_dim(qkv, "kernel") == 2
    assert [tuple(s.shape) for s in tsh.shards(qkv, "kernel")] == [
        (128, 3, 2, 32)] * 2
    rng = np.random.RandomState(0)
    x = rng.rand(8, 32, 32, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 8)]
    state, m = sync.build_sync_train_step(sharded.loss_fn)(state, (x, y))
    pstate, pm = sync.build_sync_train_step(plain.loss_fn)(plain.state,
                                                          (x, y))
    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]),
                               rtol=1e-6)
    got = tsh.gather_named(state.model, dict(state.model.named_parameters()))
    for name, p in pstate.model.named_parameters():
        torch.testing.assert_close(got[name], p, atol=1e-6, rtol=0)


def test_bert_tensor_parallel_step():
    """BERT's rules: qkv/mlp_in column, out/mlp_out row, the embeddings
    vocab parallel, mlm_out by the vocabulary; the step is the unsharded
    one's."""
    mesh = tmesh.create_mesh(data=1, model=2, devices=[CPU] * 2)
    kw = dict(seq_len=16, dtype="float32",
              tx=topt.make_optimizer("sgd", 0.1), device="cpu")
    sharded = registry.build_bert_tiny(1e-3, **kw)
    plain = registry.build_bert_tiny(1e-3, **kw)
    state = tsh.shard_state(mesh, sharded.state, sharded.sharding_rules)
    emb = state.model.bert.word_emb
    assert tsh.shard_dim(emb, "embedding") == 0
    assert tsh.shard_dim(state.model.mlm_out, "kernel") == 1
    batch = tbert.synthetic_mlm_batch(0, 4, 16, tbert.tiny())
    batch["attention_mask"][1, 9:] = 0
    state, m = sync.build_sync_train_step(sharded.loss_fn)(state, batch)
    pstate, pm = sync.build_sync_train_step(plain.loss_fn)(plain.state,
                                                          batch)
    np.testing.assert_allclose(float(m["loss"]), float(pm["loss"]),
                               rtol=1e-6)
    got = tsh.gather_named(state.model, dict(state.model.named_parameters()))
    for name, p in pstate.model.named_parameters():
        torch.testing.assert_close(got[name], p, atol=1e-6, rtol=0)


# --------------------------------------------- test_bert_dtype_remat.py


def small_bert(**kw):
    return dataclasses.replace(
        tbert.tiny(), vocab_size=128, hidden_size=32, num_layers=2,
        num_heads=2, intermediate_size=64, max_position=32, **kw)


def _bert_loss(model, batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = model(t["input_ids"].long(), t["attention_mask"])
    return tbert.mlm_loss(logits, t["labels"], t["label_weights"])[0]


def test_remat_preserves_loss_and_grads():
    cfg = small_bert(dtype="float32")
    model = tbert.BertForMLM(cfg, device="cpu")
    model_r = tbert.BertForMLM(dataclasses.replace(cfg, remat=True),
                               device="cpu")
    model_r.load_state_dict(model.state_dict())
    batch = tbert.synthetic_mlm_batch(0, 4, 16, cfg)
    loss, loss_r = _bert_loss(model, batch), _bert_loss(model_r, batch)
    torch.testing.assert_close(loss, loss_r, rtol=1e-6, atol=0)
    loss.backward()
    loss_r.backward()
    for (n, p), (_, q) in zip(model.named_parameters(),
                              model_r.named_parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-5, atol=1e-6,
                                   msg=n)


def test_bf16_tracks_fp32_loss():
    m32 = tbert.BertForMLM(small_bert(dtype="float32"), device="cpu")
    m16 = tbert.BertForMLM(small_bert(dtype="bfloat16"), device="cpu")
    m16.load_state_dict(m32.state_dict())
    batch = tbert.synthetic_mlm_batch(0, 4, 16, small_bert())
    l32, l16 = float(_bert_loss(m32, batch)), float(_bert_loss(m16, batch))
    assert abs(l32 - l16) / abs(l32) < 0.02, (l32, l16)


def test_registry_threads_dtype_and_remat():
    bundle = registry.build_bert_tiny(1e-3, seq_len=16, dtype="float32",
                                      remat=True, device="cpu")
    assert bundle.state.model.cfg.remat
    batch = bundle.load_datasets(None).train.next_batch(4)
    loss, aux = bundle.loss_fn(bundle.state.model, batch)
    assert np.isfinite(float(loss))
    assert 0.0 <= float(aux["accuracy"]) <= 1.0


# ---------------------------------------- test_dropout.py, BERT's cases


def test_dropout_stochastic_train_deterministic_eval():
    model = tbert.BertForMLM(small_bert(dtype="float32", dropout_rate=0.3),
                             device="cpu")
    batch = tbert.synthetic_mlm_batch(0, 2, 16, small_bert())
    ids = torch.from_numpy(batch["input_ids"]).long()
    mask = torch.from_numpy(batch["attention_mask"])
    model.train()
    a = model(ids, mask, torch.Generator().manual_seed(1))
    b = model(ids, mask, torch.Generator().manual_seed(2))
    assert not torch.allclose(a, b)
    with pytest.raises(ValueError, match="needs rng"):
        model(ids, mask)
    model.eval()
    torch.testing.assert_close(model(ids, mask), model(ids, mask), rtol=0,
                               atol=0)


def test_zero_rate_dropout_matches_deterministic():
    model = tbert.BertForMLM(small_bert(dtype="float32"), device="cpu")
    batch = tbert.synthetic_mlm_batch(0, 2, 16, small_bert())
    ids = torch.from_numpy(batch["input_ids"]).long()
    mask = torch.from_numpy(batch["attention_mask"])
    train = model.train()(ids, mask, torch.Generator().manual_seed(1))
    torch.testing.assert_close(train, model.eval()(ids, mask), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("variant", ["plain", "scanned", "accum"])
def test_rng_threads_through_step_builders(variant):
    bundle = registry.build_bert_tiny(1e-3, seq_len=16, dtype="float32",
                                      dropout_rate=0.2, device="cpu")
    assert bundle.needs_rng and bundle.state.rng is not None
    split = bundle.load_datasets(None).train
    K = 2
    if variant == "plain":
        step = sync.build_sync_train_step(bundle.loss_fn, needs_rng=True)
        batch, expect = split.next_batch(8), 1
    else:
        builder = (sync.build_scanned_sync_train_step if variant == "scanned"
                   else sync.build_accumulating_sync_train_step)
        kw = {"num_steps": K} if variant == "scanned" else {"accum_steps": K}
        step = builder(bundle.loss_fn, needs_rng=True, **kw)
        batch = sync.stack_microbatches([split.next_batch(8)
                                         for _ in range(K)])
        expect = K if variant == "scanned" else 1
    before = bundle.state.rng.get_state().clone()
    state, m = step(bundle.state, batch)
    assert np.isfinite(float(m["loss"]))
    assert state.global_step == 1 + expect
    assert not torch.equal(state.rng.get_state(), before)


def test_e2e_bert_dropout(tmp_path, standalone):
    result = run_main(tmp_path, "--model=bert_tiny", "--bert_dropout=0.1",
                      "--bert_seq_len=32", "--sync_replicas=true",
                      "--train_steps=4", "--batch_size=8")
    assert result.final_global_step >= 4
    assert result.test_accuracy is not None


# ------------------------------------------------- test_augmentation.py


def test_e2e_resnet_augmented(tmp_path, standalone, small_cifar, capsys):
    """CLI smoke with fake-pickle CIFAR batches on disk, so the augment
    path runs inside the training loop and the prefetcher."""
    from test_augmentation import _write_fake_cifar
    data_dir = tmp_path / "cifar"
    data_dir.mkdir()
    _write_fake_cifar(data_dir)
    result = ttrain.app.run(ttrain.main, [
        "--job_name=worker", "--task_index=0", f"--data_dir={data_dir}",
        "--worker_hosts=localhost:0", "--ps_hosts=localhost:0",
        "--model=resnet20", "--sync_replicas=true",
        "--data_augmentation=true", "--train_steps=3", "--batch_size=16",
        "--validation_every=0", "--device=cpu",
        f"--logdir={tmp_path}/logdir"])
    assert result.final_global_step >= 3
    assert result.last_loss is not None
    assert "augmentation disabled" not in capsys.readouterr().out


# ------------------------------------------------ test_config_ladder.py


def test_ladder_lenet5_async(tmp_path, standalone):
    # Rung 3: LeNet-5, async replicas (one replica a worker in the port).
    result = run_main(tmp_path, "--model=lenet5", "--sync_replicas=false",
                      "--async_sync_period=2", "--train_steps=6")
    assert result.final_global_step >= 6
    assert result.test_accuracy is not None


def test_ladder_resnet20_sync(tmp_path, standalone, small_cifar):
    result = run_main(tmp_path, "--model=resnet20", "--sync_replicas=true",
                      "--train_steps=4", "--batch_size=16")
    assert result.final_global_step >= 4
    assert result.last_loss is not None
    assert result.test_accuracy is not None


def test_sequence_parallel_ring_bert(tmp_path, standalone):
    # Long-context path through the CLI: the seq axis and ring attention
    # (BERT's key-padding mask through the ring's chunk functions).
    result = run_main(tmp_path, "--model=bert_tiny", "--sync_replicas=true",
                      "--sequence_parallel=2", "--attention_backend=ring",
                      "--train_steps=3", "--bert_seq_len=32",
                      "--batch_size=8")
    assert result.final_global_step >= 3
    assert result.test_accuracy is not None


def test_ladder_bert_tiny_sync(tmp_path, standalone):
    result = run_main(tmp_path, "--model=bert_tiny", "--sync_replicas=true",
                      "--train_steps=4", "--bert_seq_len=32",
                      "--batch_size=8")
    assert result.final_global_step >= 4
    assert result.test_accuracy is not None


def test_bert_tiny_fused_layer_norm(tmp_path, standalone):
    result = run_main(tmp_path, "--model=bert_tiny", "--sync_replicas=true",
                      "--fused_layer_norm=true", "--train_steps=3",
                      "--bert_seq_len=32", "--batch_size=8")
    assert result.final_global_step >= 3
    assert result.test_accuracy is not None


def test_vit_cli(tmp_path, standalone, small_cifar):
    """test_vit.py::test_vit_cli_e2e on the port."""
    result = run_main(tmp_path, "--model=vit_tiny", "--train_steps=6",
                      "--batch_size=16", "--log_every=3",
                      "--validation_every=0", "--bert_dtype=float32",
                      "--attention_backend=pallas", "--fused_layer_norm")
    assert result.final_global_step >= 6
    assert result.test_accuracy is not None


# -------------------------------------------- the stateful CLI dispatch


def test_stateful_model_in_async_mode_trains_sync(tmp_path, standalone,
                                                  small_cifar, capsys):
    result = run_main(tmp_path, "--model=resnet20", "--sync_replicas=false",
                      "--train_steps=3", "--batch_size=8",
                      "--validation_every=0", "--log_grad_norm")
    out = capsys.readouterr().out
    assert ("Worker 0: model resnet20 has non-trainable state; async mode "
            "unsupported — using sync.") in out
    assert ("--log_grad_norm is not available on the stateful (BatchNorm) "
            "sync path — ignoring") in out
    assert "Worker 0: model state digest" in out
    assert result.final_global_step == 3
    tree = restore_raw(os.path.join(tmp_path, "logdir", "resnet20"))[0]
    assert sorted(tree["model_state"]["stage2_block0"]) == [
        "bn1", "bn2", "bn_proj"]


def test_stateful_model_rejects_ema(tmp_path, standalone):
    with pytest.raises(ValueError, match="not stateful models or pipeline"):
        run_main(tmp_path, "--model=resnet20", "--ema_decay=0.99")


def test_stateful_scanned_steps_equal_single_steps(tmp_path, standalone, small_cifar):
    a = run_main(tmp_path / "a", "--model=resnet20", "--train_steps=5",
                 "--batch_size=8", "--validation_every=0",
                 "--steps_per_call=2", "--log_every=2")
    b = run_main(tmp_path / "b", "--model=resnet20", "--train_steps=5",
                 "--batch_size=8", "--validation_every=0", "--log_every=2")
    assert a.final_global_step == b.final_global_step == 5
    ta = restore_raw(os.path.join(tmp_path, "a", "logdir", "resnet20"))[0]
    tb = restore_raw(os.path.join(tmp_path, "b", "logdir", "resnet20"))[0]
    np.testing.assert_array_equal(
        np.asarray(ta["model_state"]["bn0"]["var"]),
        np.asarray(tb["model_state"]["bn0"]["var"]))
    np.testing.assert_array_equal(np.asarray(ta["params"]["head"]["kernel"]),
                                  np.asarray(tb["params"]["head"]["kernel"]))


def test_stateful_eval_mode_uses_the_running_statistics(tmp_path,
                                                        standalone,
                                                        small_cifar):
    trained = run_main(tmp_path, "--model=resnet20", "--train_steps=4",
                       "--batch_size=8", "--validation_every=0")
    result = run_main(tmp_path, "--model=resnet20", "--mode=eval")
    assert result["global_step"] == 4
    assert result["test_accuracy"] == trained.test_accuracy


# ------------------------- --trainable_params beside --pipeline_parallel


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_trainable_params_with_the_pipeline(tmp_path, standalone, capsys,
                                            schedule):
    """The JAX CLI trains the selected parameters beside the pipeline;
    the port does the same: the message, and every other parameter
    bit-for-bit its initial value (the checkpoint's stage-stacked
    ``stages`` leaves and the embeddings)."""
    flags = ["--model=gpt_mini", "--sync_replicas=true",
             "--pipeline_parallel=2", f"--pipeline_schedule={schedule}",
             "--pipeline_microbatches=2", "--bert_seq_len=16",
             "--trainable_params=lm_head", "--validation_every=0"]
    run_main(tmp_path, *flags, "--train_steps=3")
    assert ("trains 33,024 of 924,672 parameters"
            in capsys.readouterr().out)
    from distributed_tensorflow_tpu_torch.training.state import (
        checkpoint_tree)
    mesh = tmesh.create_mesh(data=1, pipe=2, devices=[CPU] * 2)
    fresh = registry.build("gpt_mini", _flags(
        learning_rate=0.05, bert_seq_len=16, pipeline_parallel=2,
        pipeline_schedule=schedule, pipeline_microbatches=2), "cpu",
        mesh=mesh)
    init = checkpoint_tree(fresh.state)["params"]
    name = registry.pipeline_bundle_name(2, schedule, 2)
    last = restore_raw(os.path.join(tmp_path, "logdir", name))[0]
    assert int(last["global_step"]) == 3
    for part in ("stages", "embed"):
        for a, b in zip(_leaves(init[part]), _leaves(last["params"][part])):
            np.testing.assert_array_equal(a, b)
    assert not np.array_equal(
        np.asarray(init["head"]["lm_head"]["kernel"]),
        np.asarray(last["params"]["head"]["lm_head"]["kernel"]))


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield np.asarray(tree)
