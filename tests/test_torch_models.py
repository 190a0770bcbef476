"""The port's LeNet-5, ResNet-20 and ViT-tiny
(distributed_tensorflow_tpu_torch/models/lenet.py, resnet.py, vit.py and
their registry bundles) against the JAX package's: the same weights
(each module's ``params_from_jax``), the same inputs (numpy, seeded, and
the CIFAR/MNIST stand-ins), logits, losses, gradients and three train
steps against the JAX sync steps, ResNet-20's ``batch_stats`` after each
step.  The JAX side's Pallas kernels run in interpret mode (ViT with
``attention_backend="pallas"``, ``fused_ln``); torch on one thread.

Tolerances (fp32): logits and losses 1e-4; LeNet's and ViT's parameters
after each of three SGD steps 1e-5 absolute with an update cosine of
0.99999 (each moves by lr x gradient, so they show the gradients'
agreement; the GPT test's reasoning for SGD); bf16 ViT: the bf16
``TRAIN_CASES`` of tests/test_torch_gpt_training.py.  ResNet-20: the
forward loss 1e-5 and ``batch_stats`` 1e-5 after each step.  Its
gradients and updates are held to JAX's run in float64
(``jax.enable_x64``) at 1e-9, and in fp32 to JAX's at 1e-4 wherever
JAX's fp32 result does not show its own rounding (the JAX fp32 BatchNorm
backward on the CIFAR stand-in is itself up to 1.9% from float64).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

from distributed_tensorflow_tpu.models import vit as jvit
from distributed_tensorflow_tpu.parallel import sync as jsync
from distributed_tensorflow_tpu_torch.data.datasets import (
    read_cifar10, read_data_sets)
from distributed_tensorflow_tpu_torch.models import image_input
from distributed_tensorflow_tpu_torch.models import lenet as tlenet
from distributed_tensorflow_tpu_torch.models import registry as treg
from distributed_tensorflow_tpu_torch.models import resnet as tresnet
from distributed_tensorflow_tpu_torch.models import vit as tvit
from distributed_tensorflow_tpu_torch.models.mlp import cross_entropy_loss
from distributed_tensorflow_tpu_torch.parallel import sync as tsync
from distributed_tensorflow_tpu_torch.training import optimizers as topt

BF16 = dict(loss_tol=3e-3, param_atol=3e-3, min_cos=0.999)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(named):
    return torch.cat([v.detach().double().flatten()
                      for _, v in sorted(named.items())])


@functools.lru_cache(maxsize=None)
def _jax_base(name):
    """The JAX models of ``registry.build_lenet5`` / ``build_resnet20`` /
    ``build_vit_tiny`` (ViT's fp32 ``xla`` one: flax's parameters are fp32
    whatever the compute dtype or backend) with their losses, built once,
    the parameters from a jitted ``init`` (flax's eager init compiles op
    by op and is the slow part)."""
    from distributed_tensorflow_tpu.models import lenet as jlenet
    from distributed_tensorflow_tpu.models import mlp as jmlp
    from distributed_tensorflow_tpu.models import resnet as jresnet
    from distributed_tensorflow_tpu.training.state import TrainState
    key = jax.random.PRNGKey(0)
    if name == "resnet20":
        train, ev = (jresnet.ResNet20(use_running_average=False),
                     jresnet.ResNet20(use_running_average=True))
        variables = jax.jit(train.init)(key, jnp.zeros((1, 32, 32, 3)))

        def apply_eval(p, stats, x):
            return ev.apply({"params": p, "batch_stats": stats}, x)

        def stateful_loss_fn(p, stats, batch):
            images, labels = batch
            logits, mutated = train.apply(
                {"params": p, "batch_stats": stats}, images,
                mutable=["batch_stats"])
            return jmlp.cross_entropy_loss(logits, labels), (
                {"accuracy": jmlp.accuracy(logits, labels)},
                mutated["batch_stats"])
        state = TrainState.create(jax.jit(apply_eval), variables["params"],
                                  optax.sgd(0.1),
                                  model_state=variables["batch_stats"])
        return types.SimpleNamespace(state=state,
                                     stateful_loss_fn=stateful_loss_fn)
    model, shape = {"lenet5": (jlenet.LeNet5(), (1, 784)),
                    "vit_tiny": (jvit.VitClassifier(dataclasses.replace(
                        jvit.tiny(), dtype="float32")),
                        (1, 32, 32, 3))}[name]
    params = jax.jit(model.init)(key, jnp.zeros(shape))["params"]

    def apply_fn(p, x):
        return model.apply({"params": p}, x)

    def loss_fn(p, batch):
        images, labels = batch
        logits = apply_fn(p, images)
        return jmlp.cross_entropy_loss(logits, labels), {
            "accuracy": jmlp.accuracy(logits, labels)}
    return types.SimpleNamespace(
        state=TrainState.create(jax.jit(apply_fn), params, optax.sgd(0.1)),
        loss_fn=loss_fn)


def _jax_bundle(name, **kw):
    """The JAX bundle of ``name``; for ViT with ``kw`` (dtype, backend,
    fused_ln) the base bundle's weights under ``registry.build_vit_tiny``'s
    loss of that configuration."""
    base = _jax_base(name)
    if name != "vit_tiny":
        return base
    from distributed_tensorflow_tpu.models import mlp as jmlp
    cfg = dataclasses.replace(jvit.tiny(), **kw)
    model = jvit.VitClassifier(cfg)

    def apply_fn(p, x):
        return model.apply({"params": p}, x)

    def loss_fn(p, batch):
        images, labels = batch
        logits = apply_fn(p, images)
        return jmlp.cross_entropy_loss(logits, labels), {
            "accuracy": jmlp.accuracy(logits, labels)}
    return types.SimpleNamespace(
        state=base.state.replace(apply_fn=jax.jit(apply_fn)), loss_fn=loss_fn)


def _port(name, jb, lr=0.1, opt="sgd", **kw):
    """The port's bundle with the JAX bundle's weights (and statistics)."""
    builders = {"lenet5": treg.build_lenet5, "resnet20": treg.build_resnet20,
                "vit_tiny": treg.build_vit_tiny}
    tb = builders[name](lr, tx=topt.make_optimizer(opt, lr), device="cpu",
                        **kw)
    params = jax.device_get(jb.state.params)
    if name == "resnet20":
        sd = tresnet.params_from_jax(params,
                                     jax.device_get(jb.state.model_state))
    else:
        sd = {"lenet5": tlenet, "vit_tiny": tvit}[name].params_from_jax(
            params)
    tb.state.model.load_state_dict(sd)
    return tb


def _images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, size), np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("feed", ["flat", "uint8"])
def test_lenet_logits_match_jax(feed):
    jb = _jax_bundle("lenet5")
    tb = _port("lenet5", jb)
    x, _ = _images(6, 784)
    if feed == "uint8":
        x = (x * 255).astype(np.uint8)
    want = np.asarray(jb.state.apply_fn(jb.state.params, x))
    got = tb.state.model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_lenet_flatten_is_flax_nhwc_order():
    """fc1's 400 inputs come in flax's (h, w, c) order: a port that
    flattened NCHW would read fc1's rows permuted."""
    jb = _jax_bundle("lenet5")
    tb = _port("lenet5", jb)
    x, _ = _images(2, 784, seed=3)
    want = np.asarray(jb.state.apply_fn(jb.state.params, x))
    m = tb.state.model
    h = image_input.nhwc_images(torch.from_numpy(x), 28, 1).permute(0, 3, 1, 2)
    h = torch.nn.functional.avg_pool2d(torch.tanh(m.conv1(h)), 2, 2)
    h = torch.nn.functional.avg_pool2d(torch.tanh(m.conv2(h)), 2, 2)
    nchw = h.reshape(2, -1)                  # the wrong order
    wrong = m.out(torch.tanh(m.fc2(torch.tanh(m.fc1(nchw)))))
    assert np.abs(wrong.detach().numpy() - want).max() > 1e-3
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), want,
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("size,k,stride", [
    (32, 3, 2), (16, 3, 2), (8, 3, 2), (32, 3, 1), (32, 1, 2), (28, 5, 1),
    (33, 3, 2), (7, 4, 3)])
def test_same_pads_are_xlas(size, k, stride):
    assert image_input.same_pads(size, k, stride) == tuple(
        lax.padtype_to_pads((size,), (k,), (stride,), "SAME")[0])


def test_resnet_train_forward_matches_jax():
    """Training mode: the loss (batch statistics over the whole batch)
    and the updated running statistics of one forward."""
    jb = _jax_bundle("resnet20")
    tb = _port("resnet20", jb)
    x, y = read_cifar10("/nonexistent").train.next_batch(16)
    jloss, (_, stats) = jax.jit(jb.stateful_loss_fn)(
        jb.state.params, jb.state.model_state, (x, y))
    model = tb.state.model
    model.train()
    loss, _ = tb.stateful_loss_fn(model, (x, y))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    want = tresnet.params_from_jax({}, jax.device_get(stats))
    for name, t in tb.state.model_state.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_resnet_eval_logits_match_jax():
    jb = _jax_bundle("resnet20")
    tb = _port("resnet20", jb)
    x, _ = _images(4, 3072)
    want = np.asarray(jb.state.apply_fn(jb.state.params,
                                        jb.state.model_state, x))
    model = tb.state.model.eval()
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               want, atol=1e-4, rtol=0)


def test_flax_batchnorm_running_variance_is_biased():
    """The running variance moves with the BIASED batch variance (flax's
    rule); ``nn.BatchNorm2d`` would use the unbiased one."""
    import flax.linen as fnn
    x = np.array([0., 1., 2., 3., 4., 5., 6., 7., 8., 10.],
                 np.float32).reshape(10, 1, 1, 1)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    _, upd = bn.apply(variables, x, mutable=["batch_stats"])
    flax_var = float(upd["batch_stats"]["var"][0])
    port = tresnet.BatchNorm(1, device="cpu").train()
    port(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch_bn = torch.nn.BatchNorm2d(1, momentum=0.1).train()
    torch_bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert abs(float(port.var[0]) - flax_var) <= 1e-5
    assert abs(float(torch_bn.running_var[0]) - flax_var) > 0.1


def _x64(tree):
    """A JAX tree's leaves as float64 numpy arrays (for a run under
    ``jax.enable_x64``)."""
    return jax.tree.map(lambda a: np.asarray(a, np.float64),
                        jax.device_get(tree))


def _named(tree, prefix=""):
    """A JAX tree's leaves as float64 tensors under the port's names
    (``params_from_jax`` rounds to fp32)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_named(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = torch.from_numpy(
                np.array(value, np.float64))
    return out


def _f64_grads(model, x, y):
    """The port model's gradients in float64 (flax's BatchNorm keeps a
    float64 input in float64; the image input's fp32 cast is bypassed)."""
    import copy
    m = copy.deepcopy(model).double().train()
    orig = tresnet.nhwc_images
    tresnet.nhwc_images = lambda t, s, c: t.reshape(-1, s, s, c)
    try:
        logits = m(torch.from_numpy(x).double())
    finally:
        tresnet.nhwc_images = orig
    cross_entropy_loss(logits, torch.from_numpy(y).double()).backward()
    return {n: p.grad for n, p in m.named_parameters()}


def _rel(a, b, norm):
    return float((a.double() - b.double()).norm()) / norm


#: A tensor where JAX's fp32 result is within half the 1e-4 tolerance of
#: JAX's float64 result does not show JAX's own rounding: there the
#: port's fp32 result is held to JAX's at 1e-4.
ROUNDING = 5e-5


def test_resnet_gradients_are_at_least_as_exact_as_jax():
    """Against JAX's float64 gradient (``jax.enable_x64``, the same
    weights and batch): the port's float64 gradient within 1e-9 of it on
    every tensor, so BatchNorm's backward is JAX's.  In fp32 the JAX
    BatchNorm backward is itself up to 1.9% from float64 in the first
    stages (its statistics' sums in fp32 on the CIFAR stand-in, whose
    inputs have mean 0.5; the port's within 0.25%): the port's fp32
    gradient within 1e-4 of JAX's where JAX's rounding does not show
    (``ROUNDING``), and everywhere at least as close to float64 as JAX's
    and within 0.5% of it."""
    jb = _jax_bundle("resnet20")
    tb = _port("resnet20", jb)
    x, y = read_cifar10("/nonexistent").train.next_batch(16)
    g32 = jax.jit(jax.grad(lambda p: jb.stateful_loss_fn(
        p, jb.state.model_state, (x, y))[0]))(jb.state.params)
    with jax.enable_x64(True):
        stats = _x64(jb.state.model_state)
        g64 = jax.jit(jax.grad(lambda p: jb.stateful_loss_fn(
            p, stats, (x.astype(np.float64), y.astype(np.float64)))[0]))(
                _x64(jb.state.params))
        exact = _named(jax.device_get(g64))
    jg = _named(jax.device_get(g32))
    port64 = _f64_grads(tb.state.model, x, y)
    model = tb.state.model.train()
    loss, _ = tb.stateful_loss_fn(model, (x, y))
    loss.backward()
    held = 0
    for name, p in model.named_parameters():
        ref = exact[name]
        norm = float(ref.norm())
        assert _rel(port64[name], ref, norm) <= 1e-9, name
        port_err, jax_err = _rel(p.grad, ref, norm), _rel(jg[name], ref, norm)
        # ``-s`` shows each tensor's distances from JAX's float64.
        print(f"{name}: port fp32 {port_err:.2e}, JAX fp32 {jax_err:.2e}, "
              f"port float64 {_rel(port64[name], ref, norm):.2e}")
        assert port_err <= max(jax_err, 1e-5), (name, port_err, jax_err)
        assert port_err <= 5e-3, (name, port_err)
        if jax_err <= ROUNDING:
            held += 1
            assert _rel(p.grad, jg[name], norm) <= 1e-4, (name, jax_err)
    assert held >= 5               # the 1e-4 check is not vacuous


def test_resnet_three_sgd_steps_match_jax(monkeypatch):
    """Three stateful sync steps (SGD, lr 0.01, the CIFAR stand-in)
    against JAX's.  float64 (JAX under ``jax.enable_x64``): the loss, the
    running statistics and every parameter's update within 1e-9.  fp32:
    the loss and the running statistics after each step against JAX's,
    each parameter's update within 1e-4 of JAX's where JAX's fp32 update
    is within ``ROUNDING`` of its float64 one, and the whole update at
    least as close to float64 as JAX's (BatchNorm amplifies each step's
    fp32 rounding: JAX's distance grows from ~1% of the update to ~7% in
    three steps, the port's from ~0.1% to ~4%)."""
    jb = _jax_bundle("resnet20")
    js = jb.state.replace(tx=optax.sgd(0.01),
                          opt_state=optax.sgd(0.01).init(jb.state.params))
    tb = _port("resnet20", jb, lr=0.01)
    exact = _port("resnet20", jb, lr=0.01)
    exact.state.model.double()
    exact.state.model_state = tresnet.batch_stats(exact.state.model)
    jstep = jsync.build_stateful_sync_train_step(None, jb.stateful_loss_fn,
                                                 donate=False)
    tstep = tsync.build_stateful_sync_train_step(tb.stateful_loss_fn)
    xstep = tsync.build_stateful_sync_train_step(exact.stateful_loss_fn)
    with jax.enable_x64(True):
        p64 = _x64(jb.state.params)
        js64 = js.replace(params=p64, opt_state=optax.sgd(0.01).init(p64),
                          model_state=_x64(jb.state.model_state))
    ds = read_cifar10("/nonexistent").train
    ts, xs = tb.state, exact.state
    before = {n: p.detach().double().clone()
              for n, p in ts.model.named_parameters()}
    held = 0
    for i in range(3):
        batch = ds.next_batch(16)
        js, jm = jstep(js, batch)
        with jax.enable_x64(True):
            js64, jm64 = jstep(js64, tuple(a.astype(np.float64)
                                           for a in batch))
        ts, tm = tstep(ts, batch)
        with monkeypatch.context() as mp:
            mp.setattr(tresnet, "nhwc_images", lambda t, s, c: t.reshape(
                -1, s, s, c).double())
            xs, xm = xstep(xs, batch)
        assert tm["global_step"] == int(jm["global_step"]) == i + 2
        # float64: the port is JAX.
        assert abs(float(xm["loss"]) - float(jm64["loss"])) <= 1e-9, i
        stats64 = _named(jax.device_get(js64.model_state))
        for name, t in xs.model_state.items():
            np.testing.assert_allclose(t.numpy(), stats64[name].numpy(),
                                       atol=1e-9, rtol=0,
                                       err_msg=f"step {i}: {name}")
        want64 = _named(jax.device_get(js64.params))
        got64 = dict(xs.model.named_parameters())
        for name, w in want64.items():
            norm = float((w - before[name]).norm())
            assert _rel(got64[name].detach(), w, norm) <= 1e-9, (i, name)
        # fp32.
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 2e-4, i
        stats = tresnet.params_from_jax({}, jax.device_get(js.model_state))
        for name, t in ts.model_state.items():
            np.testing.assert_allclose(
                t.numpy(), stats[name].numpy(), rtol=0,
                atol=1e-5 if i == 0 else 2e-4, err_msg=f"step {i}: {name}")
        want = _named(jax.device_get(js.params))
        got = dict(ts.model.named_parameters())
        for name, w in want.items():
            upd64 = want64[name] - before[name]
            norm = float(upd64.norm())
            jax_err = _rel(w - before[name], upd64, norm)
            if jax_err <= ROUNDING:
                held += 1
                assert _rel(got[name].detach(), w, norm) <= 1e-4, (
                    i, name, jax_err)
        flat = lambda d: torch.cat([(d[n].detach().double() - before[n])
                                    .flatten() for n in sorted(before)])
        upd_x = flat(want64)
        norm = float(upd_x.norm())
        port_err = float((flat(got) - upd_x).norm()) / norm
        jax_err = float((flat(want) - upd_x).norm()) / norm
        assert port_err <= jax_err, (i, port_err, jax_err)
    assert held >= 5               # the 1e-4 check is not vacuous


# ---------------------------------------------------------- train steps


STEP_CASES = {
    "lenet5": dict(kw={}, n=784, lr=0.2),
    "vit_f32_xla": dict(kw=dict(dtype="float32"), n=3072, lr=0.1),
    "vit_f32_pallas": dict(kw=dict(dtype="float32",
                                   attention_backend="pallas",
                                   fused_ln=True), n=3072, lr=0.1),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_three_sgd_steps_match_jax(case):
    spec = STEP_CASES[case]
    name = case.split("_")[0] if case.startswith("lenet") else "vit_tiny"
    jb = _jax_bundle(name, **spec["kw"])
    lr = spec["lr"]
    js = jb.state.replace(tx=optax.sgd(lr),
                          opt_state=optax.sgd(lr).init(jb.state.params))
    tb = _port(name, jb, lr=lr, **spec["kw"])
    jstep = jsync.build_sync_train_step(None, jb.loss_fn, donate=False,
                                        log_grad_norm=True)
    tstep = tsync.build_sync_train_step(tb.loss_fn, log_grad_norm=True)
    ts = tb.state
    conv = tlenet.params_from_jax if name == "lenet5" else \
        tvit.params_from_jax
    before = _flat(dict(ts.model.named_parameters()))
    for i in range(3):
        batch = _images(8, spec["n"], seed=10 + i)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        want = conv(jax.device_get(js.params))
        got = dict(ts.model.named_parameters())
        for n, w in want.items():
            np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                       atol=1e-5, rtol=0,
                                       err_msg=f"step {i}: {n}")
        cos = torch.nn.functional.cosine_similarity(
            _flat(got) - before, _flat(want) - before, dim=0)
        assert cos >= 0.99999, (i, float(cos))


def test_vit_bf16_steps_track_jax():
    """bf16 activations round at other places in the two frameworks:
    the GPT training test's bf16 tolerances."""
    jb = _jax_bundle("vit_tiny", attention_backend="pallas", fused_ln=True)
    js = jb.state.replace(tx=optax.sgd(0.1),
                          opt_state=optax.sgd(0.1).init(jb.state.params))
    tb = _port("vit_tiny", jb, lr=0.1, attention_backend="pallas",
               fused_ln=True)
    assert tb.state.model.layer0.qkv.kernel.dtype == torch.float32
    jstep = jsync.build_sync_train_step(None, jb.loss_fn, donate=False)
    tstep = tsync.build_sync_train_step(tb.loss_fn)
    ts = tb.state
    before = _flat(dict(ts.model.named_parameters()))
    for i in range(3):
        batch = _images(8, 3072, seed=20 + i)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=BF16["loss_tol"])
        want = tvit.params_from_jax(jax.device_get(js.params))
        got = dict(ts.model.named_parameters())
        for n, w in want.items():
            np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                       atol=BF16["param_atol"], rtol=0,
                                       err_msg=f"step {i}: {n}")
        cos = torch.nn.functional.cosine_similarity(
            _flat(got) - before, _flat(want) - before, dim=0)
        assert cos >= BF16["min_cos"], (i, float(cos))


def test_lenet_adam_steps_match_jax():
    jb = _jax_bundle("lenet5")
    tx = optax.adam(1e-3)
    js = jb.state.replace(tx=tx, opt_state=tx.init(jb.state.params))
    tb = _port("lenet5", jb, lr=1e-3, opt="adam")
    jstep = jsync.build_sync_train_step(None, jb.loss_fn, donate=False)
    tstep = tsync.build_sync_train_step(tb.loss_fn)
    ts = tb.state
    ds = read_data_sets("/nonexistent").train
    for i in range(3):
        batch = ds.next_batch(16)
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=0)
    want = tlenet.params_from_jax(jax.device_get(js.params))
    got = dict(ts.model.named_parameters())
    for n, w in want.items():
        np.testing.assert_allclose(got[n].detach().numpy(), w.numpy(),
                                   atol=1e-5, rtol=0, err_msg=n)


# ------------------------------------------------------------------ ViT


def test_vit_logits_match_jax_and_take_flat_or_nhwc_input():
    jb = _jax_bundle("vit_tiny", dtype="float32")
    tb = _port("vit_tiny", jb, dtype="float32")
    x, _ = _images(3, 3072, seed=5)
    want = np.asarray(jb.state.apply_fn(jb.state.params, x))
    m = tb.state.model
    np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(), want,
                               atol=1e-4, rtol=0)
    nhwc = torch.from_numpy(x.reshape(3, 32, 32, 3))
    np.testing.assert_allclose(m(nhwc).detach().numpy(), want, atol=1e-4,
                               rtol=0)


def test_vit_patchify_is_the_jax_layout():
    """Patch (row 1, col 2) is the image block [4:8, 8:12] (a pure
    reshape/transpose, JAX ``vit.py:107-109``): the embedding of a
    one-hot image lights that patch only."""
    cfg = tvit.VitConfig(dtype="float32")
    model = tvit.VitClassifier(cfg, device="cpu")
    x = torch.zeros(1, 32, 32, 3)
    x[0, 5, 9, 1] = 1.0
    seen = {}
    model.patch_embed.register_forward_hook(
        lambda mod, args, out: seen.update(input=args[0]))
    model(x)
    hot = torch.nonzero(seen["input"][0])
    n = 32 // cfg.patch_size
    assert hot.tolist() == [[1 * n + 2, (1 * 4 + 1) * 3 + 1]]


def test_vit_parameter_tree_is_flax_s():
    jb = _jax_bundle("vit_tiny", dtype="float32")
    tb = _port("vit_tiny", jb, dtype="float32")
    tree = tvit.params_to_jax(tb.state.model.state_dict())
    want = jax.tree_util.tree_structure(jax.device_get(jb.state.params))
    assert jax.tree_util.tree_structure(tree) == want
    for a, b in zip(jax.tree.leaves(tree),
                    jax.tree.leaves(jax.device_get(jb.state.params))):
        assert a.shape == b.shape


def test_registry_param_counts():
    """ResNet-20 is the classic ~0.27M parameters; every bundle's tree
    has the JAX bundle's leaf shapes."""
    for name in ("lenet5", "resnet20"):
        jb = _jax_bundle(name)
        tb = _port(name, jb)
        n = sum(p.numel() for p in tb.state.model.parameters())
        assert n == sum(np.prod(p.shape) for p in jax.tree.leaves(
            jb.state.params))
        if name == "resnet20":
            assert 250_000 < n < 300_000
            assert set(tb.state.model_state) == set(tresnet.params_from_jax(
                {}, jax.device_get(jb.state.model_state)))
