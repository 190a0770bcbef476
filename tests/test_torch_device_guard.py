"""Every kernel wrapper of the port launches on its operands' card.

A C entry point launches on the *current* CUDA device, with the stream
it is handed, and opts its kernel in to large shared memory on that
device.  So each wrapper (K1-K8) must make its operands' device current
before it calls ``lib.dtt_*``: otherwise a call on ``cuda:1`` while
``cuda:0`` is current launches on the wrong card.  These tests run on the
CPU: the operands are fake tensors on ``cuda:1``
(``torch._subclasses.fake_tensor``), the library is a recorder, and
``torch.cuda.device`` is a stand-in that records which device is entered
when each entry point is called (a wrapper whose operands' card is
already current may call straight in).  The card-side test is
``test_kernels_launch_on_a_second_card`` in
``tests/test_torch_kernels_cuda.py``.
"""

import contextlib
import warnings

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from distributed_tensorflow_tpu_torch.ops import flash_attention as fa
from distributed_tensorflow_tpu_torch.ops import kernels
from distributed_tensorflow_tpu_torch.ops import layer_norm as ln
from distributed_tensorflow_tpu_torch.ops import quant_matmul as qmm

CARD = torch.device("cuda", 1)


class _Recorder:
    """The fake library and the stand-ins for ``torch.cuda.device`` and
    the current-device query."""

    def __init__(self):
        self.current = 0       # the current card outside any guard
        self.entered = []      # devices currently entered, innermost last
        self.guards = 0        # guards entered so far
        self.calls = []        # (entry point, current card at the call)
        self.args = []         # each call's arguments, the stream included

    def current_device(self):
        return self.entered[-1].index if self.entered else self.current

    def device(self, dev):
        rec = self

        @contextlib.contextmanager
        def guard():
            rec.entered.append(torch.device(dev))
            rec.guards += 1
            try:
                yield
            finally:
                rec.entered.pop()
        return guard()

    def __getattr__(self, name):
        if not name.startswith("dtt_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, torch.device("cuda",
                                                  self.current_device())))
            self.args.append(args)
            return 0
        return entry


def _contiguous(self, memory_format=torch.contiguous_format):
    # The CPU build's binding of Tensor.contiguous takes a device guard
    # that a fake CUDA tensor cannot; clone is the same operation.
    if self.is_contiguous(memory_format=memory_format):
        return self
    return self.clone(memory_format=memory_format)


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(kernels, "load", lambda: rec)
    monkeypatch.setattr(torch.cuda, "device", rec.device)
    # launch reads the current card and the raw stream handle through
    # bindings that a CPU build of PyTorch does not have (hence
    # raising=False); test_launch_reads_the_card_and_stream_that_torch_
    # cuda_reports in tests/test_torch_kernels_cuda.py holds them on the
    # card.
    monkeypatch.setattr(torch._C, "_cuda_getDevice", rec.current_device,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    monkeypatch.setattr(torch.Tensor, "contiguous", _contiguous)
    with warnings.catch_warnings():
        # data_ptr() of a fake tensor is 0, with a deprecation warning.
        warnings.simplefilter("ignore")
        with FakeTensorMode():
            yield rec


def _empty(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device=CARD)


def _k1():
    q, k, v = (_empty(2, 64, 4, 128) for _ in range(3))
    fa.flash_attention(q, k, v, _empty(2, 64, dtype=torch.int32),
                       causal=True)


def _k2b():
    q, k, v, o, do = (_empty(2, 64, 4, 64) for _ in range(5))
    fa.flash_attention_backward_dq(q, k, v, None, o,
                                   _empty(8, 64, dtype=torch.float32), do,
                                   causal=True)


def _k2a():
    q, k, v, do = (_empty(2, 64, 4, 64) for _ in range(4))
    stats = _empty(8, 64, dtype=torch.float32)
    fa.flash_attention_backward_dkv(q, k, v, None, stats, stats, do,
                                    causal=False)


def _k3():
    ln.layer_norm(_empty(16, 256), _empty(256, dtype=torch.float32),
                  _empty(256, dtype=torch.float32))


def _k4():
    qmm.quantized_matmul(_empty(64, 512), _empty(512, 256, dtype=torch.int8),
                         _empty(1, 256, dtype=torch.float32),
                         activation="gelu", want_preact=True)


def _k5():
    qmm.quantized_matmul_nt(_empty(64, 512),
                            _empty(256, 512, dtype=torch.int8),
                            _empty(1, 512, dtype=torch.float32))


def _k8():
    qmm.quantized_matmul_dgelu(_empty(64, 512), _empty(64, 512),
                               _empty(512, 256, dtype=torch.int8),
                               _empty(1, 256, dtype=torch.float32))


def _chunk_state(B=2, S=64, H=4, D=128):
    q, k, v, do = (_empty(B, S, H, D) for _ in range(4))
    rows = _empty(B, H, S, dtype=torch.float32)
    return q, k, v, do, rows


def _k6():
    q, k, v, _, rows = _chunk_state()
    fa.flash_attention_chunk(q, k, v, None, rows, rows,
                             _empty(2, 4, 64, 128, dtype=torch.float32),
                             q_offset=64, k_offset=0, causal=True)


def _k7a():
    q, k, v, do, rows = _chunk_state()
    fa.flash_attention_chunk_dq(q, k, v, None, do, rows, rows, q_offset=0,
                                k_offset=0, causal=True)


def _k7b():
    q, k, v, do, rows = _chunk_state()
    fa.flash_attention_chunk_dkv(q, k, v, None, do, rows, rows, q_offset=0,
                                 k_offset=0, causal=True, window=32)


def _k7a_out():
    """K7a adding into the ring's dq sum (``out=``)."""
    q, k, v, do, rows = _chunk_state()
    fa.flash_attention_chunk_dq(q, k, v, None, do, rows, rows, q_offset=64,
                                k_offset=0, causal=True,
                                out=_empty(2, 4, 64, 128,
                                           dtype=torch.float32))


def _k7b_out():
    """K7b adding into the ring's dk and dv sums (``out=``)."""
    q, k, v, do, rows = _chunk_state()
    sums = tuple(_empty(2, 4, 64, 128, dtype=torch.float32)
                 for _ in range(2))
    fa.flash_attention_chunk_dkv(q, k, v, None, do, rows, rows, q_offset=64,
                                 k_offset=0, causal=True, out=sums)


WRAPPERS = [("K1", _k1, "dtt_flash_attention_fwd"),
            ("K2b", _k2b, "dtt_flash_attention_bwd_dq"),
            ("K2a", _k2a, "dtt_flash_attention_bwd_dkv"),
            ("K3", _k3, "dtt_layer_norm_fwd"),
            # K4 and K5 launch two kernels each, the quantize pass and the
            # block-scaled GEMM; K4 transposes its weight between them.
            ("K4", _k4, ("dtt_quant_blocks", "dtt_transpose_s8",
                         "dtt_quant_gemm")),
            ("K5", _k5, ("dtt_quant_blocks", "dtt_quant_gemm")),
            ("K6", _k6, "dtt_flash_attention_chunk"),
            ("K7a", _k7a, "dtt_flash_attention_chunk_bwd"),
            ("K7b", _k7b, "dtt_flash_attention_chunk_bwd"),
            ("K7a_out", _k7a_out, "dtt_flash_attention_chunk_bwd"),
            ("K7b_out", _k7b_out, "dtt_flash_attention_chunk_bwd"),
            # K8: the quantize pass with gelu', K4's transpose, the GEMM.
            ("K8", _k8, ("dtt_quant_blocks", "dtt_transpose_s8",
                         "dtt_quant_gemm"))]


def _calls(entry):
    """The (entry point, card) calls a wrapper makes, in order."""
    return [(e, CARD) for e in ((entry,) if isinstance(entry, str)
                                else entry)]


@pytest.mark.parametrize("kernel,drive,entry", WRAPPERS,
                         ids=[w[0] for w in WRAPPERS])
def test_wrapper_enters_the_operands_device(recorder, kernel, drive, entry):
    drive()
    assert recorder.calls == _calls(entry), kernel
    assert recorder.entered == []          # the guard was left again


@pytest.mark.parametrize("kernel,drive,entry", WRAPPERS,
                         ids=[w[0] for w in WRAPPERS])
def test_wrapper_calls_straight_in_when_its_card_is_current(recorder, kernel,
                                                            drive, entry):
    recorder.current = CARD.index
    drive()
    assert recorder.calls == _calls(entry), kernel
    assert recorder.guards == 0            # no guard: the card was current


@pytest.mark.parametrize("kernel,drive,entry", WRAPPERS,
                         ids=[w[0] for w in WRAPPERS])
def test_wrapper_passes_every_argument_of_the_signature(recorder, kernel,
                                                        drive, entry):
    """Each call hands its entry point as many arguments as
    ``kernels.SIGNATURES`` declares (the stream last); K7a/K7b pass
    ``accumulate`` before the stream: 1 with ``out=``, else 0."""
    drive()
    assert len(recorder.args) == len(_calls(entry)), kernel
    for (name, _), args in zip(recorder.calls, recorder.args):
        assert len(args) == len(kernels.SIGNATURES[name]), kernel
    if kernel.startswith("K7"):
        assert args[-2] == int(kernel.endswith("_out")), kernel


def _attention_d32(kernel):
    """Drive K1, K2b, K2a, K6, K7a or K7b at head_dim 32 (the JAX
    GptConfig's default width)."""
    q, k, v, o, do = (_empty(2, 64, 4, 32) for _ in range(5))
    stats = _empty(8, 64, dtype=torch.float32)
    rows = _empty(2, 4, 64, dtype=torch.float32)
    acc = _empty(2, 4, 64, 32, dtype=torch.float32)
    chunk = dict(q_offset=64, k_offset=0, causal=True)
    {"K1": lambda: fa.flash_attention(q, k, v, causal=True),
     "K2b": lambda: fa.flash_attention_backward_dq(q, k, v, None, o, stats,
                                                   do, causal=True),
     "K2a": lambda: fa.flash_attention_backward_dkv(q, k, v, None, stats,
                                                    stats, do, causal=True),
     "K6": lambda: fa.flash_attention_chunk(q, k, v, None, rows, rows, acc,
                                            in_place=True, **chunk),
     "K7a": lambda: fa.flash_attention_chunk_dq(q, k, v, None, do, rows,
                                                rows, **chunk),
     "K7b": lambda: fa.flash_attention_chunk_dkv(q, k, v, None, do, rows,
                                                 rows, **chunk)}[kernel]()


@pytest.mark.parametrize("kernel,entry", [
    ("K1", "dtt_flash_attention_fwd"), ("K2b", "dtt_flash_attention_bwd_dq"),
    ("K2a", "dtt_flash_attention_bwd_dkv"),
    ("K6", "dtt_flash_attention_chunk"),
    ("K7a", "dtt_flash_attention_chunk_bwd"),
    ("K7b", "dtt_flash_attention_chunk_bwd")])
def test_attention_wrappers_take_head_dim_32(recorder, kernel, entry):
    """The CUDA-side checks pass head_dim 32 on to the kernel."""
    _attention_d32(kernel)
    assert recorder.calls == [(entry, CARD)], kernel


def test_attention_wrappers_refuse_other_head_dims(recorder):
    q = _empty(2, 64, 4, 48)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, causal=True)
    assert recorder.calls == []


def test_launch_enters_the_device_and_raises_on_a_launch_error(recorder):
    def failing(*args):
        recorder.calls.append(("dtt_fail", recorder.entered[-1]))
        return 1
    recorder.dtt_fail = failing
    with pytest.raises(RuntimeError, match="fail launch failed"):
        kernels.launch("fail", CARD, 0)
    assert recorder.calls == [("dtt_fail", CARD)]
