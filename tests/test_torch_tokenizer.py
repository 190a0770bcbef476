"""The port's BPE tokenizer (``distributed_tensorflow_tpu_torch/data/
tokenizer.py`` over its own ``csrc/tokenizer/bpe.cc``) against the JAX
package's.

**Mirrored cases.**  Every library case of ``tests/test_tokenizer.py``
(the tokenizer and ``make_lm_datasets(tokenizer="bpe")``) runs against
the port: the JAX test module is loaded with its imports of the JAX
``data`` and ``models.gpt`` modules pointed at the port (``test_mirrored``).
Its two CLI cases have their port counterparts in
``tests/test_torch_lm_corpus.py`` (train, resume, generate) and below
(the flag errors).

**Interop.**  For the same bytes and vocabulary both packages train the
same merges, encode the same ids, and write and read the same
``tokenizer.json``; the native core is the port's own build, held to the
NumPy reference, and a failed build raises naming ``g++``.
"""

import json
import os

import numpy as np
import pytest

from distributed_tensorflow_tpu.data import tokenizer as jtok
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.cluster.server import Server
from distributed_tensorflow_tpu_torch.data import tokenizer as ttok
from test_torch_param_sync import mirror_module, run_mirrored

#: The JAX test's own imports of the data path and the GPT config,
#: pointed at the port.
REPLACE = (("from distributed_tensorflow_tpu.data",
            "from distributed_tensorflow_tpu_torch.data"),
           ("from distributed_tensorflow_tpu.models import gpt",
            "from distributed_tensorflow_tpu_torch.models import gpt"))
#: The JAX CLI's cases: their port counterparts are named above.
CLI_CASES = ("test_e2e_gpt_trains_with_bpe_tokenizer",
             "test_e2e_rejects_bad_tokenizer_flags")
MIRROR = mirror_module("test_tokenizer.py", REPLACE)
CASES = [n for n in vars(MIRROR)
         if n.startswith("test_") and n not in CLI_CASES]


@pytest.mark.parametrize("name", CASES)
def test_mirrored(name, request):
    run_mirrored(getattr(MIRROR, name), request)


def test_mirror_uses_the_port():
    assert MIRROR.BpeTokenizer is ttok.BpeTokenizer
    assert MIRROR.tok_lib is ttok
    assert len(CASES) + len(CLI_CASES) == 17


def _corpus(seed, n=6000):
    rng = np.random.default_rng(seed)
    words = [b"the ", b"port ", b"kernel ", b"card ", b"step ", b"aaaa ",
             bytes(rng.integers(0, 256, 3, dtype=np.uint8))]
    return b"".join(words[i] for i in rng.integers(0, len(words), n))


@pytest.mark.parametrize("seed,vocab", [(0, 300), (1, 512), (2, 257)])
def test_merges_and_ids_equal_the_jax_tokenizer(seed, vocab, tmp_path):
    data = _corpus(seed)
    want = jtok.BpeTokenizer.train(data, vocab)
    got = ttok.BpeTokenizer.train(data, vocab)
    assert got.merges == want.merges
    tail = _corpus(seed + 10, 500)
    np.testing.assert_array_equal(got.encode(tail), want.encode(tail))
    assert got.decode(got.encode(tail)) == tail
    # tokenizer.json: the same bytes, read by the other package.
    got.save(str(tmp_path / "t.json"))
    want.save(str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert jtok.BpeTokenizer.load(str(tmp_path / "t.json")).merges == \
        got.merges
    assert ttok.BpeTokenizer.load(str(tmp_path / "j.json")).merges == \
        want.merges


def test_the_native_core_is_the_ports_own_build():
    assert ttok.native_library()
    lib = ttok._load_library()
    assert os.path.dirname(lib._name) == ttok._BUILD
    assert ttok._SRC.endswith(os.path.join(
        "distributed_tensorflow_tpu_torch", "csrc", "tokenizer", "bpe.cc"))


def test_a_failed_build_raises_naming_gxx(monkeypatch):
    def fail(lib_path, src, extra_flags=()):
        raise OSError("g++: not found")
    monkeypatch.setattr(ttok, "_lib", None)
    monkeypatch.setattr(ttok, "build_and_load", fail)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        ttok.BpeTokenizer.train(b"abab" * 10, 260)


@pytest.fixture
def standalone(monkeypatch):
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


@pytest.mark.parametrize("flags,match", [
    (("--gpt_tokenizer=bpe", "--gpt_bpe_vocab=256"), "gpt_bpe_vocab"),
    (("--gpt_tokenizer=wordpiece",), "gpt_tokenizer"),
])
def test_cli_rejects_bad_tokenizer_flags(tmp_path, standalone, flags,
                                         match):
    """The JAX CLI's ``test_e2e_rejects_bad_tokenizer_flags``."""
    with pytest.raises(ValueError, match=match):
        ttrain.app.run(ttrain.main, [
            "--job_name=worker", "--task_index=0", "--device=cpu",
            "--worker_hosts=localhost:0", "--ps_hosts=localhost:0",
            "--model=gpt_mini", f"--logdir={tmp_path}", *flags])
