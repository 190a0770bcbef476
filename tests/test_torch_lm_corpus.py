"""The port's corpus path (``distributed_tensorflow_tpu_torch/data/lm.py``:
the byte corpus, ``CorpusFiles``, the streaming ``StreamingByteLmStream``
and ``make_lm_datasets``) and the trainer's cursor resume against the
JAX package's.

**Mirrored cases.**  Every library case of ``tests/test_lm_corpus.py``
runs against the port (its imports of the JAX ``data.lm`` and
``models.gpt`` pointed at the port).  Its two CLI cases have their port
counterpart below: gpt_mini trained through the port's CLI on a
streaming BPE corpus with ``--optimizer=adafactor``, resumed from its
saved cursor, then ``--mode=generate --gen_prompt_text``.

**Interop.**  For the same files, seed and geometry the port's streams
give the JAX streams' batches bit for bit (bytes and BPE, every shard,
across chunk advances), and each package resumes from the other's
cursor JSON.
"""

import json

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu.data import lm as jlm
from distributed_tensorflow_tpu.data import tokenizer as jtok
from distributed_tensorflow_tpu_torch import train as ttrain
from distributed_tensorflow_tpu_torch.cluster.server import Server
from distributed_tensorflow_tpu_torch.data import lm as tlm
from distributed_tensorflow_tpu_torch.data import tokenizer as ttok
from test_torch_param_sync import mirror_module, run_mirrored

REPLACE = (("from distributed_tensorflow_tpu.data",
            "from distributed_tensorflow_tpu_torch.data"),
           ("from distributed_tensorflow_tpu.models import gpt",
            "from distributed_tensorflow_tpu_torch.models import gpt"))
CLI_CASES = ("test_e2e_gpt_trains_on_real_corpus",
             "test_e2e_gpt_streaming_corpus_with_cursor_resume")
MIRROR = mirror_module("test_lm_corpus.py", REPLACE)
CASES = [n for n in vars(MIRROR)
         if n.startswith("test_") and n not in CLI_CASES]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CASES)
def test_mirrored(name, request):
    run_mirrored(getattr(MIRROR, name), request)


def test_mirror_uses_the_port():
    assert MIRROR.make_lm_datasets is tlm.make_lm_datasets
    assert {"test_streaming_cursor_resume_deterministic",
            "test_streaming_shards_draw_disjoint_chunks",
            "test_streaming_bpe_trains_on_sample"} <= set(CASES)


def _write(tmp_path, n=60_000, seed=0):
    rng = np.random.default_rng(seed)
    words = np.array(["the ", "port ", "streams ", "a ", "corpus ", "\n"])
    text = "".join(rng.choice(words, n // 5))
    (tmp_path / "b.txt").write_text(text[: len(text) // 3])
    (tmp_path / "a.txt").write_text(text[len(text) // 3:])
    return sorted(str(p) for p in tmp_path.glob("*.txt"))


@pytest.mark.parametrize("bpe", [False, True])
def test_streamed_batches_equal_the_jax_streams(tmp_path, bpe):
    paths = _write(tmp_path)
    encode = {}
    if bpe:
        sample = jlm.CorpusFiles(paths).read(0, 20_000)
        encode = dict(j=jtok.BpeTokenizer.train(sample, 320).encode,
                      t=ttok.BpeTokenizer.train(sample, 320).encode)

    def streams(pkg, tag):
        files = pkg.CorpusFiles(paths)
        base = pkg.StreamingByteLmStream(files, 0, files.total, seq_len=24,
                                         seed=9, chunk_bytes=5000,
                                         encode=encode.get(tag))
        return [base, base.shard(1, 3)]

    for j, t in zip(streams(jlm, "j"), streams(tlm, "t")):
        for _ in range(12):             # several chunk advances
            np.testing.assert_array_equal(t.next_batch(6)["tokens"],
                                          j.next_batch(6)["tokens"])
        for a, b in zip(t.fixed_batches(3, 2), j.fixed_batches(3, 2)):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert t.cursor() == j.cursor()


def test_cursor_json_crosses_the_packages(tmp_path):
    paths = _write(tmp_path)

    def mk(pkg):
        files = pkg.CorpusFiles(paths)
        return pkg.StreamingByteLmStream(files, 0, files.total, seq_len=16,
                                         seed=4, chunk_bytes=4096)
    for src, dst in ((jlm, tlm), (tlm, jlm)):
        a = mk(src)
        for _ in range(9):
            a.next_batch(8)
        b = mk(dst)
        assert b.restore_cursor(json.loads(json.dumps(a.cursor())))
        for _ in range(6):
            np.testing.assert_array_equal(b.next_batch(8)["tokens"],
                                          a.next_batch(8)["tokens"])


def test_make_lm_datasets_equals_jax_with_bpe(tmp_path):
    """In memory and streaming, with the tokenizer saved: the same
    splits, batches and ``tokenizer.json``."""
    _write(tmp_path)
    from distributed_tensorflow_tpu.models import gpt as jgpt
    from distributed_tensorflow_tpu_torch.models import gpt as tgpt
    for threshold in (1 << 30, 1024):
        kw = dict(seq_len=20, data_dir=str(tmp_path), tokenizer="bpe",
                  bpe_vocab=300, stream_threshold_bytes=threshold,
                  stream_chunk_bytes=8192)
        jd = jlm.make_lm_datasets(jgpt.mini(), tokenizer_path=str(
            tmp_path / "j" / "tokenizer.json"), **kw)
        td = tlm.make_lm_datasets(tgpt.mini(), tokenizer_path=str(
            tmp_path / "t" / "tokenizer.json"), **kw)
        assert (tmp_path / "t" / "tokenizer.json").read_bytes() == \
            (tmp_path / "j" / "tokenizer.json").read_bytes()
        for split in ("train", "validation", "test"):
            a, b = getattr(td, split), getattr(jd, split)
            assert type(a).__name__ == type(b).__name__
            for _ in range(3):
                np.testing.assert_array_equal(a.next_batch(4)["tokens"],
                                              b.next_batch(4)["tokens"])


# ------------------------------------------------------------------ CLI


@pytest.fixture
def standalone(monkeypatch):
    orig = Server.__init__

    def patched(self, cluster, job_name, task_index, **kw):
        kw["coord_service"] = False
        kw["initialize_distributed"] = False
        orig(self, cluster, job_name, task_index, **kw)
    monkeypatch.setattr(Server, "__init__", patched)


def test_cli_bpe_streaming_adafactor_resume_and_generate(tmp_path,
                                                         standalone, capsys):
    """The JAX CLI cases ``test_e2e_gpt_trains_with_bpe_tokenizer`` and
    ``test_e2e_gpt_streaming_corpus_with_cursor_resume`` on the port: a
    BPE corpus past ``--gpt_stream_corpus_mb`` streams, adafactor trains
    it, the cursor and ``tokenizer.json`` land beside the checkpoints, a
    rerun restores the cursor and goes on, and generate mode encodes a
    text prompt and decodes its output through the saved tokenizer."""
    data_dir = tmp_path / "corpus"
    data_dir.mkdir()
    _write(data_dir, n=200_000)
    logdir = tmp_path / "logdir"
    common = ["--job_name=worker", "--task_index=0", "--device=cpu",
              "--worker_hosts=localhost:0", "--ps_hosts=localhost:0",
              "--model=gpt_mini", f"--data_dir={data_dir}",
              "--bert_seq_len=32", "--batch_size=8", "--sync_replicas=true",
              "--gpt_tokenizer=bpe", "--gpt_bpe_vocab=384",
              "--gpt_stream_corpus_mb=0", "--optimizer=adafactor",
              "--learning_rate=0.01", "--log_every=2",
              "--save_interval_steps=2", f"--logdir={logdir}"]
    result = ttrain.app.run(ttrain.main, common + ["--train_steps=4"])
    out = capsys.readouterr().out
    assert "gpt bpe streaming corpus" in out
    assert result.final_global_step >= 4
    run = logdir / "gpt_mini"
    cursor = json.loads((run / "data_cursor_p0.json").read_text())
    assert cursor["geometry"][3] == 32
    tok = ttok.BpeTokenizer.load(str(run / "tokenizer.json"))
    assert 256 < tok.vocab_size <= 384

    result = ttrain.app.run(ttrain.main, common + ["--train_steps=8"])
    out = capsys.readouterr().out
    assert "restored streaming-corpus cursor" in out
    assert result.final_global_step >= 8
    assert json.loads((run / "data_cursor_p0.json").read_text()) != cursor

    toks = ttrain.app.run(ttrain.main, common + [
        "--mode=generate", "--gen_tokens=8", "--gen_prompt_text=the port ",
        "--gen_stop_text=zzz"])
    out = capsys.readouterr().out
    assert "Generated text:" in out
    prompt = tok.encode(b"the port ")
    np.testing.assert_array_equal(toks[:len(prompt)], prompt)
    assert toks.max() < 384
