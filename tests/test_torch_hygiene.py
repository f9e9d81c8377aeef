"""hetu_tpu_torch stands alone: it imports with JAX and hetu_tpu
blocked, its entry points default to CUDA and raise without it, and
the telemetry stub refuses to record silently."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hetu_tpu_torch import resolve_device
from hetu_tpu_torch import telemetry
import hetu_tpu_torch as ht
from hetu_tpu_torch.examples import (cnn_main, ctr_main, gcn_main,
                                     rec_main, sampled_sage,
                                     transformer_main)
from hetu_tpu_torch.ndarray import CSRValue
from hetu_tpu_torch.models.gpt import (GPTConfig, GPTLMHeadModel,
                                       gpt_serving_params, init_kv_cache,
                                       random_gpt_checkpoint)
from hetu_tpu_torch.serving import (ContinuousBatchingEngine, GPTDecoder,
                                    InferenceSession, PagedKVCache)

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(vocab_size=32, hidden_size=16, num_hidden_layers=1,
           num_attention_heads=2, max_position_embeddings=16)


def test_imports_without_jax_or_hetu_tpu():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'hetu_tpu'):\n"
        "    sys.modules[name] = None      # any import of them fails\n"
        "import hetu_tpu_torch, chip_smoke\n"
        "import hetu_tpu_torch.ops.attention, hetu_tpu_torch.ops._build\n"
        "import hetu_tpu_torch.models, hetu_tpu_torch.serving\n"
        "import hetu_tpu_torch.telemetry, hetu_tpu_torch.models.gpt\n"
        "import hetu_tpu_torch.serving.session, hetu_tpu_torch.serving.decode\n"
        "import hetu_tpu_torch.serving.batcher, hetu_tpu_torch.serving.router\n"
        "import hetu_tpu_torch.serving.http, hetu_tpu_torch.serving.scheduler\n"
        "import hetu_tpu_torch.data, hetu_tpu_torch.dataloader\n"
        "import hetu_tpu_torch.metrics, hetu_tpu_torch.models.cnn\n"
        "import hetu_tpu_torch.ops.conv\n"
        "import hetu_tpu_torch.examples.cnn_main\n"
        "import hetu_tpu_torch.models.ctr, hetu_tpu_torch.models.ncf\n"
        "import hetu_tpu_torch.models.transformer\n"
        "import hetu_tpu_torch.ops.basic, hetu_tpu_torch.ops.shape\n"
        "import hetu_tpu_torch.ops.losses, hetu_tpu_torch.ops.activations\n"
        "import hetu_tpu_torch.examples.ctr_main\n"
        "import hetu_tpu_torch.examples.rec_main\n"
        "import hetu_tpu_torch.examples.movielens\n"
        "import hetu_tpu_torch.examples.transformer_main\n"
        "import hetu_tpu_torch.models.gnn, hetu_tpu_torch.ops.sparse\n"
        "import hetu_tpu_torch.stream, hetu_tpu_torch.lr_scheduler\n"
        "import hetu_tpu_torch.examples.gcn_main\n"
        "import hetu_tpu_torch.examples.sampled_sage\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'hetu_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cnn_executor():
    """The CNN slice's executor: a models.cnn graph fed by dataloader
    ops over ht.data's digits (data and metrics are host numpy)."""
    (tx, ty), _, _ = ht.data.digits()
    x = ht.dataloader_op([ht.Dataloader(tx, 16, "train")])
    y_ = ht.dataloader_op([ht.Dataloader(ty, 16, "train")])
    loss, _ = ht.models.digits_cnn(x, y_)
    return ht.Executor({"train": [loss]})


@pytest.mark.parametrize("entry", ["resolve_device", "params", "cache",
                                   "engine", "kv_cache", "session",
                                   "decoder", "cnn_executor", "cnn_main",
                                   "ctr_main", "rec_main",
                                   "transformer_main", "csr_value",
                                   "gcn_main", "sampled_sage"])
def test_default_device_is_cuda_and_raises_without_it(monkeypatch, tmp_path,
                                                      entry):
    monkeypatch.setenv("HETU_DATA_DIR", str(tmp_path))
    _cuda_absent(monkeypatch)
    cfg = GPTConfig(**CFG)
    ckpt = random_gpt_checkpoint(cfg, seed=0)
    calls = {
        "resolve_device": lambda: resolve_device(),
        "params": lambda: gpt_serving_params(cfg, ckpt.__getitem__),
        "cache": lambda: PagedKVCache(cfg, num_blocks=4),
        "engine": lambda: ContinuousBatchingEngine(
            cfg, ckpt.__getitem__, num_blocks=4, start=False),
        "kv_cache": lambda: init_kv_cache(cfg, 1),
        "session": lambda: InferenceSession(
            [GPTLMHeadModel(cfg)(ht.Variable("ids", trainable=False))]),
        "decoder": lambda: GPTDecoder(cfg, ckpt.__getitem__),
        "cnn_executor": _cnn_executor,
        "cnn_main": lambda: cnn_main.run(cnn_main.parse_args(
            ["--model", "logreg", "--dataset", "DIGITS",
             "--num-epochs", "1"])),
        "ctr_main": lambda: ctr_main.worker(ctr_main.parse_args(
            ["--dim", "1000", "--nsamples", "1280", "--nepoch", "1"])),
        "rec_main": lambda: rec_main.worker(rec_main.parse_args(
            ["--nepoch", "1"])),
        "transformer_main": lambda: transformer_main.main(
            transformer_main.parse_args(
                ["--nepoch", "1", "--num-blocks", "1", "--d-model", "16",
                 "--d-ff", "16", "--num-heads", "2", "--vocab-size", "20",
                 "--maxlen", "4", "--nsamples", "64"])),
        "csr_value": lambda: CSRValue.from_sparse_array(ht.sparse_array(
            [1.0], ([0], [1]), (2, 2))),
        "gcn_main": lambda: gcn_main.run(gcn_main.parse_args(
            ["--nodes", "50", "--num-epochs", "1"])),
        "sampled_sage": lambda: sampled_sage.main(sampled_sage.parse_args(
            ["--nodes", "100", "--num-epoch", "1"])),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("arg", [True, "some/dir", "env"])
def test_enabled_telemetry_is_refused(monkeypatch, arg):
    if arg == "env":
        monkeypatch.setenv("HETU_TELEMETRY", "some/dir")
        arg = None
    with pytest.raises(NotImplementedError):
        telemetry.resolve(arg)
    with pytest.raises(NotImplementedError):
        telemetry.Telemetry(enabled=True)


def test_disabled_telemetry_is_a_no_op(monkeypatch):
    monkeypatch.delenv("HETU_TELEMETRY", raising=False)
    tel = telemetry.resolve(None)
    assert tel is telemetry.NULL is telemetry.resolve(False)
    assert not tel.enabled
    with tel.span("x", a=1):
        tel.inc("c")
        tel.observe("h", 1.0)
        tel.set_gauge("g", 2)
        tel.instant("i")
        tel.complete("s", 0, 1, {})
        tel.flight_record("serve", "submit", tag="r")
    cfg = GPTConfig(**CFG)
    eng = ContinuousBatchingEngine(
        cfg, random_gpt_checkpoint(cfg).__getitem__, num_blocks=4,
        block_size=4, start=False, device="cpu", telemetry=False)
    assert eng.telemetry is telemetry.NULL
    fut = eng.submit(np.arange(3, dtype=np.int32), 2)
    while not fut.done():
        eng.step()
    assert fut.result().shape == (2,)
    eng.close()
