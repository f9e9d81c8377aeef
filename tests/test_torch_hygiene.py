"""hetu_tpu_torch stands alone: it imports with JAX and hetu_tpu
blocked — its parameter-server modules too, and its server process
starts so —, its entry points default to CUDA and raise without it, the
telemetry facade resolves as the reference's (disabled by default,
enabled by a path, True or ``HETU_TELEMETRY``), and its copy of the
parameter server's C++ sources stays byte-identical to hetu_tpu's."""
import importlib
import os
import socket
import subprocess
import sys
import time
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
        "import hetu_tpu_torch.analysis.efficiency\n"
        "import hetu_tpu_torch.analysis.perfcheck\n"
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
                                   "gcn_main", "sampled_sage",
                                   "ps_executor"])
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
        "ps_executor": lambda: ht.Executor(
            [ht.reduce_sum_op(ht.embedding_lookup_op(
                ht.Variable("t", value=np.zeros((4, 2), np.float32)),
                ht.Variable("i", trainable=False)), [0])],
            comm_mode="PS"),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert resolve_device("cpu") == torch.device("cpu")


BLOCK = ("import sys\n"
         "for name in ('jax', 'jaxlib', 'hetu_tpu'):\n"
         "    sys.modules[name] = None      # any import of them fails\n")


def test_ps_modules_import_without_jax_or_hetu_tpu():
    code = BLOCK + (
        "import hetu_tpu_torch.ps, hetu_tpu_torch.ps.client\n"
        "import hetu_tpu_torch.ps.server, hetu_tpu_torch.ps.run_server\n"
        "import hetu_tpu_torch.ps.native_lib, hetu_tpu_torch.ps.runtime\n"
        "import hetu_tpu_torch.ps.device_cache, hetu_tpu_torch.cstable\n"
        "import hetu_tpu_torch.ingest, hetu_tpu_torch.ops.comm\n"
        "import hetu_tpu_torch.serving.embedding\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'hetu_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_ps_server_process_starts_without_jax_or_hetu_tpu():
    """``python -m hetu_tpu_torch.ps.run_server PORT 1``, run with JAX
    and hetu_tpu blocked, serves its port."""
    from hetu_tpu_torch.ps import native_lib, server
    native_lib.build_lib()
    port = server.pick_free_port()
    code = BLOCK + (
        "import runpy\n"
        f"sys.argv = ['run_server', '{port}', '1']\n"
        "runpy.run_module('hetu_tpu_torch.ps.run_server',\n"
        "                 run_name='__main__')\n")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": str(ROOT)},
                            stdin=subprocess.DEVNULL,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and proc.poll() is None:
            try:
                socket.create_connection(("127.0.0.1", port), 0.2).close()
                break
            except OSError:
                time.sleep(0.1)
        assert proc.poll() is None, proc.communicate()[1]
        socket.create_connection(("127.0.0.1", port), 1).close()
    finally:
        proc.kill()
        proc.communicate()


def test_ps_native_sources_are_hetu_tpus():
    """The port builds the server library from its own copy of the C++
    sources (its Makefile is its own): a drift from hetu_tpu's shows
    here."""
    mine = ROOT / "hetu_tpu_torch" / "ps" / "native"
    ref = ROOT / "hetu_tpu" / "ps" / "native"
    names = sorted(p.name for p in mine.iterdir()
                   if p.suffix in (".cc", ".h"))
    assert names == sorted(p.name for p in ref.iterdir()
                           if p.suffix in (".cc", ".h"))
    for name in names:
        assert (mine / name).read_bytes() == (ref / name).read_bytes(), name


@pytest.mark.parametrize("arg", [True, "dir", "env"])
def test_enabled_telemetry_resolves(monkeypatch, tmp_path, arg):
    """True, a directory and ``HETU_TELEMETRY`` (with None) each resolve
    to an enabled instance that becomes the process default, and a
    second request for the same directory reuses it (the reference's
    rule: two instances would overwrite each other's rank files)."""
    monkeypatch.setattr(telemetry, "_default", None)
    out = str(tmp_path / "tel")
    monkeypatch.setenv("HETU_TELEMETRY", out)
    if arg == "dir":
        monkeypatch.delenv("HETU_TELEMETRY")
        arg = out
    elif arg == "env":
        arg = None
    tel = telemetry.resolve(arg)
    assert tel.enabled and tel.out_dir == out
    assert telemetry.get_telemetry() is tel
    assert telemetry.resolve(out) is tel
    with tel.span("x", a=1):
        tel.inc("c", 3)
    paths = tel.flush()
    assert tel.counter_value("c") == 3 and len(paths) >= 2
    assert all(os.path.exists(p) for p in paths)


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


# names the reference's top level exports from a module the port has,
# which wait for a later ROADMAP item
WAITING = {}


def _reference_exports():
    """(module, name) of every ``from .module import name`` and ``from .
    import module`` in hetu_tpu/__init__.py, read with ast: nothing of
    JAX is imported."""
    import ast
    tree = ast.parse((ROOT / "hetu_tpu" / "__init__.py").read_text())
    out = []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            for alias in node.names:
                if alias.name == "*":
                    continue
                module = node.module or alias.name
                out.append((module, alias.asname or alias.name))
    return out


def _port_has(module):
    path = ROOT / "hetu_tpu_torch" / module.replace(".", "/")
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


def test_reference_top_level_names_of_ported_modules_are_exported():
    exports = _reference_exports()
    assert ("ndarray", "rcpu") in exports and ("launcher", "launcher") \
        in exports
    ported = [(m, n) for m, n in exports if _port_has(m)]
    missing = [f"{m}.{n}" for m, n in ported
               if n not in WAITING and not hasattr(ht, n)]
    assert not missing, missing
    # every waiting name is still one the reference exports
    assert set(WAITING) <= {n for _, n in ported}
    # the ported analysis modules export the reference's __all__
    for module in PORTED_ALL:
        want = _reference_all(module)
        assert want, module
        port = importlib.import_module(f"hetu_tpu_torch.{module}")
        left_out = LEFT_OUT.get(module, {})
        missing = [n for n in want if n not in left_out
                   and (n not in port.__all__ or not hasattr(port, n))]
        assert not missing, (module, missing)
        # a name left out is one the reference exports and the port lacks
        assert set(left_out) <= set(want), module
        assert not [n for n in left_out if hasattr(port, n)], module


# ported modules whose whole ``__all__`` the reference's names must be in
PORTED_ALL = ("analysis.numerics", "analysis.rangecheck",
              "analysis.efficiency", "analysis.perfcheck")

# reference names a ported module leaves out, and why
LEFT_OUT = {"analysis.efficiency": {
    "advise_recompiles": "the reference's executor calls it from "
                         "SubExecutor._note_compile; the port's eager walk "
                         "compiles nothing, so it has no caller (ROADMAP §3)"}}


def _reference_all(module):
    """The ``__all__`` list of a reference module, read with ast."""
    import ast
    path = (ROOT / "hetu_tpu" / module.replace(".", "/")).with_suffix(".py")
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def test_sequence_parallel_op_builders_are_exported():
    """The reference exports ``ring_attention_op`` and
    ``ulysses_attention_op`` through ``from .ops import *``, which the
    check above does not read."""
    for name in ("ring_attention_op", "ulysses_attention_op"):
        assert name in ht.__all__ and name in ht.ops.__all__
        assert getattr(ht, name) is getattr(ht.ops, name)


def _imports(path):
    import ast
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_launcher_imports_neither_jax_nor_hetu_tpu():
    names = _imports(ROOT / "hetu_tpu_torch" / "launcher.py")
    assert not names & {"jax", "jaxlib", "hetu_tpu"}, names
    code = BLOCK + (
        "import hetu_tpu_torch.launcher as launcher\n"
        "launcher.main(['--help'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ROADMAP" in out.stdout, out.stderr


def test_ps_server_maps_no_torch():
    """A server of the port runs ``ps/run_server.py`` by path: its
    process loads the server library, numpy and the standard library,
    and neither the package's ``__init__`` nor torch."""
    from hetu_tpu_torch.ps import server
    from torch_ps_util import start_server
    try:
        _, proc = start_server()
        maps = open(f"/proc/{proc.pid}/maps").read()
        assert "libhetu_ps_" in maps
        assert "libtorch" not in maps and "libc10" not in maps
    finally:
        server.shutdown_server()


def test_parallel_modules_import_without_jax_or_hetu_tpu():
    code = BLOCK + (
        "import hetu_tpu_torch.parallel, hetu_tpu_torch.parallel.pipeline\n"
        "import hetu_tpu_torch.parallel.p2p, hetu_tpu_torch.ops.comm\n"
        "import hetu_tpu_torch.parallel.mesh\n"
        "import hetu_tpu_torch.parallel.data_parallel\n"
        "import hetu_tpu_torch.parallel.planner\n"
        "import hetu_tpu_torch.parallel.tensor_parallel\n"
        "import hetu_tpu_torch.parallel.autoplan\n"
        "import hetu_tpu_torch.parallel.distgcn\n"
        "import hetu_tpu_torch.parallel.local_ranks\n"
        "import hetu_tpu_torch.examples.train_hetu_bert\n"
        "import hetu_tpu_torch.examples.runner.run_mlp\n"
        "import hetu_tpu_torch.examples.runner.run_wdl\n"
        "from hetu_tpu_torch import pipeline_send_op, datah2d_op\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'hetu_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ("pipeline.py", "p2p.py", "mesh.py", "data_parallel.py",
                 "planner.py", "tensor_parallel.py", "autoplan.py",
                 "distgcn.py", "local_ranks.py", "__init__.py"):
        names = _imports(ROOT / "hetu_tpu_torch" / "parallel" / name)
        assert not names & {"jax", "jaxlib", "hetu_tpu"}, (name, names)


def test_launcher_by_path_imports_no_torch():
    """``python hetu_tpu_torch/run_launcher.py`` is the launcher's main
    without the package's ``__init__``: the launcher process loads
    neither torch nor JAX."""
    code = BLOCK + (
        "import runpy\n"
        "sys.argv = ['run_launcher.py', '--help']\n"
        "try:\n"
        "    runpy.run_path('hetu_tpu_torch/run_launcher.py',\n"
        "                   run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "assert 'torch' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--config" in out.stdout, out.stderr
