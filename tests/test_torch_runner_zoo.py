"""The port's parallel-config zoo (``hetu_tpu_torch/examples/runner/
parallel/``) through the port's launcher on the CPU: tests/
test_runner_zoo.py's fast subset, each config one worker process whose
devices run as thread ranks, held to the port's own base run at the
zoo's gate (``validate_results.py``: rtol 1e-4, atol 1e-6); the base run
to the JAX package's ``test_mlp_base.py`` graph within 1e-5."""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ZOO = os.path.join(ROOT, "hetu_tpu_torch", "examples", "runner", "parallel")


def _env():
    from launcher_util import clean_launcher_env
    return clean_launcher_env(PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")


def _run(config, script, *extra):
    cmd = [sys.executable, "-m", "hetu_tpu_torch.launcher", "-c",
           os.path.join(ZOO, config), sys.executable,
           os.path.join(ZOO, script), "--steps", "5"] + list(extra)
    res = subprocess.run(cmd, cwd=ZOO, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def _gate(res_dir):
    """The zoo's gate over ``res_dir``'s base.npy and res0.npy."""
    out = subprocess.run(
        [sys.executable, os.path.join(ZOO, "validate_results.py"), "1",
         "--dir", str(res_dir)], capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("zoo")
    _run("config1.yml", "test_mlp_base.py", "--save", "--log",
         str(d / "base.npy"))
    return d


def _zoo_common():
    """The port's zoo ``common`` module, loaded by path (the JAX
    package's zoo has a module of that name too)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_zoo_common", os.path.join(ZOO, "common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_base_run_is_the_jax_packages(base_dir):
    """The port's zoo starts from the JAX package's weights and batches:
    its base losses are those of the JAX package's test_mlp_base.py
    graph (built here, in this process, on the same draws) within
    1e-5."""
    import hetu_tpu as jht
    common = _zoo_common()
    (tx, ty), _, _ = jht.data.mnist()
    rng = np.random.RandomState(7)
    idx = rng.permutation(len(tx))[:64 * 5]
    xs, ys = tx[idx].reshape(5, 64, -1), ty[idx].reshape(5, 64, -1)
    np.testing.assert_array_equal(xs, common.batches()[0])

    def fc(x, name, relu):
        w = jht.Variable(name + "_weight",
                         value=common.load_std(name + "_weight"))
        b = jht.Variable(name + "_bias", value=common.load_std(name + "_bias"))
        x = jht.matmul_op(x, w)
        x = x + jht.broadcastto_op(b, x)
        return jht.relu_op(x) if relu else x

    x = jht.Variable("dataloader_x", trainable=False)
    act = fc(x, "mlp_fc1", True)
    w = jht.Variable("special_weight", value=common.load_std("special_weight"))
    act = jht.relu_op(jht.matmul_op(act, w))
    y_ = jht.Variable("dataloader_y", trainable=False)
    loss = jht.reduce_mean_op(jht.softmaxcrossentropy_op(
        fc(act, "mlp_fc2", False), y_), [0])
    exe = jht.Executor([loss, jht.optim.SGDOptimizer(0.01).minimize(loss)])
    want = [float(np.asarray(exe.run(feed_dict={x: xs[i], y_: ys[i]})[0]
                             .asnumpy())) for i in range(5)]
    np.testing.assert_allclose(np.load(base_dir / "base.npy"), want,
                               rtol=1e-5)


@pytest.mark.parametrize("case", [
    ("test_mlp_mp.py", ["--split", "middle"]),
    ("test_mlp_mp.py", ["--split", "2"]),
    ("test_mlp_pp.py", []),
    ("test_mlp_mp_pp.py", ["--split", "left"]),
], ids=["mp_middle", "mp_2", "pp", "mp_pp_left"])
def test_zoo_config_matches_base(base_dir, tmp_path, case):
    script, extra = case
    (tmp_path / "base.npy").write_bytes((base_dir / "base.npy").read_bytes())
    res = tmp_path / "res0.npy"
    _run("config4.yml", script, *extra, "--log", str(res))
    _gate(tmp_path)
    np.testing.assert_allclose(np.load(base_dir / "base.npy"),
                               np.load(res), rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def cnn_base_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cnnzoo")
    _run("config1.yml", "test_cnn_base.py", "--save", "--log",
         str(d / "base.npy"))
    return d


@pytest.mark.parametrize("split", ["left", "middle", "right"])
def test_cnn_zoo_split_matches_base(cnn_base_dir, tmp_path, split):
    (tmp_path / "base.npy").write_bytes(
        (cnn_base_dir / "base.npy").read_bytes())
    res = tmp_path / "res0.npy"
    _run("config2.yml", "test_cnn_mp.py", "--split", split, "--log",
         str(res))
    _gate(tmp_path)
    np.testing.assert_allclose(np.load(cnn_base_dir / "base.npy"),
                               np.load(res), rtol=1e-4, atol=1e-6)
