"""The port's autotune engine (``hetu_tpu_torch/tune``) against the JAX
package's (twins of tests/test_autotune.py's engine tests): each scenario
runs through both engines, over cache files of their own, with the same
candidates and timings, and both must pick the same configs, sweep the
same number of times and persist the same entries. Sweeps are counted by
the ``measure`` calls (with telemetry off, no span records them).
"""
import json
import threading
import time

import pytest

from hetu_tpu import tune as jtune
from hetu_tpu_torch import tune as ttune

PACKAGES = {"jax": jtune, "port": ttune}


@pytest.fixture
def tuners(tmp_path, monkeypatch):
    """An isolated table per package; restores the globals afterwards."""
    monkeypatch.delenv("HETU_AUTOTUNE", raising=False)
    out = {}
    for name, tune in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = (tune, tune.configure(path=str(d / "autotune.json")),
                     d / "autotune.json")
    yield out
    for tune in PACKAGES.values():
        tune.reset()


def _both(tuners, scenario):
    """``scenario(tune, path)`` for each package -> {package: result}."""
    return {name: scenario(tune, path)
            for name, (tune, _table, path) in tuners.items()}


def test_sweep_picks_fastest_and_persists(tuners):
    times = {(1,): 3e-3, (2,): 1e-3, (3,): 2e-3}

    def scenario(tune, path):
        calls = []

        def measure(cfg):
            calls.append(cfg)
            return times[cfg]

        cfg = tune.autotune("demo", ("S256", "f32"), list(times), measure,
                            default=(9,))
        (ks, ent), = json.load(open(path))["entries"].items()
        return cfg, calls, ks.split("|", 1)[1], ent["config"], \
            sorted(ent["candidates_ms"])

    got = _both(tuners, scenario)
    assert got["port"] == got["jax"]
    cfg, calls, key, config, cands = got["port"]
    assert cfg == (2,) and len(calls) == 3
    assert key == "demo|S256|f32" and config == [2] and len(cands) == 3


def test_cache_roundtrip_reload_skips_sweep(tuners):
    def scenario(tune, path):
        tune.autotune("demo", ("k1",), [(1,), (2,)],
                      lambda c: 1e-3 * c[0], default=None)
        # a FRESH table over the same file (a new process in spirit)
        tune.configure(path=str(path))

        def boom(cfg):
            raise AssertionError("sweep ran despite a warm cache")

        return tune.autotune("demo", ("k1",), [(1,), (2,)], boom,
                             default=None)

    got = _both(tuners, scenario)
    assert got["port"] == got["jax"] == (1,)


def test_env_mode_off_returns_default(tuners, monkeypatch):
    monkeypatch.setenv("HETU_AUTOTUNE", "0")

    def scenario(tune, path):
        calls = []
        cfg = tune.autotune("demo", ("k2",), [(1,), (2,)],
                            lambda c: calls.append(c) or 1e-3,
                            default=(7,))
        return cfg, calls, path.exists()

    got = _both(tuners, scenario)
    assert got["port"] == got["jax"] == ((7,), [], False)


def test_env_mode_cache_only_never_sweeps(tuners, monkeypatch):
    def scenario(tune, path):
        calls = []

        def measure(c):
            calls.append(c)
            return 1e-3 * c[0]

        monkeypatch.delenv("HETU_AUTOTUNE", raising=False)
        tune.autotune("demo", ("k3",), [(1,), (2,)], measure, default=None)
        monkeypatch.setenv("HETU_AUTOTUNE", "1")
        hit = tune.autotune("demo", ("k3",), [(1,), (2,)],
                            lambda c: 1 / 0, default=(7,))
        miss = tune.autotune("demo", ("other",), [(1,), (2,)],
                             lambda c: 1 / 0, default=(7,))
        return hit, miss, len(calls)

    got = _both(tuners, scenario)
    assert got["port"] == got["jax"] == ((1,), (7,), 2)


def test_env_mode_force_resweeps(tuners, monkeypatch):
    def scenario(tune, path):
        monkeypatch.delenv("HETU_AUTOTUNE", raising=False)
        first = tune.autotune("demo", ("k4",), [(1,), (2,)],
                              lambda c: 1e-3 * c[0], default=None)
        monkeypatch.setenv("HETU_AUTOTUNE", "force")
        again = tune.autotune("demo", ("k4",), [(1,), (2,)],
                              lambda c: 1e-3 / c[0], default=None)
        return first, again

    got = _both(tuners, scenario)
    assert got["port"] == got["jax"] == ((1,), (2,))


def test_single_flight_concurrent_lookups(tuners):
    """Four threads looking one key up at once share ONE sweep (the
    port's thread ranks do this): the losers wait for the winner."""
    def scenario(tune, path):
        calls = []

        def measure(cfg):
            calls.append(cfg)
            time.sleep(0.05)
            return 1e-3 * cfg[0]

        results = []

        def worker():
            results.append(tune.autotune("demo", ("sf",), [(1,), (2,)],
                                         measure, default=(9,)))

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return results, len(calls)

    got = _both(tuners, scenario)
    assert got["port"] == got["jax"] == ([(1,)] * 4, 2)


def test_single_flight_measures_on_the_callers_thread(tuners):
    """The port measures on the caller's thread (the JAX package sweeps
    on a thread of its own, because JAX traces on the caller's)."""
    tune = PACKAGES["port"]
    seen = []
    tune.autotune("demo", ("thread",), [(1,)],
                  lambda c: seen.append(threading.get_ident()) or 1e-3)
    assert seen == [threading.get_ident()]


def test_save_merges_concurrent_process_entries(tuners, tmp_path):
    def scenario(tune, path):
        a = tune.AutotuneTable(path=str(path))
        b = tune.AutotuneTable(path=str(path))
        b._load()                           # b snapshots before a's write
        a.put("kern_a", ("k",), (1, 2))
        b.put("kern_b", ("k",), (3, 4))     # save() must merge
        merged = tune.AutotuneTable(path=str(path))
        return merged.get("kern_a", ("k",)), merged.get("kern_b", ("k",))

    got = _both(tuners, scenario)
    assert got["port"] == got["jax"] == ((1, 2), (3, 4))


def test_failing_candidates_skipped(tuners):
    def scenario(tune, path):
        table = tune.get_table()

        def measure(cfg):
            if cfg == (1,):
                raise RuntimeError("does not fit")
            return 1e-3 * cfg[0]

        picked = tune.autotune("demo", ("k5",), [(1,), (2,), (3,)],
                               measure, default=None)
        none = tune.autotune("demo", ("k6",), [(1,)], lambda c: 1 / 0,
                             default=(7,))
        return picked, none, table.get("demo", ("k6",))

    got = _both(tuners, scenario)
    assert got["port"] == got["jax"] == ((2,), (7,), None)


def test_cache_file_env_dir_and_corrupt_file(tmp_path, monkeypatch):
    for name, tune in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        monkeypatch.setenv("HETU_AUTOTUNE_CACHE", str(d))
        assert tune.default_cache_path() == str(d / "autotune.json")
        p = d / "autotune.json"
        p.write_text("{not json")
        t = tune.AutotuneTable(path=str(p))
        assert t.get("x", ("y",)) is None
        t.put("x", ("y",), (1, 2))
        assert tune.AutotuneTable(path=str(p)).get("x", ("y",)) == (1, 2)


def test_platform_tag_partitions_cpu_from_the_card():
    """Keys start ``cpu`` for work on CPU tensors, as the JAX package's
    CPU backend tags them (the committed fixture's ``cpu|...`` keys read
    on the CPU), and ``cuda-<card name>`` on a card."""
    assert ttune.platform_tag("cpu") == jtune.platform_tag() == "cpu"
    with ttune.platform_scope("cpu"):
        assert ttune.platform_tag() == "cpu"
    with ttune.platform_scope(None):
        assert ttune.platform_tag() == ttune.platform_tag(None)
    import torch
    if not torch.cuda.is_available():
        assert ttune.platform_tag() == "cpu"


def test_the_planners_modules_import_without_jax():
    """The modules this slice brings over load neither JAX nor the JAX
    package."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "import hetu_tpu_torch.tune, hetu_tpu_torch.tune.autotune\n"
        "import hetu_tpu_torch.analysis, hetu_tpu_torch.analysis.zoo\n"
        "import hetu_tpu_torch.telemetry.costdb, hetu_tpu_torch.profiler\n"
        "import hetu_tpu_torch.parallel.autoplan\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'hetu_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
