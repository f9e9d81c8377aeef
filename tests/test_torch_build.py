"""hetu_tpu_torch.ops._build on the CPU: the library path of a kernel
source carries a hash of the source and of every header beside it, so
an edited header never loads a stale build. No nvcc is needed: only the
path is computed."""
from hetu_tpu_torch.ops import _build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (csrc / "b.cu").write_text("int b;\n")
    (csrc / "shared.cuh").write_text("// helpers v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    src, before = _build._lib_path("a")
    assert src == csrc / "a.cu"
    assert before.parent == tmp_path / "build"
    assert before.name.startswith("liba_") and before.suffix == ".so"
    assert _build._lib_path("a") == (src, before)   # deterministic
    (csrc / "shared.cuh").write_text("// helpers v2\n")
    assert _build._lib_path("a")[1] != before
    (csrc / "extra.cuh").write_text("// a new header\n")
    after_new = _build._lib_path("a")[1]
    assert after_new not in (before, _build._lib_path("b")[1])


def test_editing_a_source_changes_only_its_library_path(tmp_path,
                                                        monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    a, b = _build._lib_path("a")[1], _build._lib_path("b")[1]
    (csrc / "b.cu").write_text("int b2;\n")
    assert _build._lib_path("a")[1] == a
    assert _build._lib_path("b")[1] != b
