"""The kernel build's cache key: a library is rebuilt when its source, a
header under ``csrc`` or the flags change, and reused otherwise. Needs no
nvcc: only the target names are computed."""

import pytest

from transmvsnet_tpu_torch.ops.cuda import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "body.cuh"\nextern "C" int a() { return body(); }\n')
    (src / "b.cu").write_text('extern "C" int b() { return 2; }\n')
    (src / "body.cuh").write_text("inline int body() { return 1; }\n")
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    return src


def test_editing_a_header_changes_the_target(csrc):
    before = build._target(csrc / "a.cu")
    assert before == build._target(csrc / "a.cu")  # stable
    assert before.parent == build.BUILD_DIR and before.name.startswith("a-") and before.suffix == ".so"
    (csrc / "body.cuh").write_text("inline int body() { return 3; }\n")
    assert build._target(csrc / "a.cu") != before


@pytest.mark.parametrize("edit", ["source", "new_header", "flags"])
def test_other_edits_change_the_target(csrc, monkeypatch, edit):
    before = build._target(csrc / "a.cu")
    if edit == "source":
        (csrc / "a.cu").write_text('#include "body.cuh"\nextern "C" int a() { return 1 + body(); }\n')
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("inline int other() { return 4; }\n")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", [*build.NVCC_FLAGS, "-lineinfo"])
    assert build._target(csrc / "a.cu") != before


def test_link_flags_change_only_their_own_target(csrc, monkeypatch, tmp_path):
    """A source's libraries (``LINK_FLAGS``, e.g. -lnvjpeg for the image
    codec) enter its own command and hash; every other source keeps its
    target, so adding a library rebuilds no kernel."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "LINK_FLAGS", {})
    a_before, b_before = build._target(csrc / "a.cu"), build._target(csrc / "b.cu")
    assert build._link_flags(csrc / "a.cu") == []
    monkeypatch.setattr(build, "LINK_FLAGS", {"a": ["-lnvjpeg"]})
    assert build._target(csrc / "b.cu") == b_before
    assert build._target(csrc / "a.cu") != a_before
    lib_dir = nvcc.resolve().parents[1] / "lib64"
    assert build._link_flags(csrc / "a.cu") == [f"-L{lib_dir}", "-Xlinker", f"-rpath,{lib_dir}", "-lnvjpeg"]
