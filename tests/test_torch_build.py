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
