"""Nothing under mvsbench/ imports JAX, Flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port."""

import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "transmvsnet_tpu"}


def imported(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def test_walk_covers_the_harness():
    names = {p.relative_to(HERE).as_posix() for p in FILES}
    assert {"run.py", "harness.py", "reference/model.py", "drivers/infer.py",
            "metrics/dcn_roofline_pct.infer.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax(path):
    bad = [m for m in imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_stands_alone(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert tops <= {"__future__", "bisect", "contextlib", "math", "torch"}, tops


def test_the_port_name_is_caught_whole():
    assert "transmvsnet_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "transmvsnet_tpu.models".split(".")[0] in FORBIDDEN
