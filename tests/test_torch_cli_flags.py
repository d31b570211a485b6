"""The port's CLIs take every JAX command line: for ``infer``, ``train``,
``fuse``, ``eval_dtu`` and ``profile``, every option of the JAX parser is
in the port's, with the JAX default, choices, type, action and
``required``, but for the exclusions and differences written in the
tables below, each with its reason. The parsers are captured by patching
``argparse.ArgumentParser.parse_args`` and calling each module's
``parse_args([])``.
"""

import argparse
import importlib
from unittest import mock

import pytest

from transmvsnet_tpu.data.registry import get_dataset

TOOLS = ("infer", "train", "fuse", "eval_dtu", "profile")

# JAX options the port does not take (ROADMAP Queue 1 "Left out"): in the
# port the tensor's device picks the route, so there is no Pallas switch
# and no JAX platform to select.
EXCLUDED = {
    ("infer", "--no_pallas"): "the route follows the tensor's device",
    ("train", "--no_pallas"): "the route follows the tensor's device",
    ("train", "--platform"): "a JAX backend name; the port takes --device",
}

# Shared options whose default differs, each deliberately (the port's
# tools/profile.py docstring): PERF.md's recorded profiles name command
# lines whose shapes follow these defaults.
DEFAULTS = {
    ("profile", "--logdir"): ("./traces", ""),  # a training trace is ~68 MB: written only when asked
    ("profile", "--height"): (512, 0),  # 0: 512 with --train, 864 (the DTU eval setting) without
    ("profile", "--width"): (640, 0),  # 0: 640 with --train, 1152 without
    ("profile", "--batch_size"): (1, 0),  # 0: 2 (the DTU recipe) with --train, 1 without
    ("profile", "--warmup"): (3, 2),
    ("profile", "--iters"): (5, 3),
}

# Shared options to which the port gives choices where the JAX parser takes
# any string: the dataset names with which each JAX CLI runs. The JAX
# inference CLI fails on a training dataset (no "filename" to write the
# outputs under) and the JAX trainer on an evaluation one (no ``mode``
# argument); a name outside the registry fails both.
NARROWED = {
    ("infer", "--dataset"): {"general_eval", "dtu_eval", "tnt", "tnt_eval", "synthetic"},
    ("train", "--dataset"): {"dtu", "dtu_yao", "blended", "bld_train", "synthetic"},
}


def parser_of(module: str) -> argparse.ArgumentParser:
    captured = []

    def capture(self, args=None, namespace=None):
        captured.append(self)
        return argparse.Namespace()

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        importlib.import_module(module).parse_args([])
    (parser,) = captured
    return parser


def options(tool: str, package: str) -> dict:
    parser = parser_of(f"{package}.tools.{tool}")
    return {s: a for a in parser._actions for s in a.option_strings if s not in ("-h", "--help")}


@pytest.fixture(scope="module")
def parsers():
    return {tool: (options(tool, "transmvsnet_tpu"), options(tool, "transmvsnet_tpu_torch")) for tool in TOOLS}


@pytest.mark.parametrize("tool", TOOLS)
def test_every_jax_option_is_in_the_port(parsers, tool):
    theirs, ours = parsers[tool]
    missing = {s for s in theirs if s not in ours}
    assert missing == {s for t, s in EXCLUDED if t == tool}


@pytest.mark.parametrize("tool", TOOLS)
def test_shared_options_keep_the_jax_defaults_and_choices(parsers, tool):
    theirs, ours = parsers[tool]
    defaults, narrowed = {}, {}
    for s, a in theirs.items():
        if s not in ours:
            continue
        b = ours[s]
        assert (type(b), b.dest, b.type, b.nargs, b.required, b.const) == (
            type(a), a.dest, a.type, a.nargs, a.required, a.const), s
        if b.default != a.default:
            defaults[s] = (a.default, b.default)
        if b.choices != a.choices:
            narrowed[s] = set(b.choices)
    assert defaults == {s: d for (t, s), d in DEFAULTS.items() if t == tool}
    assert narrowed == {s: c for (t, s), c in NARROWED.items() if t == tool}


@pytest.mark.parametrize("tool, option", sorted(NARROWED))
def test_narrowed_choices_are_jax_names(parsers, tool, option):
    """Every name the port takes is one the JAX registry resolves, and its
    default is among them."""
    theirs, ours = parsers[tool]
    for name in ours[option].choices:
        get_dataset(name)
    assert theirs[option].default in ours[option].choices
