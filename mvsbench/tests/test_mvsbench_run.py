"""A run end to end on the CPU at a tiny size, past the harness's look for
a card: sound, it comes out correct; with the timed path broken
underneath, once for each fault the cell can have, it comes out not
correct. And the run command itself refuses a machine without a card,
and a directory that holds only the benchmark."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from mvsbench import faults, harness
from mvsbench.tests.tiny import tiny_cell

REPO = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 77


def run(workload, **kw):
    return harness.run(workload, SEED, 2.0, False, "cpu", cell=tiny_cell(workload, 2.0), **kw)


@pytest.mark.parametrize("workload", ["dtu_infer", "dtu_train", "tnt_infer"])
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {"setup_s"} < set(out["metrics"])


@pytest.mark.parametrize("workload, fault", [("dtu_infer", "altered"), ("tnt_infer", "altered"),
                                             ("dtu_train", "unchanged"), ("dtu_train", "half_batch"),
                                             ("dtu_train", "half_loss")])
def test_fault_is_caught(workload, fault):
    out = run(workload, fault=fault)
    assert not out["correct"], out["checks"]
    number = {"altered": "served_flip_share", "half_loss": "step1_loss_gap"}.get(fault)
    if number:
        assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_judged_answers_past_the_window_are_waited_for():
    """A window too short to reach the judged requests: they run after its
    close, late but not wrong, and the run comes out correct."""
    out = harness.run("dtu_infer", SEED, 0.01, False, "cpu", cell=tiny_cell("dtu_infer", 0.01))
    assert out["attempted"] < 3
    assert out["correct"], out["checks"]


def test_window_step_fault_is_caught():
    """A fault that starts after the three judged steps (each later step
    moves the parameters twice as far) is seen by the watched window
    step alone."""
    from transmvsnet_tpu_torch.train import step

    make = step.make_train_step

    def late(*a, **k):
        train_step = make(*a, **k)

        def doubled(state, batch, mark=None):
            before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
            state, scalars = train_step(state, batch, mark)
            if state.step > 3:
                with torch.no_grad():
                    for n, p in state.model.named_parameters():
                        p.add_(p - before[n])
            return state, scalars
        return doubled

    with faults._patched(step, "make_train_step", late):
        out = run("dtu_train")
    checks = out["checks"]
    assert checks["window_update_gap"]["value"] > checks["window_update_gap"]["limit"], checks
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in ("step1_loss_gap", "loss_gap", "grad_gap",
                                                                  "update_gap"))
    assert not out["correct"]


def test_stage_wta_fault_is_caught():
    """A winner-take-all one plane off at stages 1 and 2 only, which the
    reference follows, is seen by wta_flip_share alone."""
    from transmvsnet_tpu_torch.models import transmvsnet

    wta = transmvsnet.depth_wta

    def shifted(prob_volume, depth_values):
        if prob_volume.shape[1] == 8:
            return wta(prob_volume, depth_values)
        idx = (torch.argmax(prob_volume, 1, keepdim=True) + 1).clamp(max=prob_volume.shape[1] - 1)
        return torch.gather(depth_values.expand_as(prob_volume), 1, idx)[:, 0]

    with faults._patched(transmvsnet, "depth_wta", shifted):
        out = run("dtu_infer")
    checks = out["checks"]
    assert checks["wta_flip_share"]["value"] > 0.5, checks
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in ("prob_gap", "served_flip_share"))
    assert not out["correct"]


def test_precision_departure_is_caught():
    """The program turning on TF32 matmuls, which the configuration keeps
    off, comes out not correct."""
    from transmvsnet_tpu_torch.models import transmvsnet

    blended = transmvsnet.blended_confidence

    def switching(outputs):
        torch.backends.cuda.matmul.allow_tf32 = True
        return blended(outputs)

    try:
        with faults._patched(transmvsnet, "blended_confidence", switching):
            out = run("dtu_infer")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert out["checks"]["precision_departures"]["value"] == 1
    assert not out["correct"]


@pytest.mark.parametrize("workload", ["dtu_infer", "dtu_train", "tnt_infer"])
def test_lower_precision_control_fails(workload):
    """The control: the same cell with bf16 activations (the program's own
    path), which must come out not correct."""
    out = run(workload, program_dtype="bfloat16")
    assert not out["correct"], out["checks"]


def test_command_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run([sys.executable, "-m", "mvsbench.run", "--workload", "dtu_infer", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "CUDA" in proc.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    """In a directory with only BENCHMARK.json and mvsbench/, the program
    is missing and the run fails before printing a result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "mvsbench", tmp_path / "mvsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import json; from mvsbench import harness; from mvsbench.tests.tiny import tiny_cell; "
            "print(json.dumps(harness.run('dtu_infer', 1, 0.2, False, 'cpu', cell=tiny_cell('dtu_infer'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode != 0
    assert "transmvsnet_tpu_torch" in proc.stderr
    assert not proc.stdout.strip()


def test_result_line_is_json():
    out = run("dtu_infer")
    line = json.loads(json.dumps(out))
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
