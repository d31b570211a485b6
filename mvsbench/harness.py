"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

Everything is found by name: the cell in ``BENCHMARK.json``, its
configuration at ``configs/<config>.json``, its traffic at
``traffic/<traffic>.json`` (whose ``kind`` picks ``drivers/<kind>.py``),
the limits of its check at ``limits/<workload>.json`` and each metric's
reader at ``metrics/<metric>.py``. A reader's ``read(rec)`` returns the
metric's value, or None where it finds nothing to read; its ``SPANS``
name the program's modules whose calls it times.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
import sys
import time
from types import SimpleNamespace

import torch

from mvsbench import faults, trace

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "transmvsnet_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict
    seconds: float
    chips: int = 1


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, seconds: float, bench: dict | None = None) -> Cell:
    bench = bench or _load_json(REPO / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    return Cell(
        name=workload,
        config=_load_json(HERE / "configs" / f"{entry['config']}.json"),
        traffic=_load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        limits=_load_json(HERE / "limits" / f"{workload}.json"),
        seconds=seconds,
        chips=entry["chips"],
    )


def reader(name: str):
    """The module ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"mvsbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_for(cell: Cell, seed: int, device, program_dtype: str | None = None):
    module = importlib.import_module(f"mvsbench.drivers.{cell.traffic['kind']}")
    return module.Driver(cell, seed, device, program_dtype)


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX, Flax or the JAX package (top-level names
    compared whole)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class Marks:
    """The train step's ``mark(phase)``: a CUDA event at each phase's end;
    ``totals_ms`` gives the card's time from each "forward" mark to the
    "backward" mark after it, summed."""

    def __init__(self):
        self.events: list[tuple[str, torch.cuda.Event]] = []

    def __call__(self, phase: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((phase, e))

    def totals_ms(self) -> dict[str, float]:
        out = {"backward": 0.0}
        for (a, ea), (b, eb) in zip(self.events, self.events[1:]):
            if a == "forward" and b == "backward":
                out["backward"] += ea.elapsed_time(eb)
        return out


def apply_precision(precision: dict) -> None:
    """The configuration's arithmetic: whether cuDNN and matmuls may use
    TF32. A setting already in force is not assigned again: assigning
    PyTorch's flag pins its ``fp32_precision`` ("ieee" for matmuls), a
    state the program's own command lines never run in (PERF.md)."""
    if torch.backends.cudnn.allow_tf32 != precision["cudnn_tf32"]:
        torch.backends.cudnn.allow_tf32 = precision["cudnn_tf32"]
    if torch.backends.cuda.matmul.allow_tf32 != precision["matmul_tf32"]:
        torch.backends.cuda.matmul.allow_tf32 = precision["matmul_tf32"]


def precision_departures(precision: dict) -> int:
    """How many of the configuration's TF32 settings no longer hold."""
    return (int(torch.backends.cudnn.allow_tf32 != precision["cudnn_tf32"])
            + int(torch.backends.cuda.matmul.allow_tf32 != precision["matmul_tf32"]))


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure(cell: Cell, seed: int, seconds: float, traced: bool, dev: torch.device, started: float,
             program_dtype: str | None, readers: dict):
    """Set-up, the window and, if ``traced``, the profiled slices: the
    driver, what the readers read, the result's ``device`` and the
    ``breakdown``."""
    drv = driver_for(cell, seed, dev, program_dtype)
    drv.setup()
    synchronize(dev)
    setup_s = time.perf_counter() - started - drv.reference_s
    print(f"set-up {setup_s:.1f} s (the reference's {drv.reference_s:.1f} s left out), of it "
          + ", ".join(f"{k} {v:.1f} s" for k, v in drv.phases.items()), file=sys.stderr)

    spans = marks = None
    if traced:
        patterns = {}
        for r in readers.values():
            patterns.update(getattr(r, "SPANS", {}))
        spans = trace.Spans(drv.model, patterns)
        marks = Marks()
        drv.marks = marks
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    facts = drv.window(seconds)
    synchronize(dev)
    if facts["latencies_s"]:
        lat = sorted(facts["latencies_s"])
        print(f"window {facts['window_s']:.2f} s, {facts['count']} calls, host s per call: min {lat[0]:.4f} "
              f"median {lat[len(lat) // 2]:.4f} p90 {lat[int(0.9 * (len(lat) - 1))]:.4f} max {lat[-1]:.4f}",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = SimpleNamespace(
        workload=cell.name, kind=cell.traffic["kind"], config=cell.config, traffic=cell.traffic,
        B=drv.B, V=drv.V, H=drv.H, W=drv.W, in_bounds=drv.in_bounds, setup_s=setup_s,
        peak_bytes=peak, profile=None, spans_ms={}, marks_ms={}, **facts)
    result_device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                     "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                     "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if traced:
        rec.spans_ms, rec.marks_ms = spans.totals_ms(), marks.totals_ms()
        drv.marks = None
        spans.reset()
        from torch.profiler import ProfilerActivity, profile

        least, seconds_traced = cell.traffic["profile_least"], cell.traffic["profile_seconds"]
        # The device alone first: busy time and the longest device ops,
        # with no host op recorded to slow the host down.
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            synchronize(dev)
            t0 = time.perf_counter()
            sliced = drv.profiled(seconds_traced, least)
            synchronize(dev)
            slice_s = time.perf_counter() - t0
        device_only = trace.summarise(prof)
        # Then host and device: kernels by span, idle gaps by host op.
        spans.annotate = True
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            synchronize(dev)
            both = drv.profiled(0.0, least)
            synchronize(dev)
        spans.remove()
        summary = trace.summarise(prof)
        del prof
        rec.profile = {"window_s": slice_s, "busy_s": device_only["busy_us"] / 1e6, **sliced,
                       "spans": summary["spans"], "spans_count": both["count"]}
        result_device.update(busy_s=rec.profile["busy_s"], window_s=slice_s)
        breakdown = {"device_ops": device_only["device_ops"], "idle_gaps": summary["idle_gaps"]}
    return drv, rec, result_device, breakdown


def run(workload: str, seed: int, seconds: float, traced: bool, device="cuda", started: float | None = None,
        program_dtype: str | None = None, cell: Cell | None = None, fault: str | None = None,
        explain: dict | None = None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).
    ``program_dtype`` runs the program in another activation dtype (the
    control), ``fault`` with a fault of ``faults.py`` planted under the
    timed path; ``explain``, if given, gets the check's numbers that are
    not compared."""
    started = time.perf_counter() if started is None else started
    cell = cell or load_cell(workload, seconds)
    dev = torch.device(device)
    entries = cell.per_layer if traced else cell.end_to_end
    readers = {m["name"]: reader(m["name"]) for m in entries}
    apply_precision(cell.config["precision"])
    with faults.planted(fault):
        drv, rec, result_device, breakdown = _measure(cell, seed, seconds, traced, dev, started, program_dtype,
                                                      readers)
        drv.release()
    departures = precision_departures(cell.config["precision"])
    t0 = time.perf_counter()
    checks = drv.check(cell.limits, explain)
    checks["precision_departures"] = departures
    print(f"check against the plain reference: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    unknown = sorted(set(cell.limits) - set(checks))
    if unknown:
        raise KeyError(f"limits/{workload}.json limits numbers the check does not read: {unknown}")
    correct = all(checks[k] <= cell.limits[k] for k in cell.limits)
    metrics = {}
    for m in entries:
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(rec.count), "failed": int(rec.failed),
           "metrics": metrics, "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in checks.items()}
    return out
