"""Inference traffic: a closed loop of single requests over a seeded pool.

Each request is the per-batch body of the program's inference CLI
(``tools/infer.py::main``): the sample's numpy arrays copied to the card,
``TransMVSNet.forward`` under ``no_grad``, ``blended_confidence``, and
depth and confidence copied back with ``.cpu()``. Its latency runs from
the first copy to both maps on the host. JPEG decoding and PFM writes are
not part of it.

The answers judged are those of a few requests of the window drawn from
the seed. A judged request that the window did not reach runs after its
close (late, not wrong; outside the metrics), for up to ``LATE_S``
seconds. Their stage outputs stay on the card until the window closes;
then the plain reference recomputes each request from the same weights
and inputs, stage by stage from the program's previous-stage depth (the
hypotheses of stages 2 and 3 hang on a winner-take-all that rounding can
flip; stage 1 and every stage's hypotheses are checked as they stand).
"""

from __future__ import annotations

import importlib
import time

import torch

from mvsbench import compare, scene, weights
from mvsbench.counts import transmvsnet as work
from mvsbench.drivers import program_config
from mvsbench.reference import model as ref

STAGES = ("stage1", "stage2", "stage3")
# How long after the window a judged answer is waited for.
LATE_S = 60.0


def to_device(raw: dict, dev) -> tuple:
    return (torch.from_numpy(raw["imgs"]).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in raw["proj_matrices"].items()},
            torch.from_numpy(raw["depth_values"]).to(dev))


class Driver:
    def __init__(self, cell, seed: int, device, program_dtype: str | None = None):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.cfg, self.traffic = cell.config, cell.traffic
        shape = self.cfg["infer"]
        self.B, self.V, self.H, self.W = self.traffic["batch"], shape["views"], shape["height"], shape["width"]
        self.dtype = program_dtype or self.cfg["precision"]["activations"]
        self.kept: dict[int, dict] = {}
        self.served = 0
        self.phases: dict[str, float] = {}
        self.reference_s = 0.0

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        cfg, dev = self.cfg, self.dev
        t0 = time.perf_counter()
        layout = weights.reference_model(cfg, dev)
        state = weights.seeded_state_dict(layout, self.seed, dev, cfg["prob_gain"])
        ch, cw = cfg["infer"]["calibration_hw"]
        cal = scene.pool(self.seed, 1, 1, cfg["scene"], self.V, ch, cw, tag="calibration")[0]
        t1 = time.perf_counter()
        self.state = weights.calibrated(layout, state, to_device(cal, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # The plain reference's forward that sets BatchNorm's statistics:
        # the benchmark's, kept out of setup_s.
        self.reference_s = time.perf_counter() - t1
        del layout
        self.phases["weights"] = time.perf_counter() - t0
        self.pool = scene.pool(self.seed, self.traffic["pool"], self.B, cfg["scene"], self.V, self.H, self.W)
        self.in_bounds = work.in_bounds_shares(
            {k: v[0] for k, v in self.pool[0]["proj_matrices"].items()}, self.pool[0]["depth_values"][0],
            cfg["model"], self.H, self.W)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        self.phases["scenes"] = time.perf_counter() - t0 - self.phases["weights"]
        t0 = time.perf_counter()
        self.program = importlib.import_module("transmvsnet_tpu_torch.models.transmvsnet")
        self.model = self.program.TransMVSNet(program_config(cfg, compute_dtype=self.dtype), device=dev)
        self.model.load_state_dict(self.state)
        self.model.eval()
        self.phases["program"] = time.perf_counter() - t0
        t = []
        for i in range(self.traffic["warmup"]):
            t0 = time.perf_counter()
            self.request(self.pool[i % len(self.pool)])
            t.append(time.perf_counter() - t0)
        self.phases["warm_up"] = sum(t)
        # The requests judged: drawn from the seed among those that will
        # surely finish inside the window.
        surely = max(self.traffic["checked"], int(0.5 * self.cell.seconds / t[-1]))
        rng = scene.rng_for(self.seed, "checked")
        self.checked = set(rng.choice(surely, self.traffic["checked"], replace=False).tolist())

    def request(self, raw: dict):
        imgs, projs, dv = to_device(raw, self.dev)
        with torch.no_grad():
            out = self.model(imgs, projs, dv)
            depth, conf = self.program.blended_confidence(out)
        return out, depth.cpu().numpy(), conf.cpu().numpy()

    def serve(self) -> None:
        """The next request of the loop; its answer kept if it is judged."""
        i, raw = self.served, self.pool[self.served % len(self.pool)]
        out, depth, conf = self.request(raw)
        if i in self.checked:
            self.kept[i] = {"raw": raw, "out": {s: out[s] for s in STAGES}, "depth": depth, "conf": conf}
        self.served += 1

    # -- the window -----------------------------------------------------
    def window(self, seconds: float) -> dict:
        latencies = []
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            t0 = time.perf_counter()
            self.serve()
            latencies.append(time.perf_counter() - t0)
        end = time.perf_counter()
        n = self.served
        return {"count": n, "items": n * self.B, "window_s": end - start, "latencies_s": latencies, "failed": 0}

    def profiled(self, seconds: float, least: int) -> dict:
        """Requests run under the profiler: at least ``least`` and
        ``seconds``."""
        n, start = 0, time.perf_counter()
        while n < least or time.perf_counter() - start < seconds:
            self.request(self.pool[n % len(self.pool)])
            n += 1
        return {"count": n, "items": n * self.B}

    # -- the check ------------------------------------------------------
    def release(self) -> None:
        """Wait for the judged answers that the window did not reach, bring
        them to the host and free the program's state."""
        late = time.perf_counter()
        while len(self.kept) < len(self.checked) and time.perf_counter() - late < LATE_S:
            self.serve()
        for k in self.kept.values():
            k["out"] = {s: {f: v.detach().float().cpu() for f, v in o.items()} for s, o in k["out"].items()}
        del self.model
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    def check(self, limits: dict, explain: dict | None = None) -> dict:
        if len(self.kept) < len(self.checked):
            return dict.fromkeys(compare.INFERENCE, compare.MISSING)
        model = weights.reference_model(self.cfg, self.dev)
        model.load_state_dict(self.state)
        model.eval()
        readings = []
        for i in sorted(self.kept):
            k = self.kept[i]
            prog = k["out"]
            given = {"stage2": prog["stage1"]["depth"].to(self.dev), "stage3": prog["stage2"]["depth"].to(self.dev)}
            with torch.no_grad(), ref.full_float32():
                want = model(*to_device(k["raw"], self.dev), given_prev_depth=given)
                depth, conf = ref.blended(want)
            want = {s: {f: v.cpu() for f, v in o.items()} for s, o in want.items()}
            seen = {}
            readings.append(compare.inference(prog, k["depth"], k["conf"], want, depth.cpu(), conf.cpu(),
                                              self.cfg, seen))
            if explain is not None:
                explain.setdefault("requests", []).append(seen)
            del want
        return {name: max(r[name] for r in readings) for name in compare.INFERENCE}
