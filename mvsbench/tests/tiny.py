"""Cells cut to a size that the CPU runs in seconds, for the tests: the
same configurations and traffic at 64x96 with three views."""

from mvsbench import harness


def tiny_cell(workload: str, seconds: float = 0.5) -> harness.Cell:
    cell = harness.load_cell(workload, seconds)
    for part in ("infer", "train"):
        if part in cell.config:
            cell.config[part].update(height=64, width=96, views=3)
    if "infer" in cell.config:
        cell.config["infer"]["calibration_hw"] = [64, 96]
    cell.traffic["pool"] = 3
    return cell
