"""The loops that drive the program, one per traffic ``kind``."""

import importlib


def program_config(cfg: dict, **switches):
    """The program's ``ModelConfig`` for a configuration file's ``model``
    block, with the driver's own switches (dtype, remat)."""
    config = importlib.import_module("transmvsnet_tpu_torch.config")
    m = cfg["model"]
    return config.ModelConfig(
        ndepths=tuple(m["ndepths"]), depth_interval_ratios=tuple(m["depth_interval_ratios"]),
        cr_base_channels=tuple(m["cr_base_channels"]), base_channels=m["base_channels"],
        fmt_d_model=m["fmt_d_model"], fmt_nhead=m["fmt_nhead"], fmt_layers=tuple(m["fmt_layers"]),
        dense_cost_reg=m["dense_cost_reg"], **switches)
