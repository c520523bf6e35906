"""The program's configuration object from a configuration file. The
program is imported only when a driver sets up, never at import time."""

from __future__ import annotations


def yuma_config(config: dict):
    """The port's `YumaConfig` of a configuration file's `simulation` and
    `yuma_params` groups."""
    from yuma_simulation_tpu_torch.models.config import (
        SimulationHyperparameters,
        YumaConfig,
        YumaParams,
    )

    return YumaConfig(SimulationHyperparameters(**config["simulation"]),
                      YumaParams(**config["yuma_params"]))
