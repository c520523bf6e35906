"""Scenarios as data: dense per-epoch weight/stake arrays + a case registry."""

from yuma_simulation_tpu_torch.scenarios.base import (  # noqa: F401
    BaseCase,
    Scenario,
    class_registry,
    create_case,
    get_cases,
    register_case,
)
from yuma_simulation_tpu_torch.scenarios import builtin as _builtin  # noqa: F401

#: Instantiated default suite, in registration order.
cases = get_cases()
