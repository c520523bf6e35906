"""Public API v1: the chart table, the dividend table and `run_simulation`.

The port's counterpart of the JAX package's `v1/api.py` (the reference's
`yuma_simulation.v1.api`, reference v1/api.py:24-132): the same
signatures, the same HTML, one simulation per (case, version) reused by
every chart row, and one batched :func:`..simulation.sweep.simulate_batch`
per version over the whole suite. It runs on the card unless the caller
passes `device="cpu"`.

`__all__` is the JAX package's frozen surface, with the serving tier's
entry point and client and the chain-replay names (:func:`serve`,
`SimulationClient`, `SnapshotArchive`, `StateCache`, `WhatIfSpec`,
`sweep_trailing_window`). matplotlib is needed to render the charts, not to import this
module or to simulate the suite (:func:`_simulate_suite`).
"""

from __future__ import annotations

from yuma_simulation_tpu_torch.foundry import (  # noqa: F401  (promoted, as in JAX's v1)
    cartel_scenario,
    compile_spec,
    load_metagraph_snapshot,
    stake_churn_scenario,
    takeover_scenario,
    weight_copier_scenario,
)
from yuma_simulation_tpu_torch.models.config import (  # noqa: F401  (public re-exports)
    SimulationHyperparameters,
    YumaConfig,
    YumaParams,
    YumaSimulationNames,
)
from yuma_simulation_tpu_torch.models.variants import (
    variant_for_version as _variant_for_version,
)
from yuma_simulation_tpu_torch.reporting.charts import (
    plot_bonds as _plot_bonds,
    plot_dividends as _plot_dividends,
    plot_incentives as _plot_incentives,
    plot_validator_server_weights as _plot_validator_server_weights,
)
from yuma_simulation_tpu_torch.reporting.tables import Table as _Table
from yuma_simulation_tpu_torch.reporting.tables import (
    generate_draggable_html_table as _generate_draggable_html_table,
    generate_ipynb_table as _generate_ipynb_table,
)
from yuma_simulation_tpu_torch.reporting.tables import (  # noqa: F401  (promoted)
    generate_total_dividends_table,
)
from yuma_simulation_tpu_torch.resilience.retry import (
    default_retry_policy as _default_retry_policy,
)
from yuma_simulation_tpu_torch.resilience.supervisor import (
    default_deadline as _default_deadline,
)
from yuma_simulation_tpu_torch.replay import (  # noqa: F401  (promoted)
    SnapshotArchive,
    StateCache,
    WhatIfSpec,
    sweep_trailing_window,
)
from yuma_simulation_tpu_torch.scenarios.base import Scenario
from yuma_simulation_tpu_torch.serve.server import (  # noqa: F401  (promoted)
    SimulationClient,
)
from yuma_simulation_tpu_torch.telemetry.runctx import ensure_run as _ensure_run
from yuma_simulation_tpu_torch.telemetry.runctx import span as _span
from yuma_simulation_tpu_torch.simulation.engine import (  # noqa: F401
    resolve_device as _resolve_device,
    run_simulation,
)
from yuma_simulation_tpu_torch.simulation.sweep import (
    pad_scenarios as _pad_scenarios,
    simulate_batch as _simulate_batch,
    stack_scenarios as _stack_scenarios,
)

__all__ = [
    "HTML",
    "Scenario",
    "SimulationClient",
    "SimulationHyperparameters",
    "SnapshotArchive",
    "StateCache",
    "WhatIfSpec",
    "YumaConfig",
    "YumaParams",
    "YumaSimulationNames",
    "cartel_scenario",
    "compile_spec",
    "generate_chart_table",
    "generate_total_dividends_table",
    "load_metagraph_snapshot",
    "run_simulation",
    "serve",
    "stake_churn_scenario",
    "sweep_trailing_window",
    "takeover_scenario",
    "weight_copier_scenario",
]


def serve(
    host: str = "127.0.0.1",
    port: int = 8080,
    *,
    background: bool = False,
    **knobs,
):
    """Start the warm-engine simulation service: `simulate`/`sweep`/
    chart-table/what-if endpoints with admission control, per-tenant
    quotas, shape-bucket coalescing and graceful degradation, plus
    `/metrics` and `/healthz`. It runs on the card unless the knobs name
    the CPU (``device="cpu"``); without CUDA it raises.

    Blocking by default (the CLI behavior: serve until interrupted);
    `background=True` returns the started
    :class:`..serve.server.SimulationServer` — call ``.close()`` for a
    graceful drain. `knobs` are :class:`..serve.service.ServeConfig`
    fields (``device``, ``queue_limit``, ``coalesce_window_seconds``,
    ``tenant_rate``, ``bundle_dir``, ...)."""
    from yuma_simulation_tpu_torch.serve.server import SimulationServer
    from yuma_simulation_tpu_torch.serve.service import ServeConfig

    server = SimulationServer(ServeConfig(**knobs), host=host, port=port)
    if background:
        return server.start()
    server.serve_forever()
    return server


class HTML:
    """An HTML document: `.data` holds the markup, and `_repr_html_` makes
    a notebook render it. This is the port's own small class, not
    `IPython.display.HTML` (the port does not need IPython); it carries
    the same `.data` and renders the same way."""

    def __init__(self, data: str):
        self.data = data

    def _repr_html_(self) -> str:
        return self.data


#: Chart rows rendered per case; cases with `plot_incentives` (Cases 10
#: and 11 of the built-in suite — the reference keys this off positional
#: indices 9/10, reference v1/api.py:42-45) add the incentives row.
_CHART_TYPES = ["weights", "dividends", "bonds", "normalized_bonds"]


def _decorated_case_name(
    case: Scenario, yuma_version: str, config: YumaConfig
) -> str:
    """Chart title: case + version, with the beta / alpha-range suffixes
    the reference appends for the EMA and liquid-alpha-4 families
    (reference v1/api.py:52-57)."""
    names = YumaSimulationNames()
    full = f"{case.name} - {yuma_version}"
    if yuma_version in (names.YUMA, names.YUMA_LIQUID, names.YUMA2):
        return f"{full} - beta={config.bond_penalty}"
    if yuma_version == names.YUMA4_LIQUID:
        return f"{full} [{config.alpha_low}, {config.alpha_high}]"
    return full


def _simulate_suite(
    cases: list[Scenario],
    yuma_versions: list[tuple[str, YumaParams]],
    yuma_hyperparameters: SimulationHyperparameters,
    supervised: bool = False,
    *,
    device="cuda",
) -> dict:
    """One batched :func:`simulate_batch` per version over the case suite,
    un-padded back to per-case `run_simulation`-shaped outputs:
    `{(case_idx, version): (config, (dividends_dict, bonds_per_epoch,
    incentives_per_epoch))}`.

    A same-shaped suite (the built-in 14 cases) is stacked and runs on
    `simulate_batch`'s "auto" (on the card the varying scan, K3); a suite
    of mixed shapes is padded by :func:`pad_scenarios` and runs with its
    per-scenario miner mask on the eager rung. Yuma 0's quantization
    divide runs in float64, as the reference's does. Each version's
    outputs come to the host in one copy.

    Every version rides the engine-degradation ladder with
    :func:`..resilience.retry.default_retry_policy`, as the JAX package's
    suite does: a dispatch that runs out of memory retries and demotes down
    the ladder, on the same device, instead of aborting the whole artifact
    build (one ``event=engine_demoted`` record per demotion). On the card
    the ladder ends at the last kernel rung, and a kernel that will not
    build or launch raises (:mod:`..resilience.retry`). `supervised=True` also arms the deadline watchdog at
    :func:`..resilience.supervisor.default_deadline`, so a hung dispatch is
    killed and retried or demoted through the same ladder."""
    if not cases:
        # The chart table renders empty, as the per-case loop did.
        return {}
    dev = _resolve_device(device)
    if len({c.weights.shape for c in cases}) == 1:
        W, S, ri, re_ = _stack_scenarios(cases, device=dev)
        mask = None
    else:
        W, S, ri, re_, mask = _pad_scenarios(cases, device=dev)
    deadline = _default_deadline() if supervised else None
    out = {}
    # The whole suite is one run (joining a caller's RunContext when one is
    # open) and each version's dispatch one span under it.
    with _ensure_run(), _span("chart_suite", versions=len(yuma_versions)):
        for yuma_version, yuma_params in yuma_versions:
            config = YumaConfig(simulation=yuma_hyperparameters, yuma_params=yuma_params)
            with _span(f"version:{yuma_version}"):
                ys = _simulate_batch(
                    W, S, ri, re_, config, _variant_for_version(yuma_version),
                    save_bonds=True, save_incentives=True, miner_mask=mask, x64=True,
                    retry_policy=_default_retry_policy(), deadline=deadline,
                )
            div = ys["dividends"].cpu().numpy()  # [B, Ep, Vp]
            bonds = ys["bonds"].cpu().numpy()  # [B, Ep, Vp, Mp]
            inc = ys["incentives"].cpu().numpy()  # [B, Ep, Mp]
            for i, case in enumerate(cases):
                E, V, M = case.weights.shape
                dividends = {
                    validator: [float(x) for x in div[i, :E, j]]
                    for j, validator in enumerate(case.validators)
                }
                out[(i, yuma_version)] = (
                    config,
                    (dividends, list(bonds[i, :E, :V, :M]), list(inc[i, :E, :M])),
                )
    return out


def generate_chart_table(
    cases: list[Scenario],
    yuma_versions: list[tuple[str, YumaParams]],
    yuma_hyperparameters: SimulationHyperparameters,
    draggable_table: bool = False,
    supervised: bool = False,
    *,
    device="cuda",
) -> HTML:
    """Simulate every case x version and assemble the chart grid (rows =
    chart types per case, columns = versions) as an :class:`HTML`
    (reference v1/api.py:24-132), on the card unless `device="cpu"`.
    Rendering needs matplotlib. `supervised=True` arms the deadline
    watchdog on top of the ladder every version rides
    (:func:`_simulate_suite`)."""
    table_data: dict[str, list[str]] = {v: [] for v, _ in yuma_versions}
    case_row_ranges: list[tuple[int, int, int]] = []
    row = 0

    # One simulation per (case, version) — batched into one call per
    # version across the whole suite.
    per_pair = _simulate_suite(
        cases, yuma_versions, yuma_hyperparameters, supervised=supervised, device=device
    )

    for idx, case in enumerate(cases):
        chart_types = list(_CHART_TYPES)
        if getattr(case, "plot_incentives", False):
            chart_types.append("incentives")

        per_version = {
            yuma_version: per_pair[(idx, yuma_version)]
            for yuma_version, _ in yuma_versions
        }

        case_start = row
        for chart_type in chart_types:
            for yuma_version, _ in yuma_versions:
                config, (dividends, bonds, incentives) = per_version[yuma_version]
                title = _decorated_case_name(case, yuma_version, config)
                if chart_type == "weights":
                    img = _plot_validator_server_weights(
                        validators=case.validators,
                        weights_epochs=case.weights_epochs,
                        servers=case.servers,
                        num_epochs=case.num_epochs,
                        case_name=title,
                        to_base64=True,
                    )
                elif chart_type == "dividends":
                    img = _plot_dividends(
                        num_epochs=case.num_epochs,
                        validators=case.validators,
                        dividends_per_validator=dividends,
                        case=title,
                        base_validator=case.base_validator,
                        to_base64=True,
                    )
                elif chart_type == "bonds":
                    img = _plot_bonds(
                        num_epochs=case.num_epochs,
                        validators=case.validators,
                        servers=case.servers,
                        bonds_per_epoch=bonds,
                        case_name=title,
                        to_base64=True,
                    )
                elif chart_type == "normalized_bonds":
                    img = _plot_bonds(
                        num_epochs=case.num_epochs,
                        validators=case.validators,
                        servers=case.servers,
                        bonds_per_epoch=bonds,
                        case_name=title,
                        to_base64=True,
                        normalize=True,
                    )
                else:
                    img = _plot_incentives(
                        servers=case.servers,
                        server_incentives_per_epoch=incentives,
                        num_epochs=case.num_epochs,
                        case_name=title,
                        to_base64=True,
                    )
                table_data[yuma_version].append(img)
            row += 1
        case_row_ranges.append((case_start, row - 1, idx))

    summary_table = _Table(
        columns=list(table_data), rows=[list(r) for r in zip(*table_data.values())]
    )
    if draggable_table:
        full_html = _generate_draggable_html_table(
            table_data, summary_table, case_row_ranges
        )
    else:
        full_html = _generate_ipynb_table(table_data, summary_table, case_row_ranges)

    return HTML(full_html)
