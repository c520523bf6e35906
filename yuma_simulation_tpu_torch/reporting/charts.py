"""Matplotlib charts of a simulation's outputs (host side, numpy inputs).

The port's copy of the JAX package's `reporting/charts.py`, itself the
behavior-parity equivalent of the reference's four plotters
(charts_utils.py:48-335): the same figure geometry, style cycle, tick
layout, normalization rules and base64 embedding, so the same numbers
render to the same PNG bytes.

matplotlib is imported, with the `Agg` backend selected, inside the
functions that draw (:func:`_pyplot`): the package, the v1 API and its
suite simulation import and run on a machine without matplotlib. The
numbers each chart draws come from plain numpy helpers that need no
matplotlib: :func:`_dividend_series`, :func:`_bond_series`,
:func:`_server2_weights` and :func:`_incentive_series`.
"""

from __future__ import annotations

import base64
import io
from typing import Optional, Sequence

import numpy as np

from yuma_simulation_tpu_torch.reporting.tables import calculate_total_dividends

#: (linestyle, marker, markersize, markeredgewidth) cycled per validator
#: (reference charts_utils.py:391-398).
_STYLE_CYCLE = [("-", "+", 12, 2), ("--", "x", 12, 1), (":", "o", 4, 1)]


def _pyplot():
    """`matplotlib.pyplot` on the non-interactive `Agg` backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _styles_for(validators: Sequence[str]):
    return {
        v: _STYLE_CYCLE[i % len(_STYLE_CYCLE)] for i, v in enumerate(validators)
    }


def _default_xticks(ax, num_epochs: int) -> None:
    # [0, 1, 2, 5, 10, ...] (reference charts_utils.py:351-355)
    locs = [0, 1, 2] + list(range(5, num_epochs, 5))
    ax.set_xticks(locs)
    ax.set_xticklabels([str(i) for i in locs], fontsize=8)


def _to_base64_img() -> str:
    plt = _pyplot()
    buf = io.BytesIO()
    plt.savefig(buf, format="png", transparent=True, bbox_inches="tight", dpi=100)
    buf.seek(0)
    encoded = base64.b64encode(buf.read()).decode("ascii")
    buf.close()
    plt.close()
    return (
        f'<img src="data:image/png;base64,{encoded}" '
        'style="max-width:1200px; height:auto;" draggable="false">'
    )


def _dividend_series(
    validators: Sequence[str],
    dividends_per_validator: dict[str, list[float]],
    base_validator: str,
    num_epochs: int,
) -> list[tuple[str, np.ndarray, str]]:
    """The dividend chart's lines: per validator, in the dict's order,
    `(validator, float64 series, legend label)`, the label carrying the
    validator's total and its percentage against the base validator."""
    totals, pct = calculate_total_dividends(
        list(validators), dividends_per_validator, base_validator, num_epochs
    )
    lines = []
    for validator, dividends in dividends_per_validator.items():
        series = np.asarray([float(d) for d in dividends], float)
        diff = pct[validator]
        suffix = (
            f"(+{diff:.1f}%)" if diff > 0 else f"({diff:.1f}%)" if diff < 0 else "(Base)"
        )
        lines.append(
            (validator, series, f"{validator}: Total = {totals[validator]:.6f} {suffix}")
        )
    return lines


def plot_dividends(
    num_epochs: int,
    validators: Sequence[str],
    dividends_per_validator: dict[str, list[float]],
    case: str,
    base_validator: str,
    to_base64: bool = False,
) -> Optional[str]:
    """Dividend-per-1000-tao trajectories (reference charts_utils.py:48-122)."""
    plt = _pyplot()
    plt.close("all")
    _, ax = plt.subplots(figsize=(14, 6))
    styles = _styles_for(validators)
    lines = _dividend_series(validators, dividends_per_validator, base_validator, num_epochs)

    x = None
    for idx, (validator, series, label) in enumerate(lines):
        if x is None:
            x = np.arange(len(series))
        linestyle, marker, markersize, markeredgewidth = styles[validator]
        ax.plot(
            x + idx * 0.05,
            series,
            marker=marker,
            markeredgewidth=markeredgewidth,
            markersize=markersize,
            label=label,
            alpha=0.7,
            linestyle=linestyle,
        )

    if x is not None:
        _default_xticks(ax, len(x))
    ax.set_xlabel("Time (Epochs)")
    ax.set_ylim(bottom=0)
    ax.set_ylabel("Dividend per 1,000 Tao per Epoch")
    ax.set_title(case)
    ax.grid(True)
    ax.legend()
    if case.startswith("Case 4"):
        # fixed scale for the all-switch case (reference charts_utils.py:114-115)
        ax.set_ylim(0, 0.042)
    plt.subplots_adjust(hspace=0.3)

    if to_base64:
        return _to_base64_img()
    plt.show()
    return None


def _bond_series(
    bonds_per_epoch: Sequence[np.ndarray],
    num_validators: int,
    num_servers: int,
    normalize: bool,
) -> np.ndarray:
    """`[servers, validators, epochs]` bond trajectories, optionally
    normalized across validators per (server, epoch)
    (reference charts_utils.py:358-388)."""
    stacked = np.asarray(
        [np.asarray(b, float) for b in bonds_per_epoch]
    )  # [E, V, M]
    data = stacked.transpose(2, 1, 0)[:num_servers, :num_validators]  # [M, V, E]
    if normalize:
        totals = data.sum(axis=1, keepdims=True)
        data = np.divide(
            data, totals, out=data.copy(), where=totals > 1e-12
        )
    return data


def plot_bonds(
    num_epochs: int,
    validators: Sequence[str],
    servers: Sequence[str],
    bonds_per_epoch: Sequence[np.ndarray],
    case_name: str,
    to_base64: bool = False,
    normalize: bool = False,
) -> Optional[str]:
    """Per-server bond (ratio) trajectories (reference charts_utils.py:125-198)."""
    plt = _pyplot()
    x = list(range(num_epochs))
    fig, axes = plt.subplots(
        1, len(servers), figsize=(14, 5), sharex=True, sharey=True
    )
    if len(servers) == 1:
        axes = [axes]

    data = _bond_series(bonds_per_epoch, len(validators), len(servers), normalize)
    styles = _styles_for(validators)
    handles, labels = [], []
    for s_idx, server in enumerate(servers):
        ax = axes[s_idx]
        for v_idx, validator in enumerate(validators):
            linestyle, marker, markersize, markeredgewidth = styles[validator]
            (line,) = ax.plot(
                x,
                data[s_idx][v_idx],
                alpha=0.7,
                marker=marker,
                markersize=markersize,
                markeredgewidth=markeredgewidth,
                linestyle=linestyle,
                linewidth=2,
            )
            if s_idx == 0:
                handles.append(line)
                labels.append(validator)
        _default_xticks(ax, num_epochs)
        ax.set_xlabel("Epoch")
        if s_idx == 0:
            ax.set_ylabel("Bond Ratio" if normalize else "Bond Value")
        ax.set_title(server)
        ax.grid(True)
        if normalize:
            ax.set_ylim(0, 1.05)

    fig.suptitle(
        f"Validators bonds per Server{' normalized' if normalize else ''}\n{case_name}",
        fontsize=14,
    )
    fig.legend(
        handles,
        labels,
        loc="lower center",
        ncol=len(validators),
        bbox_to_anchor=(0.5, 0.02),
    )
    plt.tight_layout(rect=(0, 0.05, 0.98, 0.95))

    if to_base64:
        return _to_base64_img()
    plt.show()
    return None


def _server2_weights(
    weights_epochs: Sequence[np.ndarray], num_validators: int, num_epochs: int
) -> np.ndarray:
    """`[epochs, validators]`: each validator's weight on the second
    server, what the weights chart draws."""
    W = np.asarray([np.asarray(w, float) for w in weights_epochs])  # [E, V, M]
    return W[:num_epochs, :num_validators, 1]


def plot_validator_server_weights(
    validators: Sequence[str],
    weights_epochs: Sequence[np.ndarray],
    servers: Sequence[str],
    num_epochs: int,
    case_name: str,
    to_base64: bool = False,
) -> Optional[str]:
    """Validator->server weight trajectories with adaptive y-ticks
    (reference charts_utils.py:201-301)."""
    styles = _styles_for(validators)
    server2 = _server2_weights(weights_epochs, len(validators), num_epochs)

    # Build y-ticks: the two server lines plus any distinct intermediate
    # levels, labeled as percentages, spaced at least 0.05 apart.
    positions = [0.0, 1.0]
    tick_labels = [servers[0], servers[1]]
    for y in sorted(set(server2.flatten().tolist())):
        if y in (0.0, 1.0) or abs(y) < 0.02 or abs(y - 1.0) < 0.02:
            continue
        if all(abs(y - p) >= 0.05 for p in positions):
            positions.append(y)
            pct = y * 100
            tick_labels.append(
                f"{pct:.0f}%" if float(pct).is_integer() else f"{pct:.1f}%"
            )
    order = np.argsort(positions)
    positions = [positions[i] for i in order]
    tick_labels = [tick_labels[i] for i in order]

    plt = _pyplot()
    fig_height = 1 if len(positions) <= 2 else 3
    _, ax = plt.subplots(figsize=(14, fig_height))
    ax.set_ylim(-0.05, 1.05)

    for v_idx, validator in enumerate(validators):
        linestyle, marker, markersize, markeredgewidth = styles[validator]
        ax.plot(
            range(num_epochs),
            server2[:, v_idx],
            label=validator,
            marker=marker,
            linestyle=linestyle,
            markersize=markersize,
            markeredgewidth=markeredgewidth,
            linewidth=2,
        )

    ax.set_yticks(positions)
    ax.set_yticklabels(tick_labels)
    _default_xticks(ax, num_epochs)
    ax.set_xlabel("Epoch")
    ax.set_title(f"Validators Weights to Servers \n{case_name}")
    ax.legend()
    ax.grid(True)

    if to_base64:
        return _to_base64_img()
    plt.show()
    return None


def _incentive_series(server_incentives_per_epoch: Sequence[np.ndarray]) -> np.ndarray:
    """`[epochs, servers]` float64 incentives, what the incentives chart
    draws (one line per server)."""
    return np.asarray([np.asarray(e, float) for e in server_incentives_per_epoch])


def plot_incentives(
    servers: Sequence[str],
    server_incentives_per_epoch: Sequence[np.ndarray],
    num_epochs: int,
    case_name: str,
    to_base64: bool = False,
) -> Optional[str]:
    """Server incentive trajectories (reference charts_utils.py:304-335)."""
    plt = _pyplot()
    x = np.arange(num_epochs)
    _, ax = plt.subplots(figsize=(14, 3))
    incentives = _incentive_series(server_incentives_per_epoch)  # [E, M]
    for s_idx, server in enumerate(servers):
        ax.plot(x, incentives[:, s_idx], label=server)
    _default_xticks(ax, num_epochs)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Server Incentive")
    ax.set_title(f"Server Incentives\n{case_name}")
    ax.set_ylim(-0.05, 1.05)
    ax.legend()
    ax.grid(True)

    if to_base64:
        return _to_base64_img()
    plt.show()
    return None
