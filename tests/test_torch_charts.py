"""The port's chart-table path — `reporting/charts.py`, the HTML grids of
`reporting/tables.py`, `v1/api.py` and `cli/charts_table_generator.py` —
against the JAX package on the CPU.

Contracts: `generate_chart_table(...).data` byte for byte the JAX
package's (the suite's per-epoch outputs are bitwise its XLA rung's on the
built-in cases, and both render them with the same matplotlib calls);
`v1.api.__all__` a subset of the
JAX package's frozen surface, the missing names exactly those of the
port's later slices; importing `v1.api` and simulating the suite load
neither matplotlib nor IPython. The chart CLI's own tests are in
tests/test_torch_padding.py, which spreads the rendering over two test
workers.
"""

import subprocess
import sys
from html.parser import HTMLParser
from pathlib import Path

import numpy as np
import pytest

from yuma_simulation_tpu.models.config import (
    SimulationHyperparameters as JSim,
    YumaParams as JParams,
)
from yuma_simulation_tpu.scenarios import get_cases as j_get_cases
from yuma_simulation_tpu.v1 import api as j_api
from yuma_simulation_tpu_torch.models.config import SimulationHyperparameters, YumaParams
from yuma_simulation_tpu_torch.reporting import charts
from yuma_simulation_tpu_torch.scenarios import get_cases
from yuma_simulation_tpu_torch.v1 import api

REPO = Path(__file__).resolve().parent.parent
TWO_VERSIONS = ["Yuma 1 (paper)", "Yuma 3 (Rhef)"]
#: The JAX package's frozen v1 surface that the port has no counterpart
#: of yet: none, now that the serving tier and what-if replay are ported.
LATER_SLICES: set = set()


def _images(html: str) -> list[str]:
    """The `src` of every `<img>`, by the standard library's parser."""

    class Images(HTMLParser):
        def __init__(self):
            super().__init__()
            self.srcs = []

        def handle_starttag(self, tag, attrs):
            if tag == "img":
                self.srcs.append(dict(attrs)["src"])

    parser = Images()
    parser.feed(html)
    return parser.srcs


@pytest.mark.parametrize("draggable", [True, False], ids=["draggable", "notebook"])
def test_chart_table_bytes_equal_jax(draggable):
    """Cases 1-2 x Yuma 1 / Yuma 3 at bond_penalty 0.99: the port's HTML is
    the JAX package's, byte for byte, in both table styles."""
    ours = api.generate_chart_table(
        get_cases()[:2], [(v, YumaParams()) for v in TWO_VERSIONS],
        SimulationHyperparameters(bond_penalty=0.99), draggable_table=draggable,
        device="cpu",
    )
    theirs = j_api.generate_chart_table(
        j_get_cases()[:2], [(v, JParams()) for v in TWO_VERSIONS],
        JSim(bond_penalty=0.99), draggable_table=draggable,
    )
    assert isinstance(ours, api.HTML) and ours._repr_html_() is ours.data
    assert ours.data == theirs.data
    srcs = _images(ours.data)
    assert len(srcs) == 16  # 2 cases x 4 chart rows x 2 versions
    assert all(s.startswith("data:image/png;base64,") for s in srcs)
    assert ("document.addEventListener" in ours.data) == draggable


def test_incentives_row_bytes_equal_jax():
    """Case 10 alone keeps its incentives row (5 images), byte for byte."""
    ours = api.generate_chart_table(
        [get_cases()[9]], [("Yuma 1 (paper)", YumaParams())], SimulationHyperparameters(),
        device="cpu",
    )
    theirs = j_api.generate_chart_table(
        [j_get_cases()[9]], [("Yuma 1 (paper)", JParams())], JSim(),
    )
    assert ours.data == theirs.data
    assert len(_images(ours.data)) == 5


def test_chart_numbers_without_matplotlib():
    """The numbers each chart draws come from numpy helpers: the dividend
    lines (with the JAX package's legend totals), `_bond_series` raw and
    normalized, the weights on the second server, the incentives."""
    from yuma_simulation_tpu.reporting import charts as j_charts
    from yuma_simulation_tpu.reporting.tables import calculate_total_dividends as j_totals

    case = get_cases()[9]
    (config, (div, bonds, inc)), = api._simulate_suite(
        [case], [("Yuma 1 (paper)", YumaParams())], SimulationHyperparameters(),
        device="cpu").values()
    lines = charts._dividend_series(case.validators, div, case.base_validator, case.num_epochs)
    totals, _ = j_totals(case.validators, div, case.base_validator, case.num_epochs)
    for (name, series, label), v in zip(lines, case.validators):
        assert name == v and label.startswith(f"{v}: Total = {totals[v]:.6f} (")
        np.testing.assert_array_equal(series, np.asarray(div[v], float))
    for normalize in (False, True):
        np.testing.assert_array_equal(
            charts._bond_series(bonds, 3, 2, normalize),
            j_charts._bond_series(bonds, 3, 2, normalize))
    assert charts._bond_series(bonds, 3, 2, True).sum(axis=1).max() <= 1.0 + 1e-12
    np.testing.assert_array_equal(
        charts._server2_weights(case.weights_epochs, 3, case.num_epochs), case.weights[:, :, 1])
    np.testing.assert_array_equal(charts._incentive_series(inc), np.asarray(inc, float))


def test_v1_surface_is_part_of_the_frozen_one():
    """`yuma_simulation_tpu_torch.v1` exports nothing; `v1.api.__all__` is
    the JAX package's frozen surface (tests/unit/test_apiver.py) less the
    names of the port's later slices, and is every public callable of the
    module."""
    import yuma_simulation_tpu_torch.v1 as v1
    from tests.unit.test_apiver import _FROZEN_SURFACE

    assert not [n for n in vars(v1) if not n.startswith("_") and n != "api"]
    assert set(api.__all__) <= set(_FROZEN_SURFACE)
    assert set(_FROZEN_SURFACE) - set(api.__all__) == LATER_SLICES
    public = sorted(
        n for n, v in vars(api).items()
        if not n.startswith("_") and (callable(v) or isinstance(v, type))
    )
    assert public == sorted(api.__all__)


def test_supervised_and_empty_suites():
    """`supervised=True` (the deadline watchdog on top of the ladder every
    version rides) renders byte for byte the unsupervised table; an empty
    suite renders JAX's empty table."""
    hp = SimulationHyperparameters()
    one = [("Yuma 1 (paper)", YumaParams())]
    supervised = api.generate_chart_table(get_cases()[:1], one, hp, supervised=True,
                                          device="cpu")
    plain = api.generate_chart_table(get_cases()[:1], one, hp, device="cpu")
    assert supervised.data == plain.data and _images(supervised.data)
    empty = api.generate_chart_table([], [("Yuma 1 (paper)", YumaParams())], hp, device="cpu")
    assert empty.data == j_api.generate_chart_table(
        [], [("Yuma 1 (paper)", JParams())], JSim()).data


def test_suite_loads_neither_matplotlib_nor_ipython():
    """In a fresh interpreter: importing `v1.api` and simulating a suite
    on the CPU leaves matplotlib and IPython unloaded."""
    code = (
        "import sys\n"
        "from yuma_simulation_tpu_torch.v1 import api\n"
        "from yuma_simulation_tpu_torch.scenarios import get_cases\n"
        "out = api._simulate_suite(get_cases()[:2], [('Yuma 1 (paper)', api.YumaParams())],"
        " api.SimulationHyperparameters(), device='cpu')\n"
        "assert len(out) == 2\n"
        "loaded = sorted(m for m in ('matplotlib', 'IPython') if m in sys.modules)\n"
        "print('LOADED', loaded)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "LOADED []" in out.stdout, out.stdout
