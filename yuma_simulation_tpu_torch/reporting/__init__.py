"""Dividend aggregation, the reference's tables (no pandas), the charts
and the chart grid's HTML. matplotlib is imported only to draw."""

from yuma_simulation_tpu_torch.reporting.charts import (  # noqa: F401
    plot_bonds,
    plot_dividends,
    plot_incentives,
    plot_validator_server_weights,
)
from yuma_simulation_tpu_torch.reporting.tables import (  # noqa: F401
    Table,
    calculate_total_dividends,
    generate_draggable_html_table,
    generate_ipynb_table,
    generate_total_dividends_table,
)
