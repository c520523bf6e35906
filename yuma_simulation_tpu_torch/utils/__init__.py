"""Host-side utilities of the port: structured logging, the durable-file
helpers the metrics sink writes through, timing and profiling."""

from yuma_simulation_tpu_torch.utils.checkpoint import (  # noqa: F401
    append_durable,
    publish_atomic,
    read_jsonl_tolerant,
)
from yuma_simulation_tpu_torch.utils.logging import (  # noqa: F401
    log_event,
    parse_event_line,
    setup_logging,
)
from yuma_simulation_tpu_torch.utils.profiling import profile_trace, timed  # noqa: F401
from yuma_simulation_tpu_torch.utils.timing import time_best  # noqa: F401
