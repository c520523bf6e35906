"""Fleet fabric: the work-stealing multi-host sweep scheduler.

The distributed tier above the single-host resilience stack. A sweep grid is partitioned into pure, idempotent work units
(the manifest), hosts coordinate through a shared filesystem store with
LEASE-BASED claiming — atomic claim files, heartbeat-renewed, expiry-
driven stealing — and each host computes its claimed units through its
local :class:`..resilience.SweepSupervisor`, so every unit inherits the
deadline watchdog, engine ladder, NaN quarantine and elastic mesh. Any
surviving host requeues a dead host's units; results are content-
addressed and bitwise-deterministic, so duplicate execution is harmless
and publish is at-most-once.

- :mod:`.lease` — the claim/heartbeat/steal protocol;
- :mod:`.store` — manifest + per-unit results + per-host bundles;
- :mod:`.scheduler` — the host loop and the `run_fleet_batch` /
  `run_fleet_grid` / `run_fleet_case` entry points;
- :mod:`.health` — the merged-ledger :class:`FleetHealthReport` and the
  `obsreport --check` fleet gate;
- :mod:`.simhost` — multiprocess simulated hosts + the pod-level chaos
  drill, on the device the driver names.

See README.md "Meshes, the ops plane and the fleet through the port" for
the operator-facing contract.
"""

from yuma_simulation_tpu_torch.fabric.health import (  # noqa: F401
    FleetDegradation,
    FleetHealthReport,
    build_fleet_report,
    check_fleet,
    merged_ledger,
    publish_fleet_report,
)
from yuma_simulation_tpu_torch.fabric.lease import (  # noqa: F401
    ClaimedLease,
    LeaseInfo,
    LeaseStore,
)
from yuma_simulation_tpu_torch.fabric.scheduler import (  # noqa: F401
    FleetConfig,
    FleetHost,
    FleetHostSummary,
    partition_lanes,
    run_fleet_artifacts,
    run_fleet_batch,
    run_fleet_case,
    run_fleet_grid,
)
from yuma_simulation_tpu_torch.fabric.store import (  # noqa: F401
    FleetStore,
    is_fleet_store,
)
