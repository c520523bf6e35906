"""Shape-bucket request coalescing: many tenants, one warm dispatch.

The throughput half of the serving tier. Heterogeneous tenants send
heterogeneous shapes; left alone, a busy service would launch one
dispatch per request. Instead, requests that share a coalesce key
within a short window ride ONE batched dispatch, and each request's
lanes are sliced back out:

- on the eager rung, requests in the same planner :class:`ShapeBucket`
  are DONOR-PACKED (:func:`..simulation.sweep.pack_scenarios`: zero
  stakes and mask-excluded miner columns pad every lane to the bucket),
  as the JAX package packs its XLA rung;
- on a kernel rung (K3 / K2, which take no per-lane miner mask),
  requests of the SAME `[E, V, M]` shape stack into one batched launch
  (:func:`..simulation.sweep.stack_scenarios`).

Either way a lane is bit-for-bit the same scenario dispatched alone on
the same rung (the packing contract for the eager rung; the kernels'
lanes are independent blocks of one launch), so coalescing changes
LATENCY GROUPING only, never results.

This module owns the two pure pieces (grouping and result slicing);
the dispatcher loop that drives them lives in :mod:`.service`.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import numpy as np


def gather_group(
    queue,
    first,
    *,
    window_seconds: float,
    max_batch: int,
    sleep: Callable[[float], None] = time.sleep,
) -> list:
    """The dispatch group for `first`: itself, plus every queued request
    sharing its coalesce key after one `window_seconds` gathering pause
    (bounded by `max_batch`). Requests with no key (sweeps, tables,
    what-ifs) always dispatch alone, and a zero window
    disables gathering without disabling the shared-bucket packing of
    whatever already queued."""
    key = first.ticket.coalesce_key
    if key is None or max_batch <= 1:
        return [first]
    if window_seconds > 0:
        sleep(window_seconds)
    mates = queue.take_matching(
        lambda p: p.ticket.coalesce_key == key, limit=max_batch - 1
    )
    return [first] + mates


def slice_simulate_response(
    dividends: np.ndarray,
    lane: int,
    ticket,
    *,
    quarantine_entries: Sequence,
    report,
    coalesced: int,
) -> dict:
    """One request's response body out of a (possibly packed) batched
    result: crop the lane to the scenario's own `[E, V]` view (padding
    is exact zeros by the packing contract, so cropping loses nothing),
    attach the request's OWN quarantine provenance (local epoch/tensor —
    lane indices are an internal detail), and summarize what degraded.

    `status` is the graceful-degradation contract: ``"ok"`` for a clean
    lane — even if a *different* tenant's lane was quarantined —
    ``"partial"`` when THIS lane was masked from some epoch on."""
    E, V, _ = ticket.scenario.weights.shape
    lane_div = np.asarray(dividends[lane])[:E, :V]
    mine = [
        {"epoch": int(e.epoch), "tensor": str(e.tensor)}
        for e in quarantine_entries
        if e.case == lane
    ]
    degraded = bool(
        mine
        or report.stalls_killed
        or report.engine_demotions
        or report.mesh_shrinks
    )
    body = {
        "status": "partial" if mine else "ok",
        "request_id": ticket.request_id,
        "tenant": ticket.tenant,
        "engine": ",".join(report.engines_used),
        "coalesced": int(coalesced),
        "degraded": degraded,
        "dividends": lane_div.tolist(),
        "total_dividends": lane_div.sum(axis=0).tolist(),
        "report": {
            "stalls_killed": report.stalls_killed,
            "engine_demotions": report.engine_demotions,
            "mesh_shrinks": report.mesh_shrinks,
            "units_retried": report.units_retried,
            "lanes_quarantined": len(mine),
            "engines_used": list(report.engines_used),
        },
    }
    if mine:
        body["quarantine"] = mine
    return body
