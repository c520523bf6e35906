"""Serving tier: the warm-engine simulation service.

The port's counterpart of the JAX package's `serve/`: the long-lived
process in which the kernel libraries stay loaded across requests,
heterogeneous tenants coalesce onto shared shape buckets, and hostile
traffic degrades gracefully instead of taking the process down. It runs
on the card unless :class:`~.service.ServeConfig` names the CPU
(``device="cpu"``). The pipeline modules:

- :mod:`.admission` — validate + price every request through the
  dispatch planner and the analytic memory preflight BEFORE anything
  launches (typed :class:`..resilience.errors.AdmissionRejected` -> 400
  with the preflight's reshape suggestion);
- :mod:`.quotas` — per-tenant token buckets + the global bounded run
  queue (typed :class:`..resilience.errors.QueueOverflow` -> 429 +
  ``Retry-After``; ``serve_queue_depth``/``serve_requests_shed``
  metrics);
- :mod:`.coalescer` — same-shape-bucket requests donor-packed into one
  batched dispatch, per-request lanes sliced back bitwise;
- :mod:`.lifecycle` — the per-engine-rung circuit breaker (trip ->
  re-anchored plans service-wide -> half-open probe -> close) and the
  startup warmup pass;
- :mod:`.apikeys` — signed HMAC tenant identity (``X-Api-Key``);
- :mod:`.service` / :mod:`.server` — the pipeline core and its stdlib
  `http.server` front (``/v1/simulate``, ``/v1/sweep``, ``/v1/table``,
  ``/v1/whatif``, ``/healthz``, ``/metrics``, ``/debug/*``) plus the
  stdlib :class:`~.server.SimulationClient`.

The horizontal tier, each of its processes on the same device:

- :mod:`.worker` — one warm service claiming a pool slot (a lease) and
  heartbeating what it holds (state-cache prefixes, warm shape
  buckets, kernel-library builds);
- :mod:`.router` — the stateless front that admits every request like
  the service does and places it on the live worker with the best
  claim score, rerouting off a worker lost mid-request;
- :mod:`.autoscaler` — SLO-burn-driven pool sizing;
- :mod:`.drill` — the kill-a-worker chaos drill
  (``--scaleout-drill``).

Run it: ``python -m yuma_simulation_tpu_torch.serve`` (see ``--help``;
``--smoke`` drives the contract-defining requests once).
"""

from yuma_simulation_tpu_torch.serve.admission import (  # noqa: F401
    AdmissionTicket,
    admit,
)
from yuma_simulation_tpu_torch.serve.apikeys import (  # noqa: F401
    ApiKeyring,
    mint_api_key,
)
from yuma_simulation_tpu_torch.serve.autoscaler import Autoscaler  # noqa: F401
from yuma_simulation_tpu_torch.serve.lifecycle import (  # noqa: F401
    CircuitBreaker,
    warmup,
)
from yuma_simulation_tpu_torch.serve.quotas import (  # noqa: F401
    BoundedRunQueue,
    TenantQuotas,
    TokenBucket,
)
from yuma_simulation_tpu_torch.serve.server import (  # noqa: F401
    ServeResponse,
    SimulationClient,
    SimulationServer,
    wait_until_ready,
)
from yuma_simulation_tpu_torch.serve.router import (  # noqa: F401
    RouterConfig,
    RouterService,
    WorkerPool,
    claim_score,
    rank_claims,
)
from yuma_simulation_tpu_torch.serve.service import (  # noqa: F401
    ServeConfig,
    SimulationService,
)
from yuma_simulation_tpu_torch.serve.worker import ServeWorker  # noqa: F401
