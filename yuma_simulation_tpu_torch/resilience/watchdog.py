"""Deadline watchdog: bounded wall-clock supervision for dispatches (the
JAX package's `resilience/watchdog.py`).

The retry ladder recovers from failures that *raise*; this module covers
the ones that *don't*. A kernel build can hang on a wedged compiler, and a
dispatch whose collective partner died blocks forever rather than
erroring — on a long sweep either one silently wedges the whole job.

:func:`run_with_deadline` executes a dispatch on a *worker thread* and
watches it from the caller: the worker posts a heartbeat when it
finishes (result or exception); if the heartbeat does not arrive within
the :class:`Deadline` budget, the caller logs one
``event=engine_stalled`` record and raises a typed
:class:`..errors.EngineStall` — which :func:`..errors.classify_failure`
treats as retryable, so a stall inside :func:`..retry.run_ladder`
demotes down the engine ladder exactly like an out-of-memory launch.

Two things differ from the JAX package on CUDA:

- **The dispatch is asynchronous.** A kernel launch returns before the
  card has run it, so a timed `fn` must end in the outputs' host copy or
  in :func:`block_until_ready` (a synchronize of the dispatch's stream);
  otherwise the budget covers only the launches. The engines' supervised
  dispatches end in :func:`block_until_ready`.
- **A worker thread inherits neither the caller's current device nor its
  current stream.** The worker sets both (`torch.cuda.set_device` and
  `torch.cuda.stream` on the caller's `current_stream()`), so the
  supervised launches land on the same queue as the caller's own work.

Why a thread and not a signal: the hang is inside native code, so no
Python-level interruption can unwind it. The worker is a daemon thread
that is *abandoned*, not killed — if the native call eventually returns,
the result is discarded (the :class:`_Dispatch` records that its deadline
already fired and drops the late value). **A truly hung kernel cannot be
cancelled**: the card runs a launched kernel to its end, so the abandoned
work keeps its stream busy and the retry's launches queue behind it on the
card. The injected :class:`..faults.StallFault` is a host sleep on the
worker before the launch, which is what the tests drive. Abandonment is
safe because every dispatch here is functionally pure: the only leaked
resources are the thread stack and whatever device memory the late result
holds until it is dropped.

Cost on the healthy path: one thread spawn per supervised dispatch (tens
of microseconds) and the synchronize the dispatch ends in.
"""

from __future__ import annotations

import contextvars
import dataclasses
import logging
import threading
from typing import Callable, Optional, TypeVar

import torch

from yuma_simulation_tpu_torch.resilience import faults
from yuma_simulation_tpu_torch.resilience.errors import EngineStall
from yuma_simulation_tpu_torch.telemetry.metrics import get_registry
from yuma_simulation_tpu_torch.utils.logging import log_event

logger = logging.getLogger(__name__)

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class Deadline:
    """A wall-clock budget for one supervised dispatch.

    `budget_seconds` is the hard limit: the dispatch (a first call's
    kernel build included) must post its heartbeat within it.
    `grace_seconds` is added on retries of the SAME work (`attempt > 0` in :meth:`budget_for_attempt`): a retried
    dispatch may legitimately need to rebuild after a failed build, and
    killing the retry on the cold-start budget would turn one transient
    stall into a guaranteed ladder walk.
    """

    budget_seconds: float
    grace_seconds: float = 0.0

    def __post_init__(self) -> None:
        if self.budget_seconds <= 0:
            raise ValueError("Deadline budget_seconds must be > 0")
        if self.grace_seconds < 0:
            raise ValueError("Deadline grace_seconds must be >= 0")

    def budget_for_attempt(self, attempt: int) -> float:
        """The budget for retry number `attempt` (0 = first try)."""
        return self.budget_seconds + (self.grace_seconds if attempt else 0.0)


class _Dispatch:
    """One supervised dispatch's shared state between caller and worker.

    The `done` event is the heartbeat; `expired` latches (under `lock`)
    when the caller gives up, so a worker that wakes up late can see its
    result is unwanted and drop it instead of leaking device references
    in a dead thread's frame."""

    def __init__(self) -> None:
        self.done = threading.Event()
        self.lock = threading.Lock()
        self.expired = False
        self.result: object = None
        self.error: Optional[BaseException] = None


def run_with_deadline(
    fn: Callable[[], T],
    deadline: Optional[Deadline],
    *,
    label: str = "",
    attempt: int = 0,
) -> T:
    """Run `fn()` under `deadline`; raise :class:`EngineStall` on expiry.

    `fn` runs on a daemon worker thread, on the caller's current CUDA
    device and stream, while the caller waits on the heartbeat; it should
    end in :func:`block_until_ready` or a host copy (see the module
    docstring). Three outcomes:

    - the worker finishes in time: its return value is returned (or its
      exception re-raised with the original traceback — the retry
      ladder's `classify_failure` sees exactly what a direct call would
      have raised);
    - the budget expires: one ``event=engine_stalled`` record is logged
      and :class:`EngineStall` raised; the worker is abandoned (see the
      module docstring for why that is safe here);
    - `deadline` is None: `fn` runs inline on the caller's thread —
      supervision off, byte-for-byte the unsupervised code path.
    """
    if deadline is None:
        return fn()
    budget = deadline.budget_for_attempt(attempt)
    state = _Dispatch()
    # The caller's device and stream, which a new thread does not inherit.
    cuda = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        index = torch.cuda.current_device()
        cuda = (index, torch.cuda.current_stream(index))

    def worker() -> None:
        try:
            if cuda is not None:
                torch.cuda.set_device(cuda[0])
                with torch.cuda.stream(cuda[1]):
                    result = supervised()
            else:
                result = supervised()
            error = None
        except BaseException as exc:  # noqa: BLE001 — reported to caller
            result, error = None, exc
        with state.lock:
            if state.expired:
                # The caller already raised EngineStall for this
                # dispatch; a late result must not be half-published.
                return
            state.result, state.error = result, error
            # set() under the SAME lock as the publish: outside it, the
            # caller could time out between the publish and the set,
            # latch expired, and raise EngineStall for a dispatch whose
            # result was already complete — a burned retry.
            state.done.set()

    def supervised():
        # Test-only hang simulation (inert in production — one `is None`
        # check): sleeps HERE, on the worker, before the launch, so the
        # caller's deadline machinery sees a real missed heartbeat.
        faults.maybe_stall_dispatch()
        if state.expired:
            # Abandoned before it launched anything: launch nothing, so
            # the card's queue and its launch counts hold only the retry.
            return None
        return fn()

    # Contextvars do NOT flow into a bare Thread: copy the caller's
    # context so records emitted from the worker (fault hooks, engine
    # log_events) carry the caller's telemetry run/span identity.
    ctx = contextvars.copy_context()
    thread = threading.Thread(
        target=lambda: ctx.run(worker),
        name=f"yuma-watchdog-{label or 'dispatch'}",
        daemon=True,
    )
    thread.start()
    if not state.done.wait(budget):
        with state.lock:
            if not state.done.is_set():
                state.expired = True
        if state.expired:
            get_registry().counter(
                "stalls_killed", help="watchdog deadline kills"
            ).inc()
            log_event(
                logger,
                "engine_stalled",
                label=label,
                budget_s=f"{budget:.3f}",
                attempt=attempt,
            )
            raise EngineStall(
                f"dispatch {label or '<unnamed>'!s} exceeded its "
                f"{budget:.3f}s deadline (attempt {attempt}); the worker "
                "was abandoned",
                budget_seconds=budget,
            )
        # Lost the race: the worker posted between wait() timing out and
        # the lock — take the result, it arrived within epsilon of the
        # budget.
    if state.error is not None:
        raise state.error
    return state.result  # type: ignore[return-value]


def block_until_ready(tree):
    """Wait until the card has finished the work that produces `tree`'s CUDA
    tensors (nested dicts, lists, tuples and dataclass-free leaves), by
    synchronizing the current stream of each device they live on; returns
    `tree`. The counterpart of `jax.block_until_ready`, for a supervised
    dispatch whose failure must surface inside the ladder's try and whose
    time must count against its deadline. CPU tensors need no wait."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dataclass_fields__"):
            for name in x.__dataclass_fields__:
                walk(getattr(x, name))

    walk(tree)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return tree
