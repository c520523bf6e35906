"""The HTTP adapter: stdlib `http.server` over :class:`.service
.SimulationService`, plus the matching stdlib client.

Deliberately dependency-free (the stdlib server means the CPU tests
exercise the full serving stack with nothing installed).
`ThreadingHTTPServer` gives one thread per connection — the service core is thread-safe and does the real
bounding, so the transport stays dumb:

- ``POST /v1/simulate`` / ``POST /v1/sweep`` / ``POST /v1/table`` —
  JSON request -> :meth:`..serve.service.SimulationService.handle`;
- ``GET /healthz`` — liveness + queue/breaker/SLO burn state (JSON);
- ``GET /metrics`` — the process metrics registry in Prometheus text
  exposition;
- ``GET /debug/vars`` — the live ops snapshot
  (:meth:`..telemetry.ops.OpsPlane.debug_vars`): metrics + SLO burn
  state + dispatch sketches + recent structured events + profiler and
  segment status;
- ``GET /debug/spans?run=RUN_ID`` — one run's span tree stitched from
  the sealed bundle plus the live run context (defaults to the
  service's own run);
- ``GET /debug/incidents`` — durable correlated-incident state from
  the bundle's ``incidents.jsonl`` (empty list on a clean host);
- ``POST /debug/profile`` — ``{"seconds": N, "mode": "trace"}`` kicks
  one guarded on-demand ``torch.profiler`` window (single-flight; a
  concurrent request gets a typed 409, the artifact registers into the
  flight bundle).

Every response this layer produces is typed JSON (or Prometheus text):
a malformed body is a structured 400, an unknown route a structured
404, and the service's own contract covers the rest — no bare 500s.

Distributed-trace identity: EVERY response — rejections
included — carries ``X-Request-Id``; an inbound ``traceparent`` (+
``baggage``) header joins the caller's trace so the request's span
tree roots under the caller's span
(:mod:`..telemetry.propagation`), and dispatched requests return a
``Server-Timing`` header with the critical-path breakdown (queue /
coalesce / compile / execute). :class:`SimulationClient` generates a
traceparent per call and surfaces the echoed id on
:class:`ServeResponse` so user-side retries are correlatable.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from yuma_simulation_tpu_torch.serve.service import ServeConfig, SimulationService

logger = logging.getLogger(__name__)

#: POST routes -> request kinds the service understands.
_ROUTES = {
    "/v1/simulate": "simulate",
    "/v1/sweep": "sweep",
    "/v1/table": "table",
    "/v1/whatif": "whatif",
}

#: Largest accepted request body (bytes): bounds a hostile
#: Content-Length before any array parsing happens.
MAX_BODY_BYTES = 256 * 1024 * 1024


class _Handler(BaseHTTPRequestHandler):
    server_version = "yuma-serve"
    protocol_version = "HTTP/1.1"

    # Set per server class (see _make_handler).
    service: SimulationService

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        logger.debug("http: " + format, *args)

    def _send_json(
        self, status: int, body: dict, headers: Optional[dict] = None
    ) -> None:
        payload = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        merged = dict(headers or {})
        # EVERY response carries the request's identity — rejections
        # included — so a client-side retry loop is correlatable.
        if getattr(self, "_rid", None) and "X-Request-Id" not in merged:
            merged["X-Request-Id"] = self._rid
        for k, v in merged.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802 — http.server API
        self._rid = self.service.mint_request_id()
        try:
            if self.path == "/healthz":
                self._send_json(200, self.service.healthz())
            elif self.path == "/debug/vars":
                # Pure reads under short locks — answering during load
                # never blocks the dispatcher.
                self._send_json(200, self.service.ops.debug_vars())
            elif self.path == "/debug/incidents":
                self._send_json(200, self.service.ops.debug_incidents())
            elif self.path.startswith("/debug/spans"):
                import urllib.parse

                query = urllib.parse.urlparse(self.path).query
                run_id = urllib.parse.parse_qs(query).get("run", [""])[0]
                try:
                    self._send_json(
                        200, self.service.ops.debug_spans(run_id or None)
                    )
                except ValueError as exc:
                    self._send_json(
                        400,
                        {"status": "rejected", "error": "InvalidRequest",
                         "message": str(exc)[:200]},
                    )
            elif self.path == "/v1/replay" or self.path.startswith(
                "/v1/replay/"
            ):
                status, body = self.service.replay_get(self.path)
                self._send_json(status, body)
            elif self.path == "/metrics":
                text = self.service.metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(text)))
                self.send_header("X-Request-Id", self._rid)
                self.end_headers()
                self.wfile.write(text)
            else:
                self._send_json(
                    404,
                    {"status": "rejected", "error": "NotFound",
                     "message": f"no route {self.path!r}"},
                )
        except BrokenPipeError:  # client went away; nothing to answer
            pass

    def _do_debug_profile(self) -> None:
        """POST /debug/profile — outside the admission pipeline (an
        operator action, not tenant traffic): the ops plane's
        single-flight latch is the only gate, a concurrent window is a
        typed 409."""
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = 0
        raw = self.rfile.read(max(0, min(length, MAX_BODY_BYTES)))
        try:
            payload = json.loads(raw.decode() or "{}")
        except (ValueError, UnicodeDecodeError) as exc:
            self._send_json(
                400,
                {"status": "rejected", "error": "InvalidJSON",
                 "message": str(exc)[:200]},
            )
            return
        from yuma_simulation_tpu_torch.telemetry.ops import ProfileBusyError

        try:
            started = self.service.ops.debug_profile(
                float(payload.get("seconds", 5.0)),
                mode=str(payload.get("mode", "trace")),
            )
        except ProfileBusyError as exc:
            self._send_json(
                409,
                {"status": "busy", "error": "ProfileBusy",
                 "message": str(exc), "active": exc.status},
            )
            return
        except (TypeError, ValueError) as exc:
            self._send_json(
                400,
                {"status": "rejected", "error": "InvalidRequest",
                 "message": str(exc)[:200]},
            )
            return
        self._send_json(200, {"status": "ok", "profile": started})

    def do_POST(self) -> None:  # noqa: N802 — http.server API
        self._rid = self.service.mint_request_id()
        try:
            if self.path == "/debug/profile":
                self._do_debug_profile()
                return
            kind = _ROUTES.get(self.path)
            if kind is None:
                # Responding BEFORE reading the body on a keep-alive
                # connection would leave the unread bytes to be parsed
                # as the next request line — close instead.
                self.close_connection = True
                self._send_json(
                    404,
                    {"status": "rejected", "error": "NotFound",
                     "message": f"no route {self.path!r}"},
                )
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = -1
            if length < 0 or length > MAX_BODY_BYTES:
                self.close_connection = True  # body unread; see above
                self._send_json(
                    413,
                    {"status": "rejected", "error": "PayloadTooLarge",
                     "message": f"body must be 0..{MAX_BODY_BYTES} bytes"},
                )
                return
            raw = self.rfile.read(length)
            try:
                payload = json.loads(raw.decode() or "{}")
            except (ValueError, UnicodeDecodeError) as exc:
                self._send_json(
                    400,
                    {"status": "rejected", "error": "InvalidJSON",
                     "message": str(exc)[:200]},
                )
                return
            from yuma_simulation_tpu_torch.telemetry.propagation import (
                BAGGAGE_HEADER,
                TRACEPARENT_HEADER,
                TraceContext,
            )

            trace = TraceContext.from_traceparent(
                self.headers.get(TRACEPARENT_HEADER),
                self.headers.get(BAGGAGE_HEADER),
            )
            status, body, headers = self.service.handle(
                kind,
                payload,
                request_id=self._rid,
                trace=trace,
                api_key=self.headers.get("X-Api-Key"),
            )
            self._send_json(status, body, headers)
        except BrokenPipeError:
            pass


def _make_handler(service: SimulationService) -> type:
    return type("BoundHandler", (_Handler,), {"service": service})


class SimulationServer:
    """The long-lived HTTP front: owns (or wraps) a
    :class:`SimulationService` and serves it on a background thread.
    `port=0` binds an ephemeral port (tests/smoke); :attr:`port` is the
    bound one. `close()` stops the listener THEN drains the service —
    in-flight requests finish, queued ones get the structured
    shutting-down response, the flight bundle publishes."""

    def __init__(
        self,
        config: Optional[ServeConfig] = None,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        service: Optional[SimulationService] = None,
    ):
        self.service = (
            service if service is not None else SimulationService(config)
        )
        self._httpd = ThreadingHTTPServer(
            (host, port), _make_handler(self.service)
        )
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "SimulationServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="yuma-serve-http",
            daemon=True,
        )
        self._thread.start()
        logger.info("serving on %s", self.url)
        return self

    def serve_forever(self) -> None:
        """Foreground mode (the CLI): serve until interrupted."""
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:  # pragma: no cover — interactive
            pass
        finally:
            self.close()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self.service.close()


@dataclass
class ServeResponse:
    """One client-side result: HTTP status + parsed JSON body (+ the
    Retry-After header, parsed, when the server sent one), plus the
    correlation identity — the server-echoed ``X-Request-Id`` and the
    ``traceparent`` this call sent, so a user-side retry loop can tie
    every attempt to its server-side request span."""

    status: int
    body: dict
    retry_after: Optional[float] = None
    headers: dict = field(default_factory=dict)
    #: the traceparent header value this call sent (one per call).
    traceparent: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == 200 and self.body.get("status") in (
            "ok",
            "partial",
        )

    @property
    def request_id(self) -> Optional[str]:
        """The server's ``X-Request-Id`` echo (header first, body
        fallback) — the join key into the server's flight bundle."""
        return self.headers.get("X-Request-Id") or self.body.get(
            "request_id"
        )

    @property
    def server_timing(self) -> dict:
        """The ``Server-Timing`` critical-path breakdown as
        ``{phase: milliseconds}`` (empty when the server sent none)."""
        out: dict = {}
        raw = self.headers.get("Server-Timing", "")
        for item in raw.split(","):
            item = item.strip()
            if not item:
                continue
            name, _, params = item.partition(";")
            for p in params.split(";"):
                k, _, v = p.partition("=")
                if k.strip() == "dur":
                    try:
                        out[name.strip()] = float(v)
                    except ValueError:
                        pass
        return out


#: HTTP statuses the client's bounded retry loop treats as transient
#: (the server said "come back": quota shed / draining / overloaded).
_RETRYABLE_STATUSES = (429, 503)


class SimulationClient:
    """Stdlib client for the serving tier (the v1 helper): JSON over
    urllib, typed :class:`ServeResponse` back — 4xx/5xx are RETURNED
    (the server's typed bodies are the contract), never raised; only
    transport-level failures raise.

    **Bounded retry-with-backoff** (``retries`` > 0): transport-level
    connection resets/refusals and transient HTTP statuses (429/503)
    are retried up to ``retries`` extra attempts with exponential
    backoff — a server-sent ``Retry-After`` overrides the computed
    backoff (capped at ``max_backoff_seconds``), and every attempt
    re-sends the SAME ``traceparent``, so the server-side spans of all
    attempts stitch into one caller trace. When the budget is spent:
    a transport-level failure raises the typed
    :class:`..resilience.errors.ClientRetriesExhausted`; a transient
    HTTP response is RETURNED (its typed body is the contract and must
    reach the caller). ``retries=0`` (default) preserves the legacy
    single-shot behavior — callers who assert on raw 429s (quota
    tests, the smoke drill) see every response.

    ``api_key`` (see :mod:`.apikeys`) rides every request as
    ``X-Api-Key`` against deployments with signed tenant identity."""

    def __init__(
        self,
        base_url: str,
        *,
        tenant: str = "default",
        timeout: float = 120.0,
        retries: int = 0,
        backoff_base: float = 0.1,
        max_backoff_seconds: float = 5.0,
        api_key: Optional[str] = None,
    ):
        if retries < 0:
            raise ValueError("retries must be >= 0")
        self.base_url = base_url.rstrip("/")
        self.tenant = tenant
        self.timeout = timeout
        self.retries = int(retries)
        self.backoff_base = float(backoff_base)
        self.max_backoff_seconds = float(max_backoff_seconds)
        self.api_key = api_key

    def _trace_headers(self) -> dict:
        """One traceparent per call: the caller's active run + innermost
        span when one exists (so the server's request span tree roots
        under the CALLER's trace), else a fresh client-run identity —
        either way the server can be asked "what did my call do"."""
        from yuma_simulation_tpu_torch.telemetry.propagation import (
            BAGGAGE_HEADER,
            TRACEPARENT_HEADER,
            TraceContext,
            current_trace_context,
        )
        from yuma_simulation_tpu_torch.telemetry.runctx import new_run_id

        ctx = current_trace_context()
        if ctx is None:
            ctx = TraceContext(run_id=new_run_id())
        ctx = ctx.with_baggage(tenant=self.tenant)
        return {
            TRACEPARENT_HEADER: ctx.to_traceparent(),
            BAGGAGE_HEADER: ctx.to_baggage(),
        }

    def _request(
        self, method: str, path: str, payload: Optional[dict] = None
    ) -> ServeResponse:
        url = self.base_url + path
        data = None
        # One trace identity for the WHOLE retry loop: every attempt
        # re-sends the same traceparent, so the server-side request
        # spans of attempt 1..N stitch into one caller trace instead of
        # N unrelated ones.
        headers = {"Accept": "application/json"}
        headers.update(self._trace_headers())
        if self.api_key is not None:
            headers["X-Api-Key"] = self.api_key
        if payload is not None:
            data = json.dumps(payload).encode()
            headers["Content-Type"] = "application/json"
        last_exc: Optional[Exception] = None
        response: Optional[ServeResponse] = None
        for attempt in range(self.retries + 1):
            if attempt:
                wait = min(
                    self.max_backoff_seconds,
                    self.backoff_base * (2.0 ** (attempt - 1)),
                )
                # The server's own Retry-After is the honest backoff:
                # honor it (still capped — a hostile or confused server
                # must not park the client for an hour).
                if response is not None and response.retry_after:
                    wait = min(
                        self.max_backoff_seconds, response.retry_after
                    )
                time.sleep(wait)
            req = urllib.request.Request(
                url, data=data, headers=headers, method=method
            )
            try:
                try:
                    with urllib.request.urlopen(
                        req, timeout=self.timeout
                    ) as resp:
                        raw = resp.read()
                        status = resp.status
                        hdrs = dict(resp.headers.items())
                except urllib.error.HTTPError as err:
                    raw = err.read()
                    status = err.code
                    hdrs = dict(err.headers.items()) if err.headers else {}
            except (urllib.error.URLError, ConnectionError, OSError) as exc:
                # Transport-level failure (connection refused/reset,
                # unreachable): retryable while budget remains.
                last_exc = exc
                response = None
                continue
            try:
                body = json.loads(raw.decode() or "{}")
            except ValueError:
                body = {
                    "status": "error",
                    "raw": raw.decode(errors="replace"),
                }
            retry_after = None
            if "Retry-After" in hdrs:
                try:
                    retry_after = float(hdrs["Retry-After"])
                except ValueError:
                    pass
            response = ServeResponse(
                status=status,
                body=body,
                retry_after=retry_after,
                headers=hdrs,
                traceparent=headers.get("traceparent"),
            )
            if status not in _RETRYABLE_STATUSES:
                return response
            # 429/503: transient by contract; fall through to retry.
        if response is not None:
            # Budget spent on transient HTTP statuses: the server's
            # typed body is the contract — return the last one.
            return response
        from yuma_simulation_tpu_torch.resilience.errors import (
            ClientRetriesExhausted,
        )

        raise ClientRetriesExhausted(
            f"{method} {url} failed after {self.retries + 1} attempt(s): "
            f"{last_exc}",
            attempts=self.retries + 1,
            last_error=last_exc,
        )

    def _post(self, path: str, payload: dict) -> ServeResponse:
        payload = dict(payload)
        payload.setdefault("tenant", self.tenant)
        return self._request("POST", path, payload)

    def simulate(self, **payload) -> ServeResponse:
        """POST /v1/simulate — `case=` (a registered case name) or
        `weights=`/`stakes=` arrays, plus `version`, `config`,
        `deadline_seconds`, `engine`, `quarantine` knobs."""
        return self._post("/v1/simulate", payload)

    def sweep(self, **payload) -> ServeResponse:
        """POST /v1/sweep — a scenario plus `axes={field: [values]}`."""
        return self._post("/v1/sweep", payload)

    def table(self, **payload) -> ServeResponse:
        """POST /v1/table — the total-dividends CSV across versions."""
        return self._post("/v1/table", payload)

    def whatif(self, spec: dict, **payload) -> ServeResponse:
        """POST /v1/whatif — `spec` is the
        :class:`..replay.whatif.WhatIfSpec` JSON object (``netuid``,
        ``version``, ``from_epoch``, ``hparams``/``weight_rows``/
        ``stake_scale``); returns per-validator/per-miner dividend
        deltas plus the suffix-resume accounting."""
        return self._post("/v1/whatif", {**payload, "whatif": spec})

    def replay(self, netuid: Optional[int] = None) -> ServeResponse:
        """GET /v1/replay (the archive index) or /v1/replay/NETUID
        (one subnet's timeline + cached baselines)."""
        path = "/v1/replay" if netuid is None else f"/v1/replay/{netuid}"
        return self._request("GET", path)

    def healthz(self) -> ServeResponse:
        return self._request("GET", "/healthz")

    def debug_vars(self) -> ServeResponse:
        """GET /debug/vars — the live ops snapshot."""
        return self._request("GET", "/debug/vars")

    def debug_incidents(self) -> ServeResponse:
        """GET /debug/incidents — durable incident state (postmortems
        live in ``tools/incidentreport.py``; this is the live view)."""
        return self._request("GET", "/debug/incidents")

    def debug_spans(self, run_id: Optional[str] = None) -> ServeResponse:
        """GET /debug/spans[?run=RUN_ID] — one run's live span tree."""
        path = "/debug/spans"
        if run_id:
            import urllib.parse

            path += "?run=" + urllib.parse.quote(run_id)
        return self._request("GET", path)

    def debug_profile(
        self, seconds: float = 5.0, mode: str = "trace"
    ) -> ServeResponse:
        """POST /debug/profile — kick one on-demand profiler window."""
        return self._post(
            "/debug/profile", {"seconds": seconds, "mode": mode}
        )

    def metrics(self) -> str:
        url = self.base_url + "/metrics"
        with urllib.request.urlopen(url, timeout=self.timeout) as resp:
            return resp.read().decode()


def wait_until_ready(
    url: str, *, timeout: float = 10.0, interval: float = 0.05
) -> bool:
    """Poll `/healthz` until the server answers (startup rendezvous for
    tests and the smoke lane)."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(
                url.rstrip("/") + "/healthz", timeout=interval + 1.0
            ):
                return True
        except (urllib.error.URLError, socket.timeout, ConnectionError):
            time.sleep(interval)
    return False
