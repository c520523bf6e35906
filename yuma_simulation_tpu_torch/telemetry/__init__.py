"""Telemetry of the port: so far the analytic HBM preflight (:mod:`.cost`)."""
