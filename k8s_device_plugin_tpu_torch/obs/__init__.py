"""Observability for the port: copies of the reference's metrics,
tracing, request ledger, flight recorder, HTTP exposition and SLO
monitor, so ``/metrics`` shows the same ``tpu_serve_*`` families."""
