"""repro.obs — lightweight structured telemetry for the DSE stack.

Spans, counters, and gauges emitted as plain JSONL; near-zero overhead
when disabled (:data:`~repro.obs.trace.NULL`); process-safe via
per-worker sidecar files merged deterministically by the campaign
parent; exportable to Chrome trace-event format. See
:mod:`repro.obs.trace` for the full design and
``docs/observability.md`` for the user-facing walkthrough.
"""
from .trace import (EVENT_KINDS, EVENTS_SCHEMA_VERSION, NULL, NullTracer,
                    SpanStats, Tracer, campaign_wall, chrome_path_for,
                    chrome_trace, counter_totals, events_dir_for,
                    events_path_for, load_events, merge_events,
                    slowest_spans, span_totals, spans, validate_events,
                    worker_tracer, worker_utilization)

__all__ = [
    "EVENT_KINDS", "EVENTS_SCHEMA_VERSION", "NULL", "NullTracer",
    "SpanStats", "Tracer", "campaign_wall", "chrome_path_for",
    "chrome_trace", "counter_totals", "events_dir_for", "events_path_for",
    "load_events", "merge_events", "slowest_spans", "span_totals", "spans",
    "validate_events", "worker_tracer", "worker_utilization",
]
