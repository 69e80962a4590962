"""``tpudp_torch.obs`` — structured telemetry, the port of ``tpudp.obs``.

  * Spans and events (:mod:`tpudp_torch.obs.record`): a preallocated
    monotonic-clock ring per engine or trainer; ``begin``/``end`` is the
    allocation-free hot-path API, ``span``/``event`` the allocating one.
  * Device counters: per-step scalars accumulated on the card inside the
    serving engine's step functions and fused windows
    (``tpudp_torch/serve/engine.py`` ``OBS_DEVICE_COUNTERS``), read only
    by ``Engine.metrics()``.
  * Flight recorder (:mod:`tpudp_torch.obs.flight`): the ring persisted
    as ``flightrec-*.json`` on watchdog timeouts, step-failure
    containment, canary quarantine, quarantined transfers and rollbacks.
  * Exposition (:mod:`tpudp_torch.obs.export`,
    :mod:`tpudp_torch.obs.metrics`): Chrome ``trace_event`` JSON, JSON
    snapshots and a Prometheus-style text endpoint.

With them the one timing surface: :class:`StepTimer`, the
``torch.profiler`` :func:`trace` and the reference's window lines
(:func:`reference_window_lines`).  Importing ``tpudp_torch.obs`` imports
no torch.
"""

from tpudp_torch.obs.export import (counters_from_chrome_trace,
                                    snapshot_json, spans_from_chrome_trace,
                                    to_chrome_trace)
from tpudp_torch.obs.flight import (FLIGHT_DIR_ENV, FlightRecorder,
                                    coordinated_merge, list_dumps,
                                    merge_dumps, resolve_flight_dir)
from tpudp_torch.obs.format import reference_window_lines
from tpudp_torch.obs.metrics import MetricsServer, prometheus_text
from tpudp_torch.obs.record import NO_SPAN, Recorder
from tpudp_torch.obs.timing import StepTimer
from tpudp_torch.obs.tracing import step_annotation, trace

__all__ = [
    "FLIGHT_DIR_ENV", "FlightRecorder", "MetricsServer", "NO_SPAN",
    "Recorder", "StepTimer", "coordinated_merge",
    "counters_from_chrome_trace", "list_dumps", "merge_dumps",
    "prometheus_text", "reference_window_lines", "resolve_flight_dir",
    "snapshot_json", "spans_from_chrome_trace", "step_annotation",
    "to_chrome_trace", "trace",
]
