"""Observability of the port (counterpart of
:mod:`apex_tpu.observability`): the host metrics registry with MFU and
the heartbeat (:mod:`.metrics`), the flight recorder's run timeline
(:mod:`.timeline`) and its goodput report (:mod:`.goodput`).

The serving engine records into a :class:`MetricRegistry` and, when a
recorder is armed, logs every request's lifecycle to the timeline.  The
rest of the reference package (the debug server, SLOs, spans, traces,
training stats, time series and the JSONL writers) is not ported yet
(ROADMAP.md, section A.3); ``compiled_flops`` has no counterpart, since
eager PyTorch compiles no program whose cost analysis it could read.
"""

from apex_tpu_torch.observability.goodput import (
    format_report,
    goodput_report,
    serving_goodput_report,
)
from apex_tpu_torch.observability.metrics import (
    HeartbeatMonitor,
    MetricRegistry,
    default_registry,
    is_host_local,
    mfu,
    mfu_or_reason,
    peak_flops_for,
    peak_flops_reason,
)
from apex_tpu_torch.observability.timeline import FlightRecorder

__all__ = [
    "MetricRegistry",
    "default_registry",
    "is_host_local",
    "HeartbeatMonitor",
    "peak_flops_for",
    "peak_flops_reason",
    "mfu",
    "mfu_or_reason",
    "FlightRecorder",
    "goodput_report",
    "serving_goodput_report",
    "format_report",
]
