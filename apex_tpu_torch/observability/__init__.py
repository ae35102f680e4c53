"""Observability of the port (counterpart of
:mod:`apex_tpu.observability`): the host metrics registry with MFU and
the heartbeat (:mod:`.metrics`), the flight recorder's run timeline
(:mod:`.timeline`) and its goodput report (:mod:`.goodput`), the
crash-safe JSONL writers (:mod:`.writers`), the longitudinal metric
history (:mod:`.timeseries`) and its SLO burn-rate alerts (:mod:`.slo`),
the fleet's distributed traces (:mod:`.trace`) and the live debug
endpoint (:mod:`.debug_server`).

The serving engine records into a :class:`MetricRegistry` and, when a
recorder is armed, logs every request's lifecycle to the timeline.  The
spans (:mod:`.spans`: ``span``, ``named_span``, ``step_trace`` and
``TraceWindow``, over ``torch.profiler``) time the checkpoint layer and
the input pipeline's stall.  The training statistics (:mod:`.trainstats`:
:class:`TrainStats`, its rank-partial form and the every-``n`` logger)
ride the 3D GPT step (``build_gpt_3d``'s ``collect_stats``).
``compiled_flops`` has no counterpart, since eager PyTorch compiles no
program whose cost analysis it could read.
"""

from apex_tpu_torch.observability.debug_server import (
    DebugServer,
    render_openmetrics,
)
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
from apex_tpu_torch.observability.slo import SLOEvaluator, SLOPolicy
from apex_tpu_torch.observability.spans import (
    TraceWindow,
    named_span,
    span,
    step_trace,
)
from apex_tpu_torch.observability.timeline import FlightRecorder
from apex_tpu_torch.observability.timeseries import MetricHistory, match_series
from apex_tpu_torch.observability.trace import (
    TRACE_HOP_BUCKETS,
    collect_slo_events,
    estimate_offset,
    format_trace_report,
    merge_dir,
    stitch_traces,
    summarize_traces,
)
from apex_tpu_torch.observability.trainstats import (
    PartialTrainStats,
    TrainStats,
    TrainStatsLogger,
    device_partial_norms,
    local_grad_stats,
    pack_local_stats,
    partial_train_stats,
    stats_from_reduced,
    stats_partition_specs,
    train_stats,
)
from apex_tpu_torch.observability.writers import (
    JsonlWriter,
    iter_jsonl,
    read_jsonl,
)

__all__ = [
    "named_span",
    "span",
    "step_trace",
    "TraceWindow",
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
    "JsonlWriter",
    "read_jsonl",
    "iter_jsonl",
    "DebugServer",
    "render_openmetrics",
    "TRACE_HOP_BUCKETS",
    "estimate_offset",
    "stitch_traces",
    "summarize_traces",
    "merge_dir",
    "format_trace_report",
    "collect_slo_events",
    "MetricHistory",
    "match_series",
    "SLOPolicy",
    "SLOEvaluator",
    "TrainStats",
    "PartialTrainStats",
    "train_stats",
    "partial_train_stats",
    "device_partial_norms",
    "local_grad_stats",
    "pack_local_stats",
    "stats_from_reduced",
    "stats_partition_specs",
    "TrainStatsLogger",
]
