from progen_tpu_torch.observe.flops import (
    H100_PEAK_BF16_FLOPS,
    mfu,
    model_flops_per_token,
)
from progen_tpu_torch.observe.meter import ThroughputMeter, profile_trace
from progen_tpu_torch.observe.metrics import (
    LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    labeled,
    latency_buckets,
    latency_percentiles,
    merge_snapshots,
    split_labeled,
)
from progen_tpu_torch.observe.statusz import StatuszServer, render_prometheus
from progen_tpu_torch.observe.trace import (
    Tracer,
    chrome_trace,
    configure_tracing,
    get_tracer,
    merge_trace_dir,
    spans_for,
    trace_dump_path,
)
from progen_tpu_torch.observe.tracker import Tracker

__all__ = [
    "H100_PEAK_BF16_FLOPS", "ThroughputMeter", "Tracker", "mfu",
    "model_flops_per_token", "profile_trace",
    # tracing (observe/trace.py)
    "Tracer", "chrome_trace", "configure_tracing", "get_tracer", "merge_trace_dir",
    "spans_for", "trace_dump_path",
    # metrics (observe/metrics.py)
    "LATENCY_BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "labeled", "latency_buckets", "latency_percentiles",
    "merge_snapshots", "split_labeled",
    # live introspection (observe/statusz.py)
    "StatuszServer", "render_prometheus",
]
