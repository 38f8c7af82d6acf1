from progen_tpu_torch.observe.flops import (
    H100_PEAK_BF16_FLOPS,
    PEAK_BF16_FLOPS,
    mfu,
    model_flops_per_token,
    peak_flops_per_chip,
)
from progen_tpu_torch.observe.gitinfo import git_sha
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
from progen_tpu_torch.observe.platform import emit_error_record, probe_backend, stamp_record
from progen_tpu_torch.observe.robustness import RobustnessCounters
from progen_tpu_torch.observe.slo import BurnRateTracker, SLOSpec
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
    # the peak behind MFU, by card name (JAX's PEAK_BF16_TFLOPS is by TPU kind)
    "PEAK_BF16_FLOPS", "peak_flops_per_chip",
    # record stamping and the card probe (observe/gitinfo.py, observe/platform.py)
    "RobustnessCounters", "emit_error_record", "git_sha", "probe_backend",
    "stamp_record",
    # tracing (observe/trace.py)
    "Tracer", "chrome_trace", "configure_tracing", "get_tracer", "merge_trace_dir",
    "spans_for", "trace_dump_path",
    # metrics (observe/metrics.py)
    "LATENCY_BUCKETS", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "get_registry", "labeled", "latency_buckets", "latency_percentiles",
    "merge_snapshots", "split_labeled",
    # live introspection (observe/statusz.py, observe/slo.py)
    "StatuszServer", "render_prometheus", "SLOSpec", "BurnRateTracker",
]
