"""Validation harness: trace capture and state-by-state comparison
(float32 on the device against float64 on the CPU, or the port against
another engine through the engine-agnostic `Trace` record)."""
from dartenv_tpu_torch.validation.trace import (  # noqa: F401
    Trace, capture_trace, compare_traces, self_consistency_report,
)
