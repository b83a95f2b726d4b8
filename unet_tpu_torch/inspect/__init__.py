"""Inspection decisions of the port (counterpart of unet_tpu/inspect):
window aggregation and OK/NG rules, the simple metrics decision, the
wrap-uniformity monitor. The event detectors, gates, the defect tracker and
the frame quality gate are not ported yet (ROADMAP A6)."""
from unet_tpu_torch.inspect.window import (  # noqa: F401
    FrameResult, WindowStatistics, WindowAggregator, ThresholdConfig,
    DecisionResult, make_decision)
from unet_tpu_torch.inspect.decision import (  # noqa: F401
    Metrics, Finding, SimpleThresholds, compute_metrics, decide)
from unet_tpu_torch.inspect.uniformity import (  # noqa: F401
    WrapUniformityMonitor, measure_cable_tape_diameter_px)
