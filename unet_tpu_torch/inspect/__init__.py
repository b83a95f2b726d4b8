"""Inspection decisions of the port (counterpart of unet_tpu/inspect):
window aggregation and OK/NG rules, the simple metrics decision, the
wrap-uniformity monitor, the event detector and gate, the defect tracker and
the frame quality gate with its statistics (`quality_stats`), which the
step computes on the device (`pipeline.stages.quality_stats`)."""
from unet_tpu_torch.inspect.window import (  # noqa: F401
    FrameResult, WindowStatistics, WindowAggregator, ThresholdConfig,
    DecisionResult, make_decision)
from unet_tpu_torch.inspect.detectors import (  # noqa: F401
    FrameMetrics, EventConfig, EventDetector, EventGate, DefectTracker,
    FrameQualityGate, QualityResult, quality_stats, bbox_iou)
from unet_tpu_torch.inspect.decision import (  # noqa: F401
    Metrics, Finding, SimpleThresholds, compute_metrics, decide)
from unet_tpu_torch.inspect.uniformity import (  # noqa: F401
    WrapUniformityMonitor, measure_cable_tape_diameter_px)
