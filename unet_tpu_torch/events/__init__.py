"""Event emission of the port (counterpart of unet_tpu/events):
JSONL/CSV/JSON/MQTT emitters, schema-compatible with the reference."""
from unet_tpu_torch.events.emitters import (  # noqa: F401
    EventManager, EventOutputConfig, InspectionEventLogger, AnomalyLogger,
    JSONLogger, StatisticsLogger, format_reasons_readable, CLASS_NAMES)
