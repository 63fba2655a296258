"""Observability: the flight recorder of the fused runs and of the store
(telemetry.py), and the host-side dispatch tracer over the port's
engines (trace.py, run.py; ``python -m repro_torch.obs``)."""
from repro_torch.obs.telemetry import (StoreTelemetry, TEL_KEYS, Telemetry,
                                       telemetry_ref)
from repro_torch.obs.trace import traceable_engine_names, validate_chrome_trace

__all__ = ["StoreTelemetry", "Telemetry", "TEL_KEYS", "telemetry_ref",
           "traceable_engine_names", "validate_chrome_trace"]
