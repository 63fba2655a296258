"""Observability: the flight recorder of the single-stream fused run and
of the store (see telemetry.py)."""
from repro_torch.obs.telemetry import (StoreTelemetry, TEL_KEYS, Telemetry,
                                       telemetry_ref)

__all__ = ["StoreTelemetry", "Telemetry", "TEL_KEYS", "telemetry_ref"]
