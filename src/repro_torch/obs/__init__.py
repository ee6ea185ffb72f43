"""Telemetry of the port: the metric registry and device-side metric dicts."""
