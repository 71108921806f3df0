"""Host utilities of the port (telemetry)."""
