"""Search telemetry (counterpart of ``repro.obs.telemetry``)."""
