"""Host-side runtime support: serving telemetry."""
