"""Host-side runtime support: serving telemetry, and the trainer's
restart supervisor and straggler monitor (``runtime.fault``)."""
