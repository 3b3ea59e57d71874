"""Host-side runtime support: serving telemetry, and the trainer's
restart supervisor and straggler monitor (``runtime.fault``). The
reference's elastic restore (``elastic_restore``, ``divisor_meshes``)
comes with distributed training (ROADMAP queue A item 13)."""
from .fault import FaultInjection, StragglerMonitor, TrainSupervisor
from .telemetry import (Counter, Gauge, Histogram, MetricsRegistry,
                        MetricsSnapshotter, NullTracer, Tracer,
                        default_registry, make_tracer, metric_attr,
                        percentile)

__all__ = ["FaultInjection", "StragglerMonitor", "TrainSupervisor",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsSnapshotter", "NullTracer", "Tracer",
           "default_registry", "make_tracer", "metric_attr", "percentile"]
