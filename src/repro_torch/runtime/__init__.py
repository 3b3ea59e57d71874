"""Host-side runtime support: serving telemetry, the trainer's restart
supervisor and straggler monitor (``runtime.fault``), and the elastic
restore of a checkpoint onto another mesh (``runtime.elastic``)."""
from .fault import FaultInjection, StragglerMonitor, TrainSupervisor
from .elastic import elastic_restore, divisor_meshes
from .telemetry import (Counter, Gauge, Histogram, MetricsRegistry,
                        MetricsSnapshotter, NullTracer, Tracer,
                        default_registry, make_tracer, metric_attr,
                        percentile)

__all__ = ["FaultInjection", "StragglerMonitor", "TrainSupervisor",
           "elastic_restore", "divisor_meshes",
           "Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsSnapshotter", "NullTracer", "Tracer",
           "default_registry", "make_tracer", "metric_attr", "percentile"]
