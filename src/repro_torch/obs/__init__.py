from repro_torch.obs import lockdebug  # noqa: F401
from repro_torch.obs.lockdebug import LockOrderError, make_lock  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, flat_name, get_registry)
from repro_torch.obs.tracing import (REPORT_STAGES, STAGES,  # noqa: F401
                                     Span, Tracer, ViewTrace)
from repro_torch.obs.exposition import (  # noqa: F401
    MetricsServer, StatsReporter, snapshot_json, to_prometheus)
