"""Continuous-batching decode service under live routing drift.

    Request / RequestQueue   length-bucketed admission (queue.py)
    ContinuousBatcher        slot-based decode batch state (batcher.py)
    ServeEngine              per-request bucketed prefill, KV-aware
                             admission, one captured decode step under the
                             device controller, regime warm swaps (engine.py)
    ServeMetrics             serving telemetry (metrics.py)

Counterpart of ``repro/serve``.
"""

from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import ServeMetrics, percentiles
from repro_torch.serve.queue import Request, RequestQueue

__all__ = ["ContinuousBatcher", "Request", "RequestQueue", "ServeEngine", "ServeMetrics", "percentiles"]
