"""``repro_torch.serve``: the serving front door over the port's engine.

Not to be confused with ``repro_torch.launch.serve`` (the LM decode
loop): this package is the RDF query serving layer -- admission
control, load shedding, deadlines, circuit breaking, and shape-keyed
micro-batching over any ``Engine``-protocol backend, as the JAX
package's ``repro.serve`` (``docs/serving.md``).

Quick use::

    session = Session(plan, backend="spmd")          # on the card
    with session.serve(max_batch=16, max_delay_ms=2.0) as door:
        fut = door.submit(query, deadline_s=1.0)
        result = fut.result()

``python -m repro_torch.serve --smoke`` runs the seeded open-loop
smoke: parity through the door, the span chain, a capacity sweep and
snapshot validation, written as a ``repro.bench/v1`` record.
"""
from .batcher import Batch, ShapeBatcher, shape_key
from .frontdoor import (BreakerOpenError, CircuitBreaker,
                        DeadlineExceededError, FrontDoor, FrontDoorConfig,
                        QueueFullError, ServeFuture, ShedError)
from .loadgen import (LoadgenReport, arrival_offsets, measure_capacity,
                      run_open_loop)

__all__ = [
    "Batch", "ShapeBatcher", "shape_key",
    "FrontDoor", "FrontDoorConfig", "CircuitBreaker", "ServeFuture",
    "ShedError", "QueueFullError", "BreakerOpenError",
    "DeadlineExceededError",
    "LoadgenReport", "arrival_offsets", "run_open_loop",
    "measure_capacity",
]
