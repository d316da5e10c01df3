"""repro_torch.serve — the serving engine and the aggregate service (the
twin of ``repro.serve`` without its LM serving steps, ``serve/step.py``,
which wait for the port's model substrate).

* ``ServingEngine`` — bounded request queue, admission batching, one
  captured CUDA graph per (table, guarantee, bucket) on the card, the
  write-ahead update journal, supervision, deadlines and load shedding.
* ``AggregateService`` — one fitted table per (dataset, aggregate) behind
  a ``ServingEngine``: the paper's deployment scenario.
"""
from .aggregates import AggregateService
from .engine import (DeadlineExceeded, EngineStats, Overloaded, QueueFull,
                     ServingEngine)

__all__ = ["AggregateService", "ServingEngine", "QueueFull", "Overloaded",
           "DeadlineExceeded", "EngineStats"]
