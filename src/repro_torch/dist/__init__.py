"""repro_torch.dist — the serving engine's fault-tolerance primitives and
int8 gradient compression (the twin of ``repro.dist`` without its
JAX-mesh pieces: ``elastic_remesh``, ``sharding``)."""
from .compression import dequantize_int8, quantize_int8
from .fault_tolerance import (FailureInjector, HeartbeatMonitor, RetryPolicy,
                              SimulatedPodFailure)

__all__ = ["quantize_int8", "dequantize_int8", "FailureInjector",
           "HeartbeatMonitor", "RetryPolicy", "SimulatedPodFailure"]
