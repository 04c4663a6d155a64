"""Host-side dependability core the serving slice needs: UDP heartbeats
and the serving fault injector."""
from repro_torch.core.failures import (CorruptionDetected, FaultInjector,
                                       SimulatedFailure)
from repro_torch.core.heartbeat import HeartbeatEmitter, HeartbeatMonitor

__all__ = ["CorruptionDetected", "FaultInjector", "SimulatedFailure",
           "HeartbeatEmitter", "HeartbeatMonitor"]
