"""repro_torch.core — DeLIA-style dependability for iterative PyTorch
applications (interruption detection + data preservation + fail-stop
recovery around BSP supersteps), and the serving fault injector."""
from repro_torch.core.api import Dependability, DependabilityConfig
from repro_torch.core.checkpoint import CheckpointManager, SaveStats
from repro_torch.core.codec import CODECS, DeviceCodec, Int8BlockCodec
from repro_torch.core.coordinator import run_bsp, run_with_recovery
from repro_torch.core.failures import (CorruptionDetected, FaultInjector,
                                       SimulatedFailure, StragglerWatchdog)
from repro_torch.core.heartbeat import HeartbeatEmitter, HeartbeatMonitor
from repro_torch.core.io_engine import ShardIOEngine, crc32_array, write_npy
from repro_torch.core.policy import (CheckpointPolicy, SystemModel,
                                     young_daly_period)
from repro_torch.core.signals import TerminationSignal

__all__ = ["Dependability", "DependabilityConfig", "CheckpointManager",
           "SaveStats", "CODECS", "DeviceCodec", "Int8BlockCodec",
           "run_bsp", "run_with_recovery", "CorruptionDetected",
           "FaultInjector", "SimulatedFailure", "StragglerWatchdog",
           "HeartbeatEmitter", "HeartbeatMonitor", "ShardIOEngine",
           "crc32_array", "write_npy", "CheckpointPolicy", "SystemModel",
           "young_daly_period", "TerminationSignal"]
