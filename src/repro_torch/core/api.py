"""The Dependability facade — the DeLIAP/DeLIAJ-style interface — over
PyTorch state (the reference's ``core/api.py``).

Mirrors the paper's library surface:
  register_global_state / register_local_state   (save-pointer registration)
  should_checkpoint / save / restore_latest      (data preservation)
  heartbeat monitoring + termination-signal detection (interruption
  detection), exposed through ``interrupted()``.

Typical BSP loop (see core/coordinator.py for the full runner)::

    dep = Dependability(DependabilityConfig(checkpoint_dir=...)).start()
    dep.register_local_state(data)
    for step in ...:
        if dep.interrupted():
            dep.save(step, state, final=True); break
        state, _ = train_step(state, batch)
        dep.observe_step(dt)
        if dep.should_checkpoint(step):
            dep.save(step, state)

Not in the port yet, and refused rather than ignored: delta checkpoints
and the tier-2 scrubber (ROADMAP item 5), telemetry (``attach_obs``,
item 8), restores onto other shardings (item 10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.checkpoint import CheckpointManager, SaveStats
from repro_torch.core.failures import CorruptionDetected, StragglerWatchdog
from repro_torch.core.heartbeat import HeartbeatEmitter, HeartbeatMonitor
from repro_torch.core.policy import CheckpointPolicy, SystemModel
from repro_torch.core.signals import TerminationSignal
from repro_torch.sdc.sentinel import LossSentinel


@dataclasses.dataclass
class DependabilityConfig:
    """Knobs for the dependability facade (the reference's fields).

    Checkpoint pipeline (the Young/Daly C term):
    - ``codec``: "int8" block-quantizes float leaves >= 1 Ki elements in
      the writer pool (~3.9x fewer bytes on disk); None stores them raw.
    - ``device_codec``: quantize on the leaf's device before the copy to
      the host (the CUDA kernel on the card), shrinking the snapshot as
      well as the disk bytes, and decode on the device at restore;
      implies the int8 layout.
    - ``io_threads``: shard writer/reader pool size (0 = auto).
    - ``fsync``: "batch" (default), "per_file" or "none".
    - ``async_save``: hand serialization to a writer thread; only the
      device->host snapshot stays on the BSP critical path.
    - ``delta_checkpoint``: not in the port yet (ROADMAP item 5).

    Interruption detection:
    - ``heartbeat``: host 0 runs the UDP monitor; other hosts MUST set
      ``monitor_addr`` to host 0's advertised ``(ip, port)``.

    Silent-data-corruption detection:
    - ``sentinel``: the tier-3 end-to-end guard — non-finite loss/grad-norm
      and loss > ``sentinel_spike_factor`` x a running EMA.
    - ``scrub``: the tier-2 scrubber; not in the port yet (ROADMAP item 5).
    - ``policy_formula``: Young/Daly bracket convention, "paper"
      (mu - D + R, the paper's printed eq. 1) or "standard" (mu - D - R).
    """
    checkpoint_dir: str
    policy_mode: str = "young_daly"          # or "every_n"
    every_n: int = 1
    async_save: bool = False                  # paper-faithful default: sync
    codec: Optional[str] = None               # "int8" for compressed ckpts
    device_codec: bool = False                # quantize before the copy
    io_threads: int = 0                       # shard I/O pool size (0=auto)
    fsync: str = "batch"                      # "batch" | "per_file" | "none"
    delta_checkpoint: bool = False            # ROADMAP item 5
    keep: int = 3
    verify_crc: bool = True
    heartbeat: bool = False
    heartbeat_period: float = 0.05
    heartbeat_timeout_factor: float = 5.0
    monitor_addr: Optional[Tuple[str, int]] = None  # monitor addr, hosts > 0
    monitor_hosts: Optional[int] = None
    signal_detection: bool = True
    straggler_factor: float = 3.0
    system: SystemModel = dataclasses.field(default_factory=SystemModel)
    policy_formula: str = "paper"             # Young/Daly bracket convention
    scrub: bool = False                       # ROADMAP item 5
    sentinel: bool = False                    # tier-3 SDC: loss sentinel
    sentinel_spike_factor: float = 10.0
    sentinel_warmup: int = 5


class Dependability:
    def __init__(self, config: DependabilityConfig, host_id: int = 0,
                 num_hosts: int = 1):
        if config.delta_checkpoint:
            raise NotImplementedError(
                "delta_checkpoint waits for the block_hash slice of the "
                "port (ROADMAP item 5)")
        if config.scrub:
            raise NotImplementedError(
                "scrub (SDC tier 2) waits for the block_hash slice of the "
                "port (ROADMAP item 5)")
        self.config = config
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.manager = CheckpointManager(
            config.checkpoint_dir, host_id=host_id, num_hosts=num_hosts,
            codec=config.codec, device_codec=config.device_codec,
            io_threads=config.io_threads, fsync=config.fsync,
            verify_crc=config.verify_crc, keep=config.keep)
        self.policy = CheckpointPolicy(
            mode=config.policy_mode, every_n=config.every_n,
            system=config.system, formula=config.policy_formula)
        self.stragglers = StragglerWatchdog(factor=config.straggler_factor)
        self.sentinel: Optional[LossSentinel] = (
            LossSentinel(spike_factor=config.sentinel_spike_factor,
                         warmup=config.sentinel_warmup)
            if config.sentinel else None)
        self.last_restore_skipped: list = []
        self.signals: Optional[TerminationSignal] = None
        self.monitor: Optional[HeartbeatMonitor] = None
        self.emitter: Optional[HeartbeatEmitter] = None
        self._local_provider = None
        self._global_template = None
        self.save_history: list = []
        self.restore_seconds: list = []

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def attach_obs(self, obs) -> "Dependability":
        raise NotImplementedError(
            "telemetry (attach_obs) waits for the observability slice of "
            "the port (ROADMAP item 8)")

    def start(self) -> "Dependability":
        if self.config.signal_detection:
            self.signals = TerminationSignal().install()
        if self.config.heartbeat:
            if self.host_id == 0:
                self.monitor = HeartbeatMonitor(
                    self.config.monitor_hosts or self.num_hosts,
                    period=self.config.heartbeat_period,
                    timeout_factor=self.config.heartbeat_timeout_factor,
                ).start()
            addr = (self.monitor.addr if self.monitor
                    else self.config.monitor_addr)
            if addr is None:
                raise ValueError(
                    f"heartbeat enabled on host {self.host_id} but no "
                    "monitor address is known: host 0 runs the monitor; "
                    "other hosts must set DependabilityConfig.monitor_addr "
                    "to its (ip, port)")
            self.emitter = HeartbeatEmitter(
                self.host_id, tuple(addr), period=self.config.heartbeat_period
            ).start()
        return self

    def stop(self) -> None:
        self.manager.close()
        if self.emitter:
            self.emitter.stop()
        if self.monitor:
            self.monitor.stop()
        if self.signals:
            self.signals.uninstall()

    # ------------------------------------------------------------------
    # registration (paper: save-pointer registration)
    # ------------------------------------------------------------------
    def register_global_state(self, template, shardings=None) -> None:
        if shardings is not None:
            raise NotImplementedError(
                "shardings wait for the elastic-mesh slice of the port "
                "(ROADMAP item 10)")
        self._global_template = template

    def register_local_state(self, provider) -> None:
        """provider: object with state_dict() / load_state_dict(); local-
        scope providers also expose shard_state_dicts() /
        load_shard_state_dicts(dicts), one dict per DP shard."""
        self._local_provider = provider

    # ------------------------------------------------------------------
    # interruption detection
    # ------------------------------------------------------------------
    def interrupted(self) -> bool:
        if self.signals is not None and self.signals.triggered():
            return True
        if self.monitor is not None and self.monitor.any_failure():
            return True
        return False

    # ------------------------------------------------------------------
    # SDC detection (the sentinel; the scrubber is refused at __init__)
    # ------------------------------------------------------------------
    def check_metrics(self, step: int, metrics: Dict) -> None:
        """Tier-3 sentinel over one superstep's metrics; raises
        CorruptionDetected when the loss looks corrupted."""
        if self.sentinel is None:
            return
        reason = self.sentinel.observe(
            step, float(metrics.get("loss", 0.0)),
            grad_norm=(float(metrics["grad_norm"])
                       if "grad_norm" in metrics else None),
            nonfinite=(float(metrics["nonfinite"])
                       if "nonfinite" in metrics else None))
        if reason is not None:
            raise CorruptionDetected(step, "sentinel", reason)

    # ------------------------------------------------------------------
    # data preservation
    # ------------------------------------------------------------------
    def observe_step(self, seconds: float, step: Optional[int] = None) -> bool:
        self.policy.observe_step(seconds)
        if step is not None:
            return self.stragglers.observe(step, seconds)
        return False

    def should_checkpoint(self, step: int) -> bool:
        return self.policy.should_checkpoint(step)

    def save(self, step: int, state, *, blocking: Optional[bool] = None,
             final: bool = False) -> SaveStats:
        blocking = (not self.config.async_save) if blocking is None else blocking
        if final:
            blocking = True
        local = (self._local_provider.state_dict()
                 if self._local_provider is not None else None)
        shards = (self._local_provider.shard_state_dicts()
                  if hasattr(self._local_provider, "shard_state_dicts")
                  else None)
        t0 = time.perf_counter()
        stats = self.manager.save(step, state, local, local_shards=shards,
                                  blocking=blocking)
        cost = time.perf_counter() - t0  # on-critical-path cost
        self.policy.observe_checkpoint(cost)
        self.policy.record_checkpoint(step)
        self.save_history.append(stats)
        return stats

    def restore_latest(self, like=None, shardings=None,
                       step: Optional[int] = None, exclude=None):
        """Returns (state, step) and reloads the registered local state.

        With ``step=None`` this walks back through the retained history on
        a corrupt checkpoint (CRC mismatch etc.) instead of failing; any
        skipped steps land in ``self.last_restore_skipped``.  ``exclude``:
        steps not to consider.  Restored leaves land on the devices of
        ``like``'s tensors (default: the registered global template)."""
        if shardings is not None:
            raise NotImplementedError(
                "shardings wait for the elastic-mesh slice of the port "
                "(ROADMAP item 10)")
        like = like if like is not None else self._global_template
        self.last_restore_skipped = []
        t0 = time.perf_counter()
        wants_shards = hasattr(self._local_provider, "load_shard_state_dicts")
        if step is not None:
            state, local = self.manager.restore(step=step, like=like)
            shard_dicts = (self.manager.restore_local_shards(step)
                           if wants_shards else [])
            got_step = step
        else:
            have = [s for s in self.manager.all_steps()
                    if s not in set(exclude or ())]
            candidates = sorted(have, reverse=True)
            if wants_shards:
                (state, local, shard_dicts, got_step,
                 skipped) = self.manager.restore_latest(
                    like=like, candidates=candidates,
                    with_local_shards=True)
            else:
                shard_dicts = []
                state, local, got_step, skipped = self.manager.restore_latest(
                    like=like, candidates=candidates)
            self.last_restore_skipped = skipped
        if self._local_provider is not None:
            if shard_dicts:
                self._local_provider.load_shard_state_dicts(shard_dicts)
            elif local is not None:
                self._local_provider.load_state_dict(local)
        self.restore_seconds.append(time.perf_counter() - t0)
        return state, got_step
