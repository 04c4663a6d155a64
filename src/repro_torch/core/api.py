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

Telemetry (``attach_obs``, docs/observability.md): with an
``Observability`` attached, saves, restores, SDC detections and
heartbeat failures emit onto its bus, and the measured restore and
detection latency feed the policy's R and D terms.

Sharded state (``register_global_state(template, shardings)``): on a
rank mesh each rank's state leaves are its shards; saves write them with
their spans into the global shapes of ``template`` and restores read the
calling rank's shards for ``shardings``, whatever mesh wrote the
checkpoint.  ``mesh_meta`` (set by ``run_elastic``) is recorded in each
save's manifest; ``world`` (a ``sharding.launch.World``) makes the
recovery loop's restores wait for every rank's last save.
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
from repro_torch.sdc.scrubber import StateScrubber
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
    - ``delta_checkpoint``: incremental saves: per-block hashes computed
      on the card (block_hash kernel) pick out the blocks that changed
      since the last committed checkpoint; only those cross to the host
      and hit disk.  ``delta_block`` elements a block; ``full_every``
      bounds the reference chain with periodic full saves.  The policy
      tracks the cost of each save kind, so the Young/Daly interval sizes
      to the amortized cost.

    Interruption detection:
    - ``heartbeat``: host 0 runs the UDP monitor; other hosts MUST set
      ``monitor_addr`` to host 0's advertised ``(ip, port)``.

    Silent-data-corruption detection:
    - ``scrub``: the tier-2 StateScrubber: each superstep checksums a
      rotating ``scrub_fraction`` of the state leaves and re-verifies
      them before the next update; a mismatch raises CorruptionDetected
      naming the leaf.  Checkpoints taken while scrubbing is clean are
      recorded as verified and preferred by rollback.
    - ``sentinel``: the tier-3 end-to-end guard — non-finite loss/grad-norm
      and loss > ``sentinel_spike_factor`` x a running EMA.
    - tier 1 (ABFT matmuls) is opted into per model with ``impl="abft"``
      in make_train_step, not here.
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
    delta_checkpoint: bool = False            # write only dirty blocks
    delta_block: int = 65536                  # elements per delta block
    full_every: int = 8                       # full save every N saves
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
    scrub: bool = False                       # tier-2 SDC: state scrubber
    scrub_fraction: float = 0.25              # leaves checksummed per step
    sentinel: bool = False                    # tier-3 SDC: loss sentinel
    sentinel_spike_factor: float = 10.0
    sentinel_warmup: int = 5


class Dependability:
    def __init__(self, config: DependabilityConfig, host_id: int = 0,
                 num_hosts: int = 1):
        self.config = config
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.manager = CheckpointManager(
            config.checkpoint_dir, host_id=host_id, num_hosts=num_hosts,
            codec=config.codec, device_codec=config.device_codec,
            io_threads=config.io_threads, fsync=config.fsync,
            verify_crc=config.verify_crc, keep=config.keep,
            delta=config.delta_checkpoint, delta_block=config.delta_block,
            full_every=config.full_every)
        self.policy = CheckpointPolicy(
            mode=config.policy_mode, every_n=config.every_n,
            system=config.system, formula=config.policy_formula)
        self.stragglers = StragglerWatchdog(factor=config.straggler_factor)
        self.scrubber: Optional[StateScrubber] = (
            StateScrubber(fraction=config.scrub_fraction)
            if config.scrub else None)
        self.sentinel: Optional[LossSentinel] = (
            LossSentinel(spike_factor=config.sentinel_spike_factor,
                         warmup=config.sentinel_warmup)
            if config.sentinel else None)
        self.verified_steps: set = set()      # saved while scrub-clean
        self.last_restore_skipped: list = []
        self.signals: Optional[TerminationSignal] = None
        self.monitor: Optional[HeartbeatMonitor] = None
        self.emitter: Optional[HeartbeatEmitter] = None
        # the monitor's per-host callbacks (run_elastic latches them)
        self.on_host_failure = None
        self.on_host_rejoin = None
        self._local_provider = None
        self._global_template = None
        self.save_history: list = []
        self.restore_seconds: list = []
        # the grid a save is sharded on (recorded in its manifest) and,
        # on a rank mesh, the run's World and the state's shardings
        self.mesh_meta: Optional[dict] = None
        self.world = None
        self._global_shardings = None
        self._ckpt_gen = ["run", 0]       # see should_checkpoint
        # telemetry handle (repro_torch.obs.Observability); attach_obs
        # threads it through the monitor and turns on event/metric
        # emission everywhere
        self.obs = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def attach_obs(self, obs) -> "Dependability":
        """Wire a ``repro_torch.obs.Observability`` through this facade:
        saves, restores, SDC detections, and heartbeat failures/rejoins
        all emit onto its bus, and the measured R/D terms flow into the
        policy via ``observe_recovery``.  Call before or after
        ``start()`` — the monitor picks the handle up either way."""
        self.obs = obs
        if self.monitor is not None:
            self.monitor.obs = obs
        return self

    def start(self) -> "Dependability":
        if self.config.signal_detection:
            self.signals = TerminationSignal().install()
        if self.config.heartbeat:
            if self.host_id == 0:
                self.monitor = HeartbeatMonitor(
                    self.config.monitor_hosts or self.num_hosts,
                    period=self.config.heartbeat_period,
                    timeout_factor=self.config.heartbeat_timeout_factor,
                    on_failure=lambda h: (self.on_host_failure or
                                          (lambda _: None))(h),
                    on_rejoin=lambda h: (self.on_host_rejoin or
                                         (lambda _: None))(h),
                    obs=self.obs,
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
        """``template``: the state's tree (its global shapes; meta tensors
        will do); ``shardings``: a matching tree of
        ``sharding.api.NamedSharding`` when each rank holds shards."""
        self._global_template = template
        self._global_shardings = shardings

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
    # SDC detection (no-ops unless scrub/sentinel are enabled)
    # ------------------------------------------------------------------
    def scrub(self, state, step: int) -> list:
        """Tier-2 scrub pass: checksum the next rotating subset of state
        leaves.  Call right after ``train_step`` produces the state;
        returns the leaf names covered this step."""
        if self.scrubber is None:
            return []
        return self.scrubber.record(state, step)

    def verify_state(self, state, step: int) -> None:
        """Re-verify the leaves the last ``scrub`` recorded: nothing
        legitimate changes the state in between (call at the top of the
        superstep, before ``train_step`` consumes it).  Raises
        CorruptionDetected naming the corrupted leaves on a mismatch."""
        if self.scrubber is None:
            return
        bad = self.scrubber.verify(state)
        if bad:
            self._emit_sdc(step, "scrub", ",".join(bad))
            raise CorruptionDetected(step, "scrub", ",".join(bad))

    def reset_sdc(self) -> None:
        """Call after a rollback: the restored state is a different set of
        buffers than the recorded scrub window."""
        if self.scrubber is not None:
            self.scrubber.reset()

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
            self._emit_sdc(step, "sentinel", reason)
            raise CorruptionDetected(step, "sentinel", reason)

    def _emit_sdc(self, step: int, tier: str, detail: str) -> None:
        if self.obs is None:
            return
        with self.obs.timed():
            self.obs.emit("sdc", "corruption", step=step, tier=tier,
                          detail=detail)
            self.obs.registry.counter("sdc.detected", tier=tier).inc()

    # ------------------------------------------------------------------
    # data preservation
    # ------------------------------------------------------------------
    def observe_step(self, seconds: float, step: Optional[int] = None) -> bool:
        self.policy.observe_step(seconds)
        if step is not None:
            return self.stragglers.observe(step, seconds)
        return False

    def should_checkpoint(self, step: int) -> bool:
        """The policy's decision; with several hosts writing one save
        (``world`` set), host 0's decision, which every host reads from
        the run's store (their step timings differ, their saves must
        not)."""
        if self.world is None or self.manager.num_hosts <= 1:
            return self.policy.should_checkpoint(step)
        tag, n = self._ckpt_gen
        key = f"ckpt/{tag}/{n}/{step}"
        if self.manager.host_id == 0:
            due = self.policy.should_checkpoint(step)
            self.world.publish(key, "1" if due else "0")
            return due
        return self.world.fetch(key) == "1"

    def set_ckpt_tag(self, tag: str) -> None:
        """Names the run segment whose hosts decide saves together (the
        elastic loop's mesh epoch); restores count within it."""
        self._ckpt_gen = [str(tag), 0]

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
        sharded = self._global_shardings is not None
        stats = self.manager.save(
            step, state, local, local_shards=shards,
            mesh_meta=self.mesh_meta,
            shardings=self._global_shardings if sharded else None,
            like=self._global_template if sharded else None,
            blocking=blocking)
        cost = time.perf_counter() - t0  # on-critical-path cost
        # delta mode: each save kind keeps its own cost, so the policy
        # amortizes cheap deltas against the periodic full saves
        self.policy.observe_checkpoint(
            cost, kind=stats.kind if self.config.delta_checkpoint else None)
        self.policy.record_checkpoint(step)
        self.save_history.append(stats)
        if self.scrubber is not None:
            # scrubbing was clean up to this step, else CorruptionDetected
            # would have unwound the loop before the save
            self.verified_steps.add(step)
        if self.obs is not None:
            with self.obs.timed():
                self.obs.emit("checkpoint", "save", step=step,
                              save_kind=stats.kind, final=final,
                              bytes=stats.bytes_written,
                              critical_path_s=cost, blocking=blocking,
                              dirty_blocks=stats.dirty_blocks,
                              total_blocks=stats.total_blocks)
                reg = self.obs.registry
                reg.histogram("checkpoint.critical_path_ms").observe(
                    cost * 1e3)
                reg.counter("checkpoint.saves", kind=stats.kind).inc()
                reg.counter("checkpoint.bytes").inc(stats.bytes_written)
                if stats.total_blocks:
                    reg.histogram("checkpoint.dirty_block_ratio").observe(
                        stats.dirty_blocks / stats.total_blocks)
        return stats

    def restore_latest(self, like=None, shardings=None,
                       step: Optional[int] = None, exclude=None):
        """Returns (state, step) and reloads the registered local state.

        With ``step=None`` this walks back through the retained history on
        a corrupt checkpoint (CRC mismatch etc.) instead of failing, and
        prefers scrub-verified steps when scrubbing is on; any skipped
        steps land in ``self.last_restore_skipped``.  ``exclude``:
        steps not to consider.  Restored leaves land on the devices of
        ``like``'s tensors (default: the registered global template), or,
        with ``shardings`` (default: the registered ones), as the calling
        rank's shards on its mesh's device."""
        like = like if like is not None else self._global_template
        shardings = (shardings if shardings is not None
                     else self._global_shardings)
        self._ckpt_gen[1] += 1
        self.last_restore_skipped = []
        t0 = time.perf_counter()
        wants_shards = hasattr(self._local_provider, "load_shard_state_dicts")
        if step is not None:
            state, local = self.manager.restore(step=step, like=like,
                                                shardings=shardings)
            shard_dicts = (self.manager.restore_local_shards(step)
                           if wants_shards else [])
            got_step = step
        else:
            have = [s for s in self.manager.all_steps()
                    if s not in set(exclude or ())]
            verified = sorted(self.verified_steps.intersection(have),
                              reverse=True)
            candidates = verified + sorted(set(have) - self.verified_steps,
                                           reverse=True)
            if wants_shards:
                (state, local, shard_dicts, got_step,
                 skipped) = self.manager.restore_latest(
                    like=like, shardings=shardings, candidates=candidates,
                    with_local_shards=True)
            else:
                shard_dicts = []
                state, local, got_step, skipped = self.manager.restore_latest(
                    like=like, shardings=shardings, candidates=candidates)
            self.last_restore_skipped = skipped
        if self._local_provider is not None:
            if shard_dicts:
                self._local_provider.load_shard_state_dicts(shard_dicts)
            elif local is not None:
                self._local_provider.load_state_dict(local)
        restore_s = time.perf_counter() - t0
        self.restore_seconds.append(restore_s)
        if self.obs is not None:
            with self.obs.timed():
                # live Young/Daly: the measured restore IS the R term; the
                # monitor's last declaration latency is the D term (when
                # heartbeat is on)
                detect_s = None
                if (self.monitor is not None
                        and self.monitor.detection_latency):
                    detect_s = max(self.monitor.detection_latency.values())
                self.policy.observe_recovery(restart_s=restore_s,
                                             downtime_s=detect_s)
                self.obs.emit("checkpoint", "restore", step=got_step,
                              restore_s=restore_s,
                              skipped=[list(s) for s in
                                       self.last_restore_skipped])
                self.obs.registry.histogram(
                    "checkpoint.restore_ms").observe(restore_s * 1e3)
                self.obs.registry.counter("checkpoint.restores").inc()
        return state, got_step
