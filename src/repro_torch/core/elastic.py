"""Elastic recovery: rebuild a mesh from survivors and reshard the latest
checkpoint onto it (the reference's ``core/elastic.py`` over rank meshes).

The checkpoint format stores global shapes + per-shard spans, so restore can
target ANY mesh (fewer hosts after a fail-stop, more after a grow event).
This implements DeLIA's "fault treatment" options (node exclusion /
reallocation).  A "device" here is a rank (``sharding/launch.py``).

Meshes come in two flavors:

- 2D ``("data", "model")`` via :func:`survivor_mesh` — the original path,
  kept for dense models.
- 3D ``("data", "model", "expert")`` via :class:`MeshSpec` +
  :func:`survivor_mesh3d` — MoE configs (Mixtral, Phi-3.5-MoE, Qwen-110B)
  where one dead host removes a slice from *every* axis.  The factorization
  picks the best legal (dp, tp, ep) grid under per-axis constraints (tp must
  divide the head count and d_ff so checkpoint spans re-tile exactly; ep must
  divide the live expert count) and degrades in priority order
  **ep -> dp -> tp**: expert parallelism is folded away first, then the batch
  shrinks, and tensor parallelism — the axis a single host's memory depends
  on — is sacrificed last.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.models.base import ModelConfig
from repro_torch.sharding.api import Mesh, resolve
from repro_torch.sharding.rules import (legal_dp_widths, legal_tp_widths,
                                        state_specs)
from repro_torch.tree import tree_map


class NoSurvivorsError(RuntimeError):
    """Every device failed: there is nothing to rebuild a mesh from."""


class NoLegalGridError(RuntimeError):
    """No grid satisfies the per-axis constraints (see the message for the
    legal alternatives)."""


def largest_grid(n: int, model_axis: int,
                 legal: Optional[Sequence[int]] = None) -> Tuple[int, int]:
    """(data, model) grid using at most n devices, keeping the model axis.

    Picks the **largest legal divisor**: the widest model axis that is
    <= ``model_axis``, divides ``n`` evenly, and — when ``legal`` is given
    (e.g. ``sharding.rules.legal_tp_widths(cfg)``) — is a width the model
    can actually be sharded to.  Raises :class:`NoLegalGridError` listing
    the legal grids when the constraints rule every width out, instead of
    silently returning a grid the checkpoint layer cannot re-tile."""
    if n <= 0:
        raise NoSurvivorsError(
            f"cannot build a device grid from {n} surviving devices")
    allowed = None if legal is None else {int(w) for w in legal}
    if allowed is not None and not allowed:
        raise NoLegalGridError("empty set of legal model widths")
    for model in range(min(model_axis, n), 0, -1):
        if n % model == 0 and (allowed is None or model in allowed):
            return (n // model, model)
    grids = [(n // m, m) for m in range(1, n + 1)
             if n % m == 0 and m in allowed]
    raise NoLegalGridError(
        f"no legal (data, model) grid for {n} devices with "
        f"model_axis={model_axis} and legal widths {sorted(allowed)}"
        + (f"; legal grids for {n} devices: {grids}" if grids
           else f"; no legal width divides {n}"))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Desired (data, model, expert) grid plus per-axis legality constraints.

    ``data``/``model``/``expert`` are the *target* widths (what the job was
    launched with); :func:`best_grid3d` degrades from there when fewer
    devices survive.  ``legal_model`` is the set of tp widths the model can
    be resharded to (``None`` = any divisor); ``legal_data`` likewise for
    dp widths (FSDP shards a d_model-sized dim, so dp must divide it for a
    checkpoint to re-partition exactly); ``num_experts`` is the live
    expert count ep must divide (0 = dense model, ep pinned to 1)."""

    data: int = 1
    model: int = 1
    expert: int = 1
    legal_model: Optional[Tuple[int, ...]] = None
    legal_data: Optional[Tuple[int, ...]] = None
    num_experts: int = 0
    axis_names: Tuple[str, ...] = ("data", "model", "expert")

    @classmethod
    def from_config(cls, cfg: ModelConfig, *, data: int = 1, model: int = 1,
                    expert: int = 1) -> "MeshSpec":
        """Constraints derived from the model config: legal tp widths divide
        the head count and d_ff; legal dp widths divide d_model (the FSDP
        dim); ep divides the (live) expert count."""
        return cls(data=data, model=model, expert=expert,
                   legal_model=legal_tp_widths(cfg),
                   legal_data=legal_dp_widths(cfg),
                   num_experts=cfg.num_experts)

    @property
    def size(self) -> int:
        return self.data * self.model * self.expert

    def shape(self) -> Tuple[int, int, int]:
        return (self.data, self.model, self.expert)

    def with_experts(self, num_experts: int) -> "MeshSpec":
        """Same spec with a new live expert count (after expert loss)."""
        return dataclasses.replace(self, num_experts=num_experts)


def best_grid3d(n: int, spec: MeshSpec) -> Tuple[int, int, int]:
    """Best legal (dp, tp, ep) grid on ``n`` devices for ``spec``.

    "Best" maximizes, lexicographically: devices used; tp (capped at the
    desired width — tp is the last axis sacrificed); dp *up to* the desired
    width; ep; then any leftover devices widen dp.  That realizes the
    degradation priority **ep -> dp -> tp**: expert parallelism is the
    first axis folded away, tensor parallelism the last, and a full-size
    grid is never degraded ((2,2,2) on 8 devices stays (2,2,2)).

    When ``spec.legal_data`` is set (``MeshSpec.from_config`` derives it
    from d_model — the dim FSDP shards), dp is the widest LEGAL width
    fitting the device quota, possibly idling devices: a dp the checkpoint
    layer cannot re-partition to is no grid at all.  Raises
    :class:`NoLegalGridError` when no tp width is legal,
    :class:`NoSurvivorsError` when ``n <= 0``."""
    if n <= 0:
        raise NoSurvivorsError(
            f"cannot build a device grid from {n} surviving devices")
    tps = [w for w in range(1, min(spec.model, n) + 1)
           if spec.legal_model is None or w in spec.legal_model]
    if not tps:
        raise NoLegalGridError(
            f"no legal model width <= {min(spec.model, n)} for {n} devices "
            f"(legal widths: {sorted(spec.legal_model)})")
    if spec.num_experts:
        eps = [e for e in range(1, min(spec.expert, spec.num_experts) + 1)
               if spec.num_experts % e == 0]
    else:
        eps = [1]

    def best_dp(quota: int) -> int:
        if spec.legal_data is None:
            return quota
        fits = [w for w in spec.legal_data if 1 <= w <= quota]
        return max(fits) if fits else 0

    best = best_key = None
    for tp in tps:
        for ep in eps:
            if tp * ep > n:
                continue
            dp = best_dp(n // (tp * ep))
            if dp < 1:
                continue
            key = (dp * tp * ep, tp, min(dp, spec.data), ep, dp)
            if best_key is None or key > best_key:
                best_key, best = key, (dp, tp, ep)
    if best is None:
        raise NoLegalGridError(
            f"no legal (data, model, expert) grid fits {n} devices "
            f"(tp candidates {tps}, ep candidates {eps})")
    return best


def _all_devices() -> list:
    """Every rank of the run (one, outside a process group)."""
    import torch.distributed as dist

    return list(range(dist.get_world_size() if dist.is_initialized()
                      else 1))


def _resolve_survivors(failed_fraction_or_devices) -> list:
    """Rank list from an explicit list, a failed-rank count, or a true
    fraction (0 <= f < 1) of failed ranks."""
    if isinstance(failed_fraction_or_devices, (list, tuple)):
        return list(failed_fraction_or_devices)
    all_devices = _all_devices()
    n = len(all_devices)
    x = failed_fraction_or_devices
    if isinstance(x, (float, np.floating)):
        # a float is a FRACTION of failed devices; reinterpreting 1.0
        # (or 2.0) as a count would silently build a mesh containing
        # dead devices — make the caller say what they mean
        if not 0 <= x < 1:
            raise ValueError(
                f"failed fraction must be in [0, 1), got {x!r}; pass an "
                "int for a device count or a device list")
        failed = int(round(x * n))
    else:
        failed = int(x)
    # clamp: a miscounted failure total (failed > n) must land in the
    # no-survivors error below, not a negative slice that would build
    # a "survivor" mesh containing dead devices
    return all_devices[: max(n - failed, 0)]


def survivor_mesh(failed_fraction_or_devices, model_axis: int = 1,
                  axis_names=("data", "model"),
                  legal: Optional[Sequence[int]] = None, *,
                  rank: Optional[int] = None, device=None) -> Mesh:
    """Builds a (data, model) mesh from surviving devices.

    Accepts an explicit device list, a number of failed devices to exclude
    from the run's ranks, or a true fraction (0 < f < 1) of failed
    devices (``0.5`` excludes half, rounded to nearest).  Raises
    ``NoSurvivorsError`` when nothing survives."""
    devices = _resolve_survivors(failed_fraction_or_devices)
    if not devices:
        raise NoSurvivorsError(
            "no surviving devices to build a mesh from "
            f"(failed_fraction_or_devices={failed_fraction_or_devices!r})")
    d, m = largest_grid(len(devices), model_axis, legal=legal)
    grid = np.array(devices[: d * m]).reshape(d, m)
    return Mesh(grid, axis_names, rank=rank, device=device)


def survivor_mesh3d(failed_fraction_or_devices, spec: MeshSpec, *,
                    rank: Optional[int] = None, device=None) -> Mesh:
    """Builds the best legal (data, model, expert) mesh from survivors.

    Same survivor-resolution semantics as :func:`survivor_mesh`; the grid
    is :func:`best_grid3d`, so losing a host degrades ep first, then dp,
    and tp only when nothing else is left.

    Device placement is **expert-major**: the device list is split into
    ``ep`` contiguous blocks, one per expert coordinate.  Hosts own
    contiguous device ranges (``launch.mesh.host_device_map``), so a host's
    devices land inside ONE expert slice — a host failure breaks exactly
    one slice, which is what lets the elastic loop treat an expert slice
    as the failure unit for graceful degradation."""
    devices = _resolve_survivors(failed_fraction_or_devices)
    if not devices:
        raise NoSurvivorsError(
            "no surviving devices to build a mesh from "
            f"(failed_fraction_or_devices={failed_fraction_or_devices!r})")
    dp, tp, ep = best_grid3d(len(devices), spec)
    grid = (np.array(devices[: dp * tp * ep])
            .reshape(ep, dp, tp).transpose(1, 2, 0))
    return Mesh(grid, spec.axis_names, rank=rank, device=device)


def mesh_axis_sizes(mesh: Mesh) -> dict:
    """{axis name: size} for ``mesh`` (missing axes simply absent)."""
    return mesh.shape


def dp_width(mesh: Mesh) -> int:
    """Data-parallel width of ``mesh`` — the product of the batch-sharding
    axes ("pod", "data"), NEVER the total device count: on a 3D mesh the
    "model" and "expert" axes replicate the batch, they do not split it."""
    axes = mesh_axis_sizes(mesh)
    return int(axes.get("pod", 1)) * int(axes.get("data", 1))


def reshard_state(manager, cfg: ModelConfig, mesh: Mesh, like,
                  step: Optional[int] = None,
                  moe_ep: Optional[bool] = None):
    """Restore the latest (or given) checkpoint onto ``mesh``.

    This re-*partitions*, not just re-slices: the manifest records every
    shard's index spans, and ``restore`` assembles the calling rank's
    shard for the new mesh from the stored shards that overlap it — so a
    checkpoint written at tp=2 restores onto tp=1 (concat) or tp=4
    (split) exactly.

    ``moe_ep=None`` auto-detects expert placement: an "expert" axis of
    width > 1 in ``mesh`` turns on 3D expert sharding; otherwise the
    checkpoint's recorded mesh metadata (``manifest_meta``) decides.
    Returns (state, local_state, step)."""
    step = manager.latest_step() if step is None else step
    axes = mesh_axis_sizes(mesh)
    tp = int(axes.get("model", 1))
    ep = int(axes.get("expert", 1))
    if moe_ep is None:
        if ep > 1:
            moe_ep = ep
        else:
            meta = getattr(manager, "manifest_meta", lambda s: None)(step)
            moe_ep = bool((meta or {}).get("moe_ep", False))
    specs = state_specs(cfg, tp, moe_ep)
    shardings = tree_map(lambda s: resolve(s, mesh), specs)
    state, local = manager.restore(step=step, like=like, shardings=shardings)
    return state, local, step


def rescale_global_batch(global_batch: int, old_data_parallel: int,
                         new_data_parallel: int) -> int:
    """Keep the per-replica batch constant when the DP width changes: the
    new global batch is ``per_replica * new_dp`` (shrinks on failure, grows
    on rejoin).  Compute/memory per device stays flat; optimizer hyper-
    parameters tied to the global batch must be rescaled by the caller.

    Widths here are **dp widths only** — pass ``dp_width(mesh)``, never a
    device count: model/expert axes replicate the batch."""
    if old_data_parallel <= 0 or new_data_parallel <= 0:
        raise ValueError((old_data_parallel, new_data_parallel))
    if global_batch % old_data_parallel:
        raise ValueError(
            f"global batch {global_batch} does not divide over "
            f"{old_data_parallel} replicas")
    per_replica = global_batch // old_data_parallel
    return per_replica * new_data_parallel


def rescale_global_batch_for_mesh(global_batch: int, old_mesh: Mesh,
                                  new_mesh: Mesh) -> int:
    """``rescale_global_batch`` with the dp widths read off the meshes' own
    "data"/"pod" axes — immune to the total-device-count bug on 3D grids."""
    return rescale_global_batch(global_batch, dp_width(old_mesh),
                                dp_width(new_mesh))
