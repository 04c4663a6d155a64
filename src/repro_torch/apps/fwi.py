"""4-D full-waveform inversion, the paper's case-study application, in
PyTorch: the port's twin of the reference's ``apps/fwi.py``.

A 2-D acoustic FDTD propagates each shot through the velocity model (a
Python loop over time steps, ``torch.roll`` stencils, zero-pressure
edges); the gradient of the misfit comes from autograd through the time
loop; Adam (no weight decay) updates the model, clipped to
``[c_min, c_max]``.  Shots are the data-parallel unit (the paper spread
50 of them over 32 cores): the shots of an iteration run batched along a
leading axis, in groups of ``shot_group`` shots so that the autograd
record fits the card (it keeps one stencil field a time step a shot,
``nz * nx * 4`` bytes); the loss and the gradient are summed over the
groups in shot order.

"4-D" is time-lapse: a baseline and a monitor survey (a reservoir
perturbation in the true model) are inverted, and the difference image is
the 4-D signal.  Each FWI iteration is one BSP superstep, so the
dependability layer wraps it as it wraps a training step (global state:
the model, Adam's moments, the step; local state: the data cursor, one
file a shot shard in local scope).

Determinism on the card (a recovered run equals an uninterrupted one bit
for bit): the receivers are a strided slice of the field and each shot's
source enters through a fixed one-hot field, so no backward pass
scatters; the step runs under ``device.deterministic_algorithms``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.coordinator import run_with_recovery
from repro_torch.data.pipeline import even_spans
from repro_torch.device import deterministic_algorithms, resolve_device
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.prng import prng_key
from repro_torch.train.state import key_tensor


@dataclasses.dataclass(frozen=True)
class FWIConfig:
    nz: int = 80
    nx: int = 80
    nt: int = 500
    dx: float = 10.0          # m
    dt: float = 1e-3          # s
    f0: float = 12.0          # Ricker peak frequency, Hz
    n_shots: int = 4
    c_background: float = 2000.0
    c_layer: float = 2400.0
    c_anomaly_4d: float = -150.0   # monitor-survey velocity change
    layer_frac: float = 0.33       # depth of the reflector (fraction of nz)
    anom_frac: float = 0.5         # depth of the 4D anomaly
    c_min: float = 1500.0
    c_max: float = 3200.0
    lr: float = 15.0
    iterations: int = 20


def ricker(cfg: FWIConfig, device=None) -> torch.Tensor:
    """The source wavelet (nt,), float32."""
    t = torch.arange(cfg.nt, dtype=torch.float32, device=device) * cfg.dt \
        - 1.0 / cfg.f0
    a = (math.pi * cfg.f0 * t) ** 2
    return (1 - 2 * a) * torch.exp(-a)


def shot_positions(cfg: FWIConfig, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source x-positions (one a shot, z = 2) and receiver x-positions
    (every 2nd column from 2, z = 2), int64.  The sources are ``5 + k (nx
    - 11) // (n_shots - 1)``, exact integer arithmetic.  That equals the
    reference's float32 ``linspace(5, nx - 6, n_shots)`` truncated at
    every size this repository runs or tests: nx 50 with 2 shots, 70 with
    3, 90 with 4, 30 with 2 and 3, 920 with 16 and 50.  It is not the
    reference's everywhere: where the float32 linspace lands just below
    an integer, its truncation is one less (nx 73 with 32 shots: shots 7
    to 30 sit one column left in the reference; tests/test_torch_fwi.py
    pins that departure)."""
    span = cfg.nx - 11
    den = max(cfg.n_shots - 1, 1)
    sx = torch.tensor([5 + k * span // den for k in range(cfg.n_shots)],
                      dtype=torch.int64, device=device)
    rx = torch.arange(2, cfg.nx - 2, 2, dtype=torch.int64, device=device)
    return sx, rx


def forward_model(c: torch.Tensor, src_x: Union[int, Sequence[int],
                                                 torch.Tensor],
                  cfg: FWIConfig) -> torch.Tensor:
    """Propagates shots through the velocity model ``c`` (nz, nx).
    ``src_x``: one source x-position, or several (one a shot, batched).
    Returns the seismogram recorded at z = 2: (nt, n_receivers) for one
    source, (shots, nt, n_receivers) for several.

    The update is the reference's, in its order of operations:
    ``p_next = 2 p - p_prev + c2 lap_k lap`` with
    ``lap = -4 p + roll(p, 1, 0) + roll(p, -1, 0) + roll(p, 1, 1) +
    roll(p, -1, 1)`` zeroed on the edges, then the source added at
    ``(2, src_x)``.  The edge zeros are folded into ``c2 lap_k`` (zero
    on the edges, the same products elsewhere), which gives the same
    values and gradients with one pass over the field fewer a step."""
    single = not isinstance(src_x, (list, tuple)) and (
        not torch.is_tensor(src_x) or src_x.dim() == 0)
    dev = c.device
    sx = torch.as_tensor(src_x, dtype=torch.int64).reshape(-1).tolist()
    ns = len(sx)
    wav = ricker(cfg, dev)
    lap_k = (cfg.dt / cfg.dx) ** 2
    interior = torch.zeros((cfg.nz, cfg.nx), dtype=torch.float32,
                           device=dev)
    interior[1:-1, 1:-1] = 1.0
    c2k = c * c * lap_k * interior
    src = torch.zeros((ns, cfg.nz, cfg.nx), dtype=torch.float32, device=dev)
    for s, x in enumerate(sx):
        src[s, 2, x] = 1.0
    p_prev = torch.zeros((ns, cfg.nz, cfg.nx), dtype=torch.float32,
                         device=dev)
    p = p_prev
    recs: List[torch.Tensor] = []
    for t in range(cfg.nt):
        lap = (-4.0 * p
               + torch.roll(p, 1, 1) + torch.roll(p, -1, 1)
               + torch.roll(p, 1, 2) + torch.roll(p, -1, 2))
        p_next = torch.addcmul(2 * p - p_prev + c2k * lap, src, wav[t])
        # a copy of the receivers' row: a view would keep every step's
        # field alive until the seismogram is stacked
        recs.append(p_next[:, 2, 2:cfg.nx - 2:2].clone())
        p_prev, p = p, p_next
    seis = torch.stack(recs, dim=1)                    # (shots, nt, n_rec)
    return seis[0] if single else seis


def true_models(cfg: FWIConfig, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(baseline, monitor) true velocity models: layered + 4D anomaly."""
    z = torch.arange(cfg.nz, device=device)[:, None]
    x = torch.arange(cfg.nx, device=device)[None, :]
    f32 = torch.float32
    base = torch.where(z > int(cfg.nz * cfg.layer_frac),
                       torch.tensor(cfg.c_layer, dtype=f32, device=device),
                       torch.tensor(cfg.c_background, dtype=f32,
                                    device=device))
    base = base * torch.ones((cfg.nz, cfg.nx), dtype=f32, device=device)
    # reservoir blob in the deep layer
    cz, cx, r = int(cfg.nz * cfg.anom_frac), int(cfg.nx * 0.5), cfg.nx // 10
    blob = ((z - cz) ** 2 + (x - cx) ** 2) < r * r
    monitor = base + torch.where(
        blob, torch.tensor(cfg.c_anomaly_4d, dtype=f32, device=device),
        torch.tensor(0.0, dtype=f32, device=device))
    return base, monitor


def _shots(cfg: FWIConfig, shot_group: Optional[int]) -> List[List[int]]:
    """The source positions in groups of ``shot_group`` (one group of all
    the shots by default), in shot order."""
    sx = shot_positions(cfg)[0].tolist()
    g = shot_group or len(sx)
    return [sx[lo:lo + g] for lo in range(0, len(sx), g)]


def make_observed_data(cfg: FWIConfig, device=None,
                       shot_group: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """Observed seismograms of both surveys, every shot (in groups of
    ``shot_group``), on ``device`` (``None`` = the card)."""
    device = resolve_device(device)
    base, monitor = true_models(cfg, device)
    with torch.no_grad():
        def survey(c):
            return torch.cat([forward_model(c, grp, cfg)
                              for grp in _shots(cfg, shot_group)])
        return {"baseline": survey(base),            # (shots, nt, nrec)
                "monitor": survey(monitor),
                "model_baseline": base,
                "model_monitor": monitor}


def fwi_loss(c: torch.Tensor, d_obs: torch.Tensor, cfg: FWIConfig
             ) -> torch.Tensor:
    """Half the sum of squared residuals over all shots, over the number
    of shots."""
    sx, _ = shot_positions(cfg)
    resid = forward_model(c, sx, cfg) - d_obs
    return 0.5 * torch.sum(resid * resid) / d_obs.shape[0]


def fwi_value_and_grad(c: torch.Tensor, d_obs: torch.Tensor,
                       cfg: FWIConfig, shot_group: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fwi_loss`` and its gradient in ``c``, one shot group at a time:
    each group's share of the loss (its squared residuals over all the
    shots' count) is back-propagated before the next group runs, and the
    shares and gradients are summed in group order.  One group gives
    ``fwi_loss``'s arithmetic."""
    n = d_obs.shape[0]
    loss = grad = None
    lo = 0
    for grp in _shots(cfg, shot_group):
        hi = lo + len(grp)
        live = c.detach().requires_grad_(True)
        resid = forward_model(live, grp, cfg) - d_obs[lo:hi]
        part = 0.5 * torch.sum(resid * resid) / n
        g, = torch.autograd.grad(part, live)
        del resid
        loss = part.detach() if loss is None else loss + part.detach()
        grad = g if grad is None else grad + g
        lo = hi
    return loss, grad


def init_fwi_state(cfg: FWIConfig, device=None):
    """Global state (DeLIA terms): model + moments + iteration count, on
    ``device`` (``None`` = the card); ``rng`` is the reference's
    ``PRNGKey(0)``, carried unchanged."""
    device = resolve_device(device)
    c0 = torch.full((cfg.nz, cfg.nx), cfg.c_background, dtype=torch.float32,
                    device=device)
    params = {"c": c0}
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "params": params,
        "opt": adamw_init(params),
        "rng": key_tensor(prng_key(0), device),
    }


def make_fwi_step(cfg: FWIConfig, shot_group: Optional[int] = None):
    """One BSP superstep: the gradient over all shots, then an Adam update
    of c (``weight_decay=0``) clipped to ``[c_min, c_max]``.  Functional:
    returns a new state."""

    def step(state, batch):
        dev = state["step"].device
        d_obs = batch["d_obs"].to(dev)
        with deterministic_algorithms(dev):
            loss, g = fwi_value_and_grad(state["params"]["c"], d_obs, cfg,
                                         shot_group)
            new_params, new_opt = adamw_update(
                {"c": g}, state["opt"], state["params"], lr=cfg.lr,
                weight_decay=0.0)
            c = torch.clamp(new_params["c"], cfg.c_min, cfg.c_max)
        new_state = {"step": state["step"] + 1, "params": {"c": c},
                     "opt": new_opt, "rng": state["rng"]}
        return new_state, {"loss": loss}

    return step


class FWIData:
    """Constant-dataset pipeline with a DeLIA local-state cursor."""

    def __init__(self, d_obs):
        self.d_obs = d_obs
        self.step = 0

    def next_batch(self):
        self.step += 1
        return {"d_obs": self.d_obs}

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, s):
        self.step = int(s["step"])


class FWIShardData:
    """Local-SCOPE FWI pipeline: shots are the DP unit and shard k owns
    the contiguous shot slice ``[lo, hi)`` of the observed data plus its
    own cursor.

    Each shard's ``{"step", "shot_lo", "shot_hi"}`` dict is saved as its
    OWN checkpoint file (``local_s<k>.json``) and remapped onto the
    current DP width on restore.  The merged batch is always the full shot
    set, so the inversion trajectory does not depend on the width."""

    def __init__(self, d_obs, dp_width: int = 1):
        self.d_obs = d_obs
        self.n_shots = int(d_obs.shape[0])
        self.step = 0
        self.remapped_from: Optional[int] = None
        self.repartition(dp_width)

    def repartition(self, dp_width: int) -> None:
        self.spans = even_spans(self.n_shots, dp_width)
        self.dp_width = dp_width

    def next_batch(self):
        self.step += 1
        return {"d_obs": self.d_obs}

    def shard_batch(self, k: int):
        """Shard k's slice of the observed data (what that worker alone
        would propagate)."""
        lo, hi = self.spans[k]
        return {"d_obs": self.d_obs[lo:hi]}

    # ---- DeLIA local scope ----
    def state_dict(self):
        return {"step": int(self.step), "width": int(self.dp_width),
                "n_shots": int(self.n_shots), "scope": "sharded"}

    def load_state_dict(self, s):
        self.step = int(s["step"])

    def shard_state_dicts(self):
        return [{"shard": k, "width": int(self.dp_width),
                 "step": int(self.step), "shot_lo": int(lo),
                 "shot_hi": int(hi)}
                for k, (lo, hi) in enumerate(self.spans)]

    def load_shard_state_dicts(self, dicts):
        """Restores the cursor from saved shard dicts of any width.
        Raises ``ValueError`` when the saved cursors disagree or the saved
        spans do not tile the shot axis (data lost between save and
        restore)."""
        dicts = sorted(dicts, key=lambda d: int(d["shard"]))
        steps = {int(d["step"]) for d in dicts}
        if len(steps) != 1:
            raise ValueError(f"saved shard cursors diverged: {steps}")
        covered = [(int(d["shot_lo"]), int(d["shot_hi"])) for d in dicts]
        if not (covered[0][0] == 0 and covered[-1][1] == self.n_shots
                and all(a[1] == b[0] for a, b in zip(covered, covered[1:]))):
            raise ValueError(f"saved shot spans do not tile "
                             f"[0, {self.n_shots}): {covered}")
        self.remapped_from = len(dicts)
        self.step = steps.pop()
        self.repartition(self.dp_width)   # recompute spans for our width


def run_fwi(cfg: FWIConfig, d_obs, *, dep=None,
            iterations: Optional[int] = None, state=None,
            fault_injector=None, local_scope: bool = False,
            dp_width: int = 1, device=None,
            shot_group: Optional[int] = None, on_metrics=None):
    """Runs FWI on ``device`` (``None`` = the card; the state's device
    when ``state`` is given); with ``dep`` the loop is DeLIA-protected
    (``run_with_recovery``: checkpoints, restore on a fail-stop).

    ``local_scope=True`` uses the per-shard pipeline (``FWIShardData``
    over ``dp_width`` shot shards), so each shard's cursor and shot slice
    checkpoint to their own file.  ``shot_group``: shots a forward and
    backward pass (all of them by default).  ``on_metrics(step, record)``
    sees every protected iteration (``run_with_recovery``'s).  Returns
    (state, history)."""
    iterations = iterations or cfg.iterations
    device = (state["step"].device if state is not None
              else resolve_device(device))
    step_fn = make_fwi_step(cfg, shot_group)
    state = state if state is not None else init_fwi_state(cfg, device)
    d_obs = torch.as_tensor(d_obs).to(device)
    data = (FWIShardData(d_obs, dp_width=dp_width) if local_scope
            else FWIData(d_obs))
    if dep is None:
        hist = []
        for _ in range(int(state["step"]), iterations):
            state, m = step_fn(state, data.next_batch())
            hist.append({"loss": float(m["loss"])})
        return state, hist
    dep.register_local_state(data)
    template = init_fwi_state(cfg, device)
    state, info = run_with_recovery(dep, step_fn, state, data, iterations,
                                    fault_injector=fault_injector,
                                    like=template, on_metrics=on_metrics)
    return state, info["history"]
