"""``run_scenario_elastic`` on rank meshes on the CPU (gloo, one process a
rank, ``tests/torch_mesh_workers.py``): the compound trace on tiny
granite over 4 hosts x 2 ranks, a corruption that one rank's shard holds,
and storm flips landing where the reference's ``flip_bit`` lands them in
the global leaf.  Detection waits on the monitor with deadlines, never on
sleeps."""
import os

import numpy as np
import pytest

import torch_mesh_workers as W
from repro_torch.chaos import (Scenario, check_no_dead_growth,
                               check_no_lost_steps, check_trajectory_match,
                               verify)
from repro_torch.sharding.launch import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPOUND = os.path.join(ROOT, "scenarios", "compound.json")
STEPS = 20
# the card's elastic phases' limits: loss (absolute), gradient norm
# (relative); the final parameters as the mesh step holds them to the
# single-rank step (tests/test_torch_elastic.py)
LOSS_TOL, GNORM_RTOL, PARAM_TOL = 1e-2, 1e-2, 1e-4


def _single_rank(steps, seq, batch):
    """An uninterrupted single-rank run of tiny granite from the same
    state and batches at the peak learning rate from step 1: losses,
    gradient norms, the final parameters."""
    from repro_torch.data import ShardedPipeline
    from repro_torch.train import init_state, make_train_step
    from repro_torch.tree import flatten_named

    cfg = W._cfg("granite-3-8b")
    data = ShardedPipeline(cfg, seq, batch, dp_width=1)
    step = make_train_step(cfg, warmup_steps=0, total_steps=steps)
    st = init_state(cfg, seed=0, device="cpu")
    losses, norms = [], []
    for _ in range(steps):
        st, m = step(st, data.next_batch())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, {n: v.numpy()
                           for n, v in flatten_named(st["params"])}


def _param_gap(got, want):
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[n].astype(np.float64) - want[n]).max())
               for n in want)


@pytest.fixture(scope="module")
def compound(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compound")
    return spawn(W.chaos_compound, 8, run_dir=str(tmp / "run"),
                 args=(str(tmp), COMPOUND, STEPS), join_timeout=600)


def test_compound_trace_on_a_rank_mesh(compound):
    """Two hosts die at step 6 inside an SDC storm and rejoin at 16: every
    rank ends ``done`` on the full (4, 2) mesh after agreed rollbacks,
    with the events, the skipped kinds and the landed flips of the
    reference's E2E, no step lost and no dead host grown."""
    out = compound
    lead = out[0]
    for r in out:
        assert r["status"] == "done" and r["dp"] == 4 and r["member"]
        assert r["events"] == lead["events"]
        assert r["rollbacks"] == lead["rollbacks"] >= 1
    kinds = [(e["kind"], sorted(e["hosts"]), e["step"])
             for e in lead["events"]]
    assert kinds == [("shrink", [2, 3], 6), ("grow", [2, 3], 16)], kinds
    rep = lead["report"]
    assert rep["sdc_injected"], "flips must actually have landed"
    assert rep["skipped"] == ["traffic_spike"]
    assert [(a["phase"], a["at"]) for a in rep["applied"]] == [
        ("kill", 6), ("rejoin", 16), ("rejoin", 16)]
    grown = [(e["step"], list(e["hosts"])) for e in lead["events"]
             if e["kind"] == "grow"]
    verify([check_no_lost_steps(lead["history"], STEPS),
            check_no_dead_growth(grown, {2: [(6.0, 16.0)],
                                         3: [(6.0, 16.0)]})])
    # each rollback stopped every rank at the same step, restored the same
    # one, and only ranks holding the flipped shard saw the flip
    marks = [[h["event"] for h in r["history"]
              if str(h.get("event", "")).startswith(("corruption", "rollback"))]
             for r in out]
    assert len(marks[0]) == 2 * lead["rollbacks"]
    assert all(m == marks[0] for m in marks), marks
    seen = [bool(r["mismatches"]) for r in out]
    assert any(seen) and not all(seen), seen


def test_compound_trajectory_matches_a_single_rank_run(compound):
    lead = compound[0]
    losses = [h["loss"] for h in lead["history"] if "loss" in h]
    norms = [h["grad_norm"] for h in lead["history"] if "loss" in h]
    ref, ref_norms, ref_params = _single_rank(STEPS, 16, 8)
    assert len(losses) == STEPS
    tm = check_trajectory_match(losses, ref, tol=LOSS_TOL)
    assert bool(tm), tm
    np.testing.assert_allclose(norms, ref_norms, rtol=GNORM_RTOL)
    assert _param_gap(lead["params"], ref_params) < PARAM_TOL


def test_compound_log_round_trips_and_replays(compound):
    """The rank-0 log converts back to compound.json, replays through the
    port's simulator with every invariant green, and its incidents all
    closed."""
    lead = compound[0]
    assert lead["scenario"] == Scenario.from_json(COMPOUND).to_dict()
    assert all(ok for _, ok in lead["sim_invariants"]), lead
    assert lead["sim_detected"] == [2, 3]
    s = lead["timeline"]
    assert s["incidents"] >= 1 + 1 and s["closed"] == s["incidents"], s
    assert "heartbeat.failure" in s["causes"] and "sdc.corruption" in (
        s["causes"]), s
    assert s["mttr_s"] > 0 and s["availability"] < 1.0, s


def _one_rank_storm():
    """A storm with exactly one flip, at step 3, in the half of tiny
    granite's ``attn.wk`` that rank 1 holds on (1, 2): the first seed
    whose draw lands there."""
    from repro_torch.chaos.driver import _storm_flips
    from repro_torch.train import init_state

    cfg = W._cfg("granite-3-8b")
    shape = tuple(init_state(cfg, seed=0, device="meta")
                  ["params"]["blocks"]["l0"]["attn"]["wk"].shape)
    leaf = "params.blocks.l0.attn.wk"
    bits = int(np.prod(shape)) * 4 * 8
    for seed in range(100):
        sc = Scenario("one-rank", seed=seed).sdc_storm(
            rate=1.0, window=(3, 4), leaves=[leaf], max_bit=bits)
        (_, _, bit), = _storm_flips(sc, sc.window_events("sdc_storm")[0], ())
        idx = np.unravel_index(bit // 32, shape)
        if idx[2] >= shape[2] // 2:             # kv heads split over model
            return sc, leaf, bit
    raise AssertionError("no seed lands the flip in rank 1's shard")


def test_corruption_seen_by_one_rank_rolls_back_every_rank(tmp_path):
    sc, leaf, bit = _one_rank_storm()
    out = spawn(W.chaos_one_rank, 2, run_dir=str(tmp_path / "run"),
                args=(str(tmp_path), sc.to_dict(), 8), join_timeout=300)
    # only rank 1's scrubber saw the flip; both ranks stopped at step 3
    # and restored the same checkpoint
    assert out[0]["mismatches"] == [] and out[1]["mismatches"] == [leaf]
    for r in out:
        assert r["status"] == "done" and r["rollbacks"] == 1
        assert r["events"] == [
            {"step": 2, "event": "rollback:2"},
            {"step": 3, "event": f"corruption:scrub:{leaf}"}]
        assert [tuple(f) for f in r["sdc_injected"]] == [(3, leaf, bit)]
    ref, _, ref_params = _single_rank(8, 16, 4)
    assert bool(check_trajectory_match(out[0]["losses"], ref, tol=LOSS_TOL))
    assert _param_gap(out[0]["params"], ref_params) < PARAM_TOL


def test_preempt_stops_every_rank_at_the_same_step(tmp_path):
    """``preempt`` signals rank 0, whose facade detects it; its verdict
    stops both ranks at the boundary after the step, where the final
    save lands."""
    sc = Scenario("preempt").preempt(at=3)
    out = spawn(W.chaos_one_rank, 2, run_dir=str(tmp_path / "run"),
                args=(str(tmp_path), sc.to_dict(), 8, True),
                join_timeout=300)
    for r in out:
        assert r["status"] == "interrupted" and r["step"] == 3
        assert r["latest"] == 3 and r["rollbacks"] == 0
        assert [(a["phase"], a["step"]) for a in r["report"]["applied"]] == [
            ("preempt", 3)]
        assert len(r["losses"]) == 3


def test_storm_flips_land_where_the_reference_flips_the_global_leaf(
        tmp_path):
    """Flips on leaves split over the model axis, replicated over the data
    axis and whole, through the injector that knows the mesh's layout:
    the mesh's global state equals the reference's ``flip_bit`` of each
    whole leaf."""
    import jax.numpy as jnp
    from repro.core.failures import flip_bit as ref_flip_bit
    from repro_torch.train import init_state
    from repro_torch.tree import flatten_named

    cfg = W._cfg("granite-3-8b")
    shapes = {n: tuple(v.shape) for n, v in
              flatten_named(init_state(cfg, seed=0, device="meta"))}
    rng = np.random.default_rng(3)
    leaves = ["params.blocks.l0.attn.wk", "params.blocks.l0.attn.wo",
              "params.blocks.l0.mlp.w_out", "params.embed.tok",
              "params.final_norm", "opt.m.blocks.l0.mlp.w_in"]
    flips = []
    for leaf in leaves:
        bits = int(np.prod(shapes[leaf])) * 32
        for b in rng.integers(0, bits, 3):
            flips.append((leaf, int(b)))
        flips.append((leaf, bits - 1))
    out = spawn(W.flip_shards, 4, run_dir=str(tmp_path), args=(flips,),
                join_timeout=300)
    for r in out:
        for leaf in leaves:
            want = np.asarray(r["before"][leaf])
            for name, bit in flips:
                if name == leaf:
                    want = np.asarray(ref_flip_bit(jnp.asarray(want), bit))
            assert np.array_equal(r["after"][leaf].view(np.uint32),
                                  want.view(np.uint32)), leaf
        assert [tuple(f[1:]) for f in r["injected"]] == [
            tuple(f) for f in flips]
    assert all(np.array_equal(out[0]["after"][n], r["after"][n])
               for r in out for n in leaves)
