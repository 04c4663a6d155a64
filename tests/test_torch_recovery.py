"""End-to-end fail-stop recovery in the port, on the CPU: the contract of
tests/test_recovery.py held by ``repro_torch`` — a crash-and-restore run
ends bit for bit where the uninterrupted run ends (global and local state
preserved) — plus the facade's interruption, sentinel and refusal paths
and the ``launch.train`` CLI."""
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import (CorruptionDetected, Dependability,
                              DependabilityConfig, FaultInjector,
                              SimulatedFailure, run_bsp, run_with_recovery)
from repro_torch.data import make_pipeline
from repro_torch.models import get_config
from repro_torch.train import init_state, make_train_step
from repro_torch.tree import flatten_named

ROOT = Path(__file__).resolve().parents[1]
STEPS = 9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dep(tmp_path, **kw):
    base = dict(policy_mode="every_n", every_n=2, heartbeat=False,
                signal_detection=False, fsync="none")
    base.update(kw)
    return Dependability(DependabilityConfig(checkpoint_dir=str(tmp_path),
                                             **base)).start()


def _setup():
    cfg = get_config("granite-3-8b", tiny=True)
    return (cfg, make_train_step(cfg, total_steps=STEPS),
            init_state(cfg, seed=0, device="cpu"), make_pipeline(cfg, 16, 4))


def _uninterrupted():
    cfg, step_fn, state, data = _setup()
    for _ in range(STEPS):
        state, m = step_fn(state, data.next_batch())
    return state, float(m["loss"])


def _assert_bit_equal(a, b):
    fa, fb = flatten_named(a), flatten_named(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.mark.parametrize("async_save", [False, True])
def test_crash_recovery_bit_exact(tmp_path, async_save):
    ref_state, ref_loss = _uninterrupted()
    cfg, step_fn, state, data = _setup()
    dep = _dep(tmp_path, async_save=async_save)
    dep.register_local_state(data)
    injector = FaultInjector()
    injector.schedule_failstop(5)
    injector.schedule_failstop(7)
    state, info = run_with_recovery(dep, step_fn, state, data, STEPS,
                                    fault_injector=injector, like=state,
                                    max_restarts=3)
    assert info["status"] == "done" and info["restarts"] == 2
    assert injector.triggered == [5, 7]
    assert [h["loss"] for h in info["history"] if "loss" in h][-1] == \
        ref_loss
    _assert_bit_equal(state, ref_state)
    assert data.step == STEPS
    dep.stop()


def test_device_codec_recovery_finishes(tmp_path):
    """With the int8 codec the restored state is the quantized one, so the
    run continues from it (no bit equality) and ends ``done``."""
    cfg, step_fn, state, data = _setup()
    dep = _dep(tmp_path, device_codec=True, async_save=True)
    dep.register_local_state(data)
    injector = FaultInjector()
    injector.schedule_failstop(5)
    state, info = run_with_recovery(dep, step_fn, state, data, STEPS,
                                    fault_injector=injector, like=state)
    assert info["status"] == "done" and info["restarts"] == 1
    losses = [h["loss"] for h in info["history"] if "loss" in h]
    # the history holds the run that finished: steps 5..9 after the restore
    assert len(losses) == STEPS - 4 and np.isfinite(losses).all()
    assert int(state["step"]) == STEPS
    dep.stop()


def test_recovery_gives_up_after_max_restarts(tmp_path):
    cfg, step_fn, state, data = _setup()
    dep = _dep(tmp_path)
    dep.register_local_state(data)
    injector = FaultInjector()
    for s in (2, 3, 4, 5, 6):
        injector.schedule_failstop(s)
    with pytest.raises(SimulatedFailure):
        run_with_recovery(dep, step_fn, state, data, 10,
                          fault_injector=injector, like=state,
                          max_restarts=2)
    dep.stop()


def test_signal_interrupts_then_resume_is_bit_exact(tmp_path):
    """SIGUSR1 mid-run: a final save at the next step boundary, status
    ``interrupted``; a new run restores it and ends where the
    uninterrupted run ends."""
    ref_state, _ = _uninterrupted()
    cfg, step_fn, state, data = _setup()
    dep = _dep(tmp_path, signal_detection=True, every_n=100)
    dep.register_local_state(data)

    def poke(step, rec):
        if step == 3:
            os.kill(os.getpid(), signal.SIGUSR1)

    state, status, hist = run_bsp(dep, step_fn, state, data, STEPS,
                                  on_metrics=poke)
    dep.stop()
    assert status == "interrupted" and len(hist) == 3
    assert dep.manager.all_steps() == [3]
    cfg, step_fn, fresh, data = _setup()
    dep = _dep(tmp_path)
    dep.register_local_state(data)
    state, got = dep.restore_latest(like=fresh)
    assert got == 3 and data.step == 3
    state, status, _ = run_bsp(dep, step_fn, state, data, STEPS)
    assert status == "done"
    _assert_bit_equal(state, ref_state)
    dep.stop()


def test_sentinel_rolls_back_a_nonfinite_step(tmp_path):
    cfg, step_fn, state, data = _setup()
    poisoned = []

    def flaky_step(st, batch):
        st2, m = step_fn(st, batch)
        if int(st2["step"]) == 6 and not poisoned:
            poisoned.append(6)
            m = dict(m, loss=torch.tensor(float("nan")),
                     nonfinite=torch.tensor(1.0))
        return st2, m

    dep = _dep(tmp_path, sentinel=True)
    dep.register_local_state(data)
    state, info = run_with_recovery(dep, flaky_step, state, data, STEPS,
                                    like=state)
    events = [h["event"] for h in info["history"] if "event" in h]
    assert info["status"] == "done" and info["restarts"] == 1
    assert events and events[0].startswith("corruption:sentinel:")
    ref_state, _ = _uninterrupted()
    _assert_bit_equal(state, ref_state)
    dep.stop()


def test_unported_options_are_refused(tmp_path):
    for kw, item in ((dict(delta_checkpoint=True), "item 5"),
                     (dict(scrub=True), "item 5")):
        with pytest.raises(NotImplementedError, match=item):
            _dep(tmp_path, **kw)
    dep = _dep(tmp_path)
    with pytest.raises(NotImplementedError, match="item 8"):
        dep.attach_obs(object())
    with pytest.raises(NotImplementedError, match="item 10"):
        dep.restore_latest(like={}, shardings=object())
    with pytest.raises(CorruptionDetected):
        Dependability(DependabilityConfig(
            checkpoint_dir=str(tmp_path), sentinel=True,
            signal_detection=False)).check_metrics(
                1, {"loss": float("nan")})
    dep.stop()


def _cli(args, tmp_path):
    # one intra-op thread, as in-process: the suite runs beside
    # timing-sensitive heartbeat tests
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--tiny",
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt"), *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


def test_cli_recovers_from_an_injected_failure(tmp_path):
    """``launch.train --tiny --device cpu --inject-failure 6`` with the
    reference's defaults (Young/Daly policy, 100 steps) ends ``done``."""
    out = _cli(["--inject-failure", "6"], tmp_path)
    assert out.returncode == 0, out.stderr
    assert "[train] done in" in out.stdout
    assert "restarts=1;" in out.stdout
    assert "failure:fail-stop" in out.stdout
    # a second run restores the last checkpoint (the policy's first save,
    # step 1) and has nothing left to do at --steps 1
    again = _cli(["--steps", "1"], tmp_path)
    assert again.returncode == 0, again.stderr
    assert "[train] restored checkpoint step 1" in again.stdout
    assert "[train] done in" in again.stdout


@pytest.mark.parametrize("flag,item", [
    (["--scrub"], "item 5"), (["--delta-checkpoint"], "item 5"),
    (["--inject-bitflip", "3:params.embed.tok:1"], "item 5"),
    (["--abft"], "item 7"), (["--telemetry-plane"], "item 8"),
    (["--data-par", "2"], "item 10")])
def test_cli_refuses_unported_flags(tmp_path, flag, item):
    out = _cli(flag, tmp_path)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and item in out.stderr
