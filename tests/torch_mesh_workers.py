"""Rank functions for the port's multi-process tests (spawned by
``repro_torch.sharding.launch.spawn``; one process a rank, gloo over a
FileStore in the test's tmp_path).  No JAX here: the children import
this module, and the tests compare the results with the JAX package in
the parent process."""
import dataclasses
import json
import time

import numpy as np
import torch

PERIOD = 0.05


def _cfg(arch, dtype=torch.float32, **kw):
    from repro_torch.models import get_config

    return dataclasses.replace(get_config(arch, tiny=True), dtype=dtype, **kw)


def mesh_vs_one(world, arch, grid, steps, micro=1, axes=None, cfg_kw=None):
    """``steps`` mesh steps against ``steps`` single-rank steps from the
    same state and batches: losses, grad norms, and the largest
    difference of any state leaf after the last step.  ``axes``: the
    grid's axis names (default (data, model[, expert])); ``cfg_kw``:
    fields of the tiny config replaced."""
    from repro_torch.data import ShardedPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import init_state, make_train_step
    from repro_torch.train.mesh_step import (init_sharded_state,
                                             make_mesh_train_step,
                                             mesh_combos, state_shardings)
    from repro_torch.tree import flatten_named

    cfg = _cfg(arch, **(cfg_kw or {}))
    mesh = make_host_mesh(*grid, axis_names=axes, rank=world.rank,
                          device=world.device)
    mesh.init_groups(mesh_combos(mesh))
    ep = mesh.shape.get("expert", 1)
    sh = state_shardings(cfg, mesh, moe_ep=(ep if ep > 1 else False))
    like = init_state(cfg, seed=0, device="meta")
    out = {}
    for donate in (False, True):
        st = init_sharded_state(cfg, sh, seed=0, device="cpu", world=world)
        step = make_mesh_train_step(cfg, mesh, sh, like, total_steps=10,
                                    donate=donate, microbatches=micro)
        data = ShardedPipeline(cfg, 16, 8, dp_width=1)
        got = []
        for _ in range(steps):
            st, m = step(st, data.next_batch())
            got.append([float(m["loss"]), float(m["grad_norm"]),
                        float(m["aux"])])
        out[donate] = (got, unshard(st, sh, like))
    ref = init_state(cfg, seed=0, device="cpu")
    rstep = make_train_step(cfg, total_steps=10, microbatches=micro)
    data = ShardedPipeline(cfg, 16, 8, dp_width=1)
    want = []
    for _ in range(steps):
        ref, m = rstep(ref, data.next_batch())
        want.append([float(m["loss"]), float(m["grad_norm"]),
                     float(m["aux"])])
    full = out[False][1]
    diff = max(float((a.double() - b.double()).abs().max())
               for (_, a), (_, b) in zip(flatten_named(full),
                                         flatten_named(ref)))
    donated_equal = all(torch.equal(a, b) for (_, a), (_, b) in
                        zip(flatten_named(full),
                            flatten_named(out[True][1])))
    return {"mesh": out[False][0], "one": want, "state_diff": diff,
            "donated_equal": donated_equal,
            "donated_metrics_equal": out[True][0] == out[False][0]}


def elastic(world, tmp, mode):
    """The reference's elastic E2E scenarios over ranks: ``shrink`` (2
    hosts x 2 ranks, (2, 2) -> (1, 2)), ``grow`` (the same, host 1 back),
    ``3d`` (tiny mixtral on (2, 2, 2) over 4 hosts x 2 ranks, host 1
    killed, experts degraded), ``dead`` (every host's beats stop)."""
    from repro_torch.core import (Dependability, DependabilityConfig,
                                  HeartbeatEmitter, MeshSpec,
                                  NoSurvivorsError, run_elastic)
    from repro_torch.data import ShardedPipeline
    from repro_torch.launch.mesh import host_device_map
    from repro_torch.train import init_state
    from repro_torch.train.mesh_step import (init_sharded_state,
                                             make_mesh_train_step,
                                             state_shardings)

    three = mode == "3d"
    cfg = _cfg("mixtral-8x7b" if three else "granite-3-8b")
    nh = 4 if three else 2
    hosts = host_device_map(nh)
    steps = {"shrink": 10, "grow": 14, "3d": 8, "dead": 10}[mode]
    r0 = world.rank == 0
    dep = Dependability(DependabilityConfig(
        checkpoint_dir=tmp, policy_mode="every_n", every_n=1,
        heartbeat=r0, heartbeat_period=PERIOD,
        heartbeat_timeout_factor=40.0, signal_detection=False,
        monitor_hosts=nh)).start()
    if r0:
        world.publish("monaddr", json.dumps(list(dep.monitor.addr)))
    addr = tuple(json.loads(world.fetch("monaddr")))
    my_host = next(h for h, rs in hosts.items() if world.rank in rs)
    em = None
    if hosts[my_host][0] == world.rank and my_host != 0:
        em = HeartbeatEmitter(my_host, addr, PERIOD).start()
    like = init_state(cfg, seed=0, device="meta")
    spec = (MeshSpec.from_config(cfg, data=2, model=2, expert=2)
            if three else None)

    def shardings_for(mesh, dead=()):
        ep = mesh.shape.get("expert", 1)
        return state_shardings(cfg, mesh, moe_ep=(ep if ep > 1 else False))

    def make_step(mesh, dead=()):
        c = dataclasses.replace(cfg, dead_experts=tuple(dead))
        return make_mesh_train_step(c, mesh, shardings_for(mesh, dead),
                                    like, total_steps=steps)

    data = (ShardedPipeline(cfg, 4, 12, dp_width=2) if three
            else ShardedPipeline(cfg, 16, 4, dp_width=2))

    def wait_for(pred, what, timeout=60.0):
        t = time.monotonic()
        while not pred():
            if time.monotonic() - t > timeout:
                raise TimeoutError(what)
            time.sleep(0.01)

    kill = [1] if mode != "dead" else list(range(nh))

    def on_metrics(s, rec):
        if s == 3 and not world.has("killed"):
            if em is not None and my_host in kill:
                em.pause()                      # fail-stop: beats stop
            if r0:
                if 0 in kill:
                    dep.emitter.pause()
                # the monitor's verdict, with a deadline (no sleep)
                wait_for(lambda: set(kill) <= set(dep.monitor.failed_hosts()),
                         "failure detected")
                world.publish("killed", "1")
        if mode == "grow" and s == 7 and r0 and not world.has("resume"):
            world.publish("resume", "1")
            wait_for(lambda: world.has("resumed"), "emitter resumed")
            wait_for(lambda: dep.on_host_rejoin.pending() == [1],
                     "rejoin detected")

    def on_idle():
        if (mode == "grow" and em is not None and world.has("resume")
                and not world.has("resumed")):
            em.resume()                         # the host comes back
            world.publish("resumed", "1")

    out = {}
    try:
        state, info = run_elastic(
            dep, make_step,
            lambda mesh, sh: init_sharded_state(cfg, sh, seed=0,
                                                device="cpu"),
            data, steps, world=world, host_devices=hosts, model_axis=2,
            mesh_spec=spec, degrade_experts=three, like=like,
            shardings_fn=shardings_for, on_metrics=on_metrics,
            on_idle=on_idle, control_timeout=120.0)
        out = {"status": info["status"],
               "events": [dataclasses.asdict(e) for e in info["events"]],
               "history": info["history"], "dp": info["dp"],
               "data": [data.dp_width, data.remapped_from],
               "member": state is not None,
               "meta": dep.manager.manifest_meta(dep.manager.latest_step())}
    except NoSurvivorsError as e:
        out = {"error": "NoSurvivorsError", "detail": str(e)}
    finally:
        if em is not None:
            em.stop()
        dep.stop()
    return out


def single_rank_losses(arch, steps, seq, batch, dead_at=None, dead=()):
    """An uninterrupted single-rank run (the elastic runs' reference):
    from step ``dead_at`` on the config degrades ``dead`` experts."""
    from repro_torch.data import ShardedPipeline
    from repro_torch.train import init_state, make_train_step

    torch.set_num_threads(1)
    cfg = _cfg(arch)
    data = ShardedPipeline(cfg, seq, batch, dp_width=1)
    live = make_train_step(cfg, total_steps=steps)
    degraded = make_train_step(dataclasses.replace(cfg, dead_experts=dead),
                               total_steps=steps)
    st = init_state(cfg, seed=0, device="cpu")
    out = []
    for s in range(1, steps + 1):
        fn = degraded if dead_at is not None and s > dead_at else live
        st, m = fn(st, data.next_batch())
        out.append(float(m["loss"]))
    return out


def compress(world, seed, rounds, n_elems):
    """``compressed_psum`` of each rank's gradients over ``rounds`` steps:
    the inputs, the reduced values and residuals, and the int8 payloads
    (all as numpy, for the parent to hold to the reference)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.compress import (compressed_psum, ef_state_init,
                                            quantize_int8)

    mesh = make_host_mesh(world.size, 1, rank=world.rank,
                          device=world.device)
    mesh.init_groups([("data",)])
    group = mesh.group(("data",))
    rng = np.random.default_rng(seed + world.rank)
    grads = {"a": torch.zeros(n_elems[0]), "b": torch.zeros(*n_elems[1])}
    ef = ef_state_init(grads)
    rec = []
    for _ in range(rounds):
        grads = {"a": torch.tensor(rng.standard_normal(n_elems[0])
                                   .astype(np.float32)),
                 "b": torch.tensor(rng.standard_normal(n_elems[1])
                                   .astype(np.float32) * 1e-3)}
        q = {k: quantize_int8(g.float() + ef[k])[:2]
             for k, g in grads.items()}
        red, new_ef = compressed_psum(grads, ef, group)
        rec.append({k: {"g": grads[k].numpy(), "ef": ef[k].numpy(),
                        "red": red[k].numpy(), "new_ef": new_ef[k].numpy(),
                        "q": q[k][0].numpy(), "s": q[k][1].numpy()}
                    for k in grads})
        ef = new_ef
    return rec


def step_values(leaves_np, k):
    """The leaves a save ``k`` saves after the first: each moved by ``k``
    x a fixed non-uniform pattern.  (A uniform shift would not do: the
    block hash, a position-weighted word sum mod 2^32 in both packages,
    does not see +1.0 added to every element of a block whose values all
    share a binade — each word moves by the same power of two and the
    weighted sum by a multiple of 2^32.)"""
    out = {}
    for name, v in leaves_np.items():
        rng = np.random.default_rng(len(name) + v.size)
        pat = rng.integers(1, 100, v.shape).astype(v.dtype)
        out[name] = np.asarray(v + (pat * k).astype(v.dtype))
    return out


def ckpt_save(world, tmp, grid, leaves_np, with_spec, codec=None,
              delta=False, steps=(1,), device_codec=False):
    """A sharded save of ``leaves_np`` (whole arrays) on ``grid``, each
    rank writing its shards (from its device); ``with_spec`` names each
    leaf's spec."""
    from repro_torch.core import CheckpointManager
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.api import P, resolve

    mesh = make_host_mesh(*grid, rank=world.rank, device=world.device)
    mesh.init_groups()
    pid = world.fetch("pid0") if world.rank else None
    if world.rank == 0:
        import os
        world.publish("pid0", str(os.getpid()))
        pid = str(os.getpid())
    mgr = CheckpointManager(tmp, host_id=world.rank, num_hosts=world.size,
                            owner_pid=int(pid), codec=codec, delta=delta,
                            delta_block=1024, keep=10,
                            device_codec=device_codec)
    like = {k: torch.from_numpy(v) for k, v in leaves_np.items()}
    sh = {k: resolve(P(*with_spec[k]), mesh) for k in leaves_np}
    for step in steps:
        vals = step_values(leaves_np, step - steps[0])
        state = {k: sh[k].local(torch.from_numpy(vals[k])).clone().to(
                     world.device) for k in like}
        mgr.save(step, state, mesh_meta={"grid": list(grid)},
                 shardings=sh, like=like)
    world.barrier("saved")
    mgr.close()
    return {"spans": {k: sh[k].spans(v.shape) for k, v in leaves_np.items()},
            "replica": {k: sh[k].replica_id() for k in leaves_np}}


def ckpt_restore(world, tmp, grid, shapes, with_spec, step=None,
                 device_codec=False):
    """Each rank's shards of every leaf restored onto ``grid`` (on its
    device), with the spans they should have (``leaves``; ``shapes``: name
    -> (shape, dtype name)), the device codec's decodes (``decodes``) and
    the dequantize kernel's launches (``dequantize``)."""
    from repro_torch.core import CheckpointManager
    from repro_torch.kernels.ckpt_codec.kernel import dequantize_blocks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.api import P, resolve

    mesh = make_host_mesh(*grid, rank=world.rank, device=world.device)
    mesh.init_groups()
    mgr = CheckpointManager(tmp, host_id=world.rank, num_hosts=world.size,
                            device_codec=device_codec)
    decodes = []
    if device_codec:
        decode = mgr._dcodec.decode

        def counted(q, scales, shape):
            decodes.append(q.device)
            return decode(q, scales, shape)
        mgr._dcodec.decode = counted
    like = {k: torch.empty(s, dtype=getattr(torch, d), device="meta")
            for k, (s, d) in shapes.items()}
    sh = {k: resolve(P(*with_spec[k]), mesh) for k in shapes}
    dequantize_blocks.launches = 0
    state, _ = mgr.restore(step=step, like=like, shardings=sh)
    mgr.close()
    assert all(state[k].device.type == world.device.type for k in shapes)
    return {"leaves": {k: (state[k].cpu().numpy(), sh[k].spans(shapes[k][0]))
                       for k in shapes},
            "decodes": [d.type for d in decodes],
            "dequantize": dequantize_blocks.launches}


def compress_card(world, seed, rounds, n_elems):
    """``compressed_psum`` on the rank's device (the card's codec
    kernels): the inputs, payloads, reduced values and residuals as numpy,
    and the codec kernels' launches."""
    from repro_torch.kernels.ckpt_codec.kernel import (dequantize_blocks,
                                                       quantize_blocks)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.compress import (compressed_psum, ef_state_init,
                                            quantize_int8)

    dev = world.device
    mesh = make_host_mesh(world.size, 1, rank=world.rank, device=dev)
    mesh.init_groups()
    group = mesh.group(("data",))
    rng = np.random.default_rng(seed + world.rank)
    ef = ef_state_init({"a": torch.zeros(n_elems, device=dev)})
    quantize_blocks.launches = dequantize_blocks.launches = 0
    rec = []
    for _ in range(rounds):
        g = {"a": torch.tensor(rng.standard_normal(n_elems)
                               .astype(np.float32), device=dev)}
        red, new_ef = compressed_psum(g, ef, group)
        q, s, _ = quantize_int8(g["a"] + ef["a"])
        rec.append({"g": g["a"].cpu().numpy(), "ef": ef["a"].cpu().numpy(),
                    "red": red["a"].cpu().numpy(),
                    "new_ef": new_ef["a"].cpu().numpy(),
                    "q": q.cpu().numpy(), "s": s.cpu().numpy()})
        ef = new_ef
    return {"rounds": rec, "quantize": quantize_blocks.launches,
            "dequantize": dequantize_blocks.launches}


def unshard(tree, shardings, like):
    """Whole leaves from every rank's shards (a check and test helper:
    every rank of the mesh calls it; the result is the same on all).
    ``like``: the tree of global shapes."""
    from repro_torch.sharding import comm
    from repro_torch.train.mesh_step import leaf_sizes
    from repro_torch.tree import flatten_named, leaves, unflatten

    out = []
    for (_, x), sh, (_, ref) in zip(flatten_named(tree), leaves(shardings),
                                    flatten_named(like)):
        if sh is None or not isinstance(x, torch.Tensor) or x.ndim == 0:
            out.append(x)
            continue
        for i, axes in enumerate(sh.dim_axes(x.ndim)):
            if not axes:
                continue
            if len(axes) > 1:
                raise NotImplementedError("a dim split over several axes")
            x = comm._cat_gather(
                x.contiguous(), sh.mesh.group(axes), i,
                leaf_sizes(ref.shape[i], sh.mesh.shape[axes[0]]))
        out.append(x)
    return unflatten(tree, out)


def chaos_compound(world, tmp, scenario_path, steps):
    """``compound.json`` through ``run_scenario_elastic`` on tiny granite,
    4 hosts x 2 ranks on (4, 2), saves every 2 steps, the scrubber over
    every leaf, the telemetry plane on rank 0 writing JSONL: each rank's
    run, and on rank 0 the log's round trip (``to_scenario``, replayed
    through ``ControlPlaneSim``), the incident timeline and the final
    parameters (whole, as numpy)."""
    import os

    from repro_torch.chaos import (ControlPlaneSim, Scenario,
                                   run_scenario_elastic)
    from repro_torch.core import (Dependability, DependabilityConfig,
                                  HeartbeatEmitter)
    from repro_torch.data import ShardedPipeline
    from repro_torch.launch.mesh import host_device_map
    from repro_torch.obs import Observability, Timeline, load_jsonl
    from repro_torch.obs import to_scenario
    from repro_torch.train import init_state
    from repro_torch.train.mesh_step import (init_sharded_state,
                                             make_mesh_train_step,
                                             state_shardings)
    from repro_torch.tree import flatten_named

    cfg = _cfg("granite-3-8b")
    hosts = host_device_map(4)
    r0 = world.rank == 0
    dep = Dependability(DependabilityConfig(
        checkpoint_dir=os.path.join(tmp, "ckpt"), policy_mode="every_n",
        every_n=2, keep=10, heartbeat=r0, heartbeat_period=PERIOD,
        heartbeat_timeout_factor=40.0, signal_detection=False, scrub=True,
        scrub_fraction=1.0, monitor_hosts=4)).start()
    jsonl = os.path.join(tmp, "events.jsonl")
    ems = {}
    if r0:
        dep.attach_obs(Observability(jsonl_path=jsonl))
        world.publish("monaddr", json.dumps(list(dep.monitor.addr)))
        ems[0] = dep.emitter                 # host 0 beats from dep itself
    addr = tuple(json.loads(world.fetch("monaddr")))
    my_host = next(h for h, rs in hosts.items() if world.rank in rs)
    if hosts[my_host][0] == world.rank and my_host != 0:
        ems[my_host] = HeartbeatEmitter(my_host, addr, PERIOD).start()
    like = init_state(cfg, seed=0, device="meta")

    def shardings_for(mesh):
        return state_shardings(cfg, mesh)

    def make_step(mesh):
        return make_mesh_train_step(cfg, mesh, shardings_for(mesh), like,
                                    warmup_steps=0, total_steps=steps)

    sc = Scenario.from_json(scenario_path)
    leaf_names = [n for n, _ in flatten_named(like)
                  if n.startswith("params.") and "attn.wk" in n]
    data = ShardedPipeline(cfg, 16, 8, dp_width=4)
    try:
        state, info = run_scenario_elastic(
            dep, make_step,
            lambda mesh, sh: init_sharded_state(cfg, sh, seed=0,
                                                device="cpu"),
            data, steps, world=world, scenario=sc, emitters=ems,
            host_devices=hosts, model_axis=2, like=like,
            shardings_fn=shardings_for, leaf_names=leaf_names,
            control_timeout=120.0)
        out = {"status": info["status"], "dp": info["dp"],
               "rollbacks": info["rollbacks"],
               "events": [dataclasses.asdict(e) for e in info["events"]],
               "history": info["history"], "report": info["report"],
               "member": state is not None,
               "mismatches": list(dep.scrubber.mismatches)}
        if state is not None:
            full = unshard(state, dep._global_shardings, like)
            if r0:
                out["params"] = {n: v.numpy() for n, v in
                                 flatten_named(full["params"])}
        if r0:
            dep.obs.close()
            rec = load_jsonl(jsonl)
            back = to_scenario(rec)
            sim = ControlPlaneSim(4, devices_per_host=2,
                                  model_axis=2).run(back)
            out.update(
                scenario=back.to_dict(),
                sim_invariants=[(r.name, bool(r.passed))
                                for r in sim.invariants],
                sim_detected=sorted(d["host"] for d in sim.detections),
                timeline=Timeline.from_events(rec).summary())
    finally:
        for h, em in ems.items():
            if h != 0:
                em.stop()
        dep.stop()
    return out


def chaos_one_rank(world, tmp, scenario_dict, steps, signals=False):
    """A scenario on 2 hosts x 1 rank, (1, 2), the scrubber on, saves
    every 2 steps (``signals``: rank 0's facade detects termination
    signals): each rank's run, the leaves its own scrubber found corrupt
    and the newest checkpoint."""
    import os

    from repro_torch.chaos import Scenario, run_scenario_elastic
    from repro_torch.core import (Dependability, DependabilityConfig,
                                  HeartbeatEmitter)
    from repro_torch.data import ShardedPipeline
    from repro_torch.train import init_state
    from repro_torch.train.mesh_step import (init_sharded_state,
                                             make_mesh_train_step,
                                             state_shardings)
    from repro_torch.tree import flatten_named

    cfg = _cfg("granite-3-8b")
    hosts = {0: [0], 1: [1]}
    r0 = world.rank == 0
    dep = Dependability(DependabilityConfig(
        checkpoint_dir=os.path.join(tmp, "ckpt"), policy_mode="every_n",
        every_n=2, heartbeat=r0, heartbeat_period=PERIOD,
        heartbeat_timeout_factor=40.0, signal_detection=signals and r0,
        scrub=True, scrub_fraction=1.0, monitor_hosts=2)).start()
    if r0:
        world.publish("monaddr", json.dumps(list(dep.monitor.addr)))
        ems = {0: dep.emitter}
    else:
        addr = tuple(json.loads(world.fetch("monaddr")))
        ems = {1: HeartbeatEmitter(1, addr, PERIOD).start()}
    like = init_state(cfg, seed=0, device="meta")

    def make_step(mesh):
        return make_mesh_train_step(cfg, mesh, state_shardings(cfg, mesh),
                                    like, warmup_steps=0, total_steps=steps)

    try:
        state, info = run_scenario_elastic(
            dep, make_step,
            lambda mesh, sh: init_sharded_state(cfg, sh, seed=0,
                                                device="cpu"),
            ShardedPipeline(cfg, 16, 4, dp_width=1), steps, world=world,
            scenario=Scenario.from_dict(scenario_dict), emitters=ems,
            host_devices=hosts, model_axis=2, like=like,
            shardings_fn=lambda mesh: state_shardings(cfg, mesh),
            control_timeout=120.0)
        full = unshard(state, dep._global_shardings, like)
        return {"status": info["status"], "rollbacks": info["rollbacks"],
                "events": [h for h in info["history"] if "event" in h],
                "losses": [h["loss"] for h in info["history"]
                           if "loss" in h],
                "mismatches": list(dep.scrubber.mismatches),
                "report": info["report"],
                "sdc_injected": info["report"]["sdc_injected"],
                "latest": dep.manager.latest_step(),
                "step": int(state["step"]),
                "params": {n: v.numpy() for n, v in
                           flatten_named(full["params"])}}
    finally:
        if not r0:
            ems[1].stop()
        dep.stop()


def flip_shards(world, flips):
    """Tiny granite's state sharded on (2, 2); ``flips`` ((leaf, bit)
    pairs) applied through a ``FaultInjector`` that knows the layout.
    The whole leaves before and after (numpy), the same on every rank."""
    from repro_torch.core import FaultInjector
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import init_state
    from repro_torch.train.mesh_step import (init_sharded_state,
                                             mesh_combos, state_shardings)
    from repro_torch.tree import flatten_named

    cfg = _cfg("granite-3-8b")
    mesh = make_host_mesh(2, 2, rank=world.rank, device=world.device)
    mesh.init_groups(mesh_combos(mesh))
    sh = state_shardings(cfg, mesh)
    like = init_state(cfg, seed=0, device="meta")
    st = init_sharded_state(cfg, sh, seed=0, device="cpu")
    before = unshard(st, sh, like)
    inj = FaultInjector()
    inj.layout = lambda: (like, sh)
    for leaf, bit in flips:
        inj.schedule_bitflip(1, leaf, bit)
    after = unshard(inj.apply_sdc(1, st), sh, like)
    names = sorted({leaf for leaf, _ in flips})
    return {"before": {n: v.numpy() for n, v in flatten_named(before)
                       if n in names},
            "after": {n: v.numpy() for n, v in flatten_named(after)
                      if n in names},
            "injected": inj.sdc_injected}


def reduce_scatter_vs_sum(world, seed):
    """``comm.reduce_scatter`` against ``comm.ordered_sum`` sliced, and
    ``ordered_sum`` against the group-order sum of every rank's tensor
    drawn again here, bit for bit, for float32 and bfloat16 tensors split
    along each dim in even, uneven and empty slices; and ``gather_sum``'s
    gradient through it."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import comm

    mesh = make_host_mesh(world.size, 1, rank=world.rank,
                          device=world.device)
    mesh.init_groups([("data",)])
    group = mesh.group(("data",))
    n, r = world.size, world.rank
    gens = [torch.Generator().manual_seed(seed * 97 + p) for p in range(n)]
    gen = gens[r]
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape, dim, sizes in (((8, 6), 0, [2] * n),
                                  ((5, 7, 3), 1, [2, 2, 2, 1][:n]),
                                  ((6, 4), 0, [3, 3, 0, 0][:n]),
                                  ((3, 9), 1, [3, 3, 3, 0][:n])):
            if sum(sizes) != shape[dim]:
                sizes = sizes[:-1] + [shape[dim] - sum(sizes[:-1])]
            xs = [(torch.randn(shape, generator=g) * 10).to(dtype)
                  for g in gens]
            x = xs[r]
            got = comm.reduce_scatter(x, group, dim, sizes)
            full = comm.ordered_sum(x, group)
            acc = xs[0].to(torch.float32).clone()
            for p in xs[1:]:
                acc += p.to(torch.float32)
            want = full.narrow(dim, sum(sizes[:r]), sizes[r])
            out.append(bool(got.dtype == want.dtype
                            and got.shape == want.shape
                            and torch.equal(got, want)
                            and torch.equal(full, acc.to(dtype))))
            out.append(got)
    # gather_sum's gradient: each rank's slice of the group-order sum
    w = torch.randn(3, 4, generator=gen, requires_grad=True)
    full = comm.gather_sum(w, group, 0, [3] * n)
    g = torch.randn(full.shape, generator=gen)
    (full * g).sum().backward()
    want = comm.ordered_sum(g, group).narrow(0, 3 * r, 3)
    out.append(bool(torch.equal(w.grad, want)))
    out.append(w.grad)
    return out


def mesh_step_save(world, tmp, arch, grid, cfg_kw=None):
    """One mesh step of tiny ``arch`` (float32) on ``grid``, then a
    sharded save of the state, every rank writing its shards; returns
    the whole state after the step (numpy, by name)."""
    import os

    from repro_torch.core import CheckpointManager
    from repro_torch.data import ShardedPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import init_state
    from repro_torch.train.mesh_step import (init_sharded_state,
                                             make_mesh_train_step,
                                             mesh_combos, state_shardings)
    from repro_torch.tree import flatten_named

    cfg = _cfg(arch, **(cfg_kw or {}))
    mesh = make_host_mesh(*grid, rank=world.rank, device=world.device)
    mesh.init_groups(mesh_combos(mesh))
    sh = state_shardings(cfg, mesh)
    like = init_state(cfg, seed=0, device="meta")
    st = init_sharded_state(cfg, sh, seed=0, device="cpu", world=world)
    step = make_mesh_train_step(cfg, mesh, sh, like, total_steps=10)
    st, _ = step(st, ShardedPipeline(cfg, 16, 8, dp_width=1).next_batch())
    if world.rank == 0:
        world.publish("pid0", str(os.getpid()))
    pid = int(world.fetch("pid0"))
    mgr = CheckpointManager(tmp, host_id=world.rank, num_hosts=world.size,
                            owner_pid=pid)
    mgr.save(1, st, mesh_meta={"grid": list(grid)}, shardings=sh, like=like)
    world.barrier("saved")
    mgr.close()
    full = unshard(st, sh, like)
    return {n: x.numpy() for n, x in flatten_named(full)}
