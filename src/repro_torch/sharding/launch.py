"""The port's rank runner: one process a rank.

``spawn(fn, nprocs, run_dir=...)`` starts ``nprocs`` processes with
``torch.multiprocessing`` (the ``spawn`` start method, which CUDA
needs), joins them into one ``gloo`` process group over a ``FileStore``
in ``run_dir`` (no TCP port, so runs side by side cannot collide), and
calls ``fn(world, *args)`` in each.  ``world`` (``World``) is the rank's
view of the run: its rank, the run's size, its device and the store, with
the store-based barrier and publish/fetch helpers the elastic loop's
control plane uses.  Every rank of a run places its tensors on ``device``
(on the card: all on ``cuda:0``).

Each rank's return value is pickled to ``run_dir``; ``spawn`` returns
them in rank order.  A rank that raises, exits non-zero, or is still
running at ``join_timeout`` makes ``spawn`` stop every rank and raise
``RuntimeError`` with the failing rank's traceback.
"""
from __future__ import annotations

import os
import pickle
import shutil
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def backoff(pause: float) -> float:
    """Sleep ``pause`` seconds and return the next pause of a poll loop:
    doubling from 1 ms to 50 ms, so a rank that waits long (outside the
    mesh, at a barrier) reads the store a few times a second and leaves
    the host's cores to the ranks that compute."""
    time.sleep(pause)
    return min(2 * pause, 0.05)


class World:
    """One rank's view of a run."""

    def __init__(self, rank: int, size: int, store, device,
                 run_dir: str):
        self.rank = rank
        self.size = size
        self.store = store
        self.device = torch.device(device)
        self.run_dir = run_dir
        self._counts: dict = {}

    def _next(self, name: str) -> str:
        n = self._counts.get(name, 0)
        self._counts[name] = n + 1
        return f"{name}#{n}"

    def publish(self, key: str, value: str) -> None:
        self.store.set(key, value)

    def fetch(self, key: str, timeout: float = 600.0) -> str:
        """The value at ``key``, waiting up to ``timeout`` seconds."""
        self.wait_keys([key], timeout)
        return self.store.get(key).decode()

    def has(self, key: str) -> bool:
        return self.store.check([key])

    def wait_keys(self, keys: Sequence[str], timeout: float,
                  poll: Optional[Callable[[], None]] = None) -> None:
        """Wait until every key is set; ``poll()`` runs between checks."""
        deadline = time.monotonic() + timeout
        pause = 0.001
        while not self.store.check(list(keys)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {self.rank}: keys {list(keys)} "
                                   f"not set within {timeout} s")
            if poll is not None:
                poll()
            pause = backoff(pause)

    def barrier(self, name: str, ranks: Optional[Sequence[int]] = None,
                timeout: float = 600.0,
                poll: Optional[Callable[[], None]] = None) -> None:
        """Store barrier over ``ranks`` (default: every rank); each call
        with the same ``name`` is a new barrier."""
        ranks = list(range(self.size)) if ranks is None else list(ranks)
        key = self._next(f"barrier/{name}/{','.join(map(str, ranks))}")
        self.store.set(f"{key}/{self.rank}", "1")
        self.wait_keys([f"{key}/{r}" for r in ranks], timeout, poll)


def _entry(rank: int, nprocs: int, run_dir: str, fn: Callable, args,
           device: str) -> None:
    # one intra-op thread a rank: the ranks share the host's cores
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(run_dir, "store"), nprocs)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=nprocs)
    world = World(rank, nprocs, store, device, run_dir)
    # the ranks share this host: their collectives exchange through files
    from repro_torch.sharding import comm
    comm.set_host_dir(os.path.join(run_dir, "comm"))
    try:
        if world.device.type == "cuda":
            torch.cuda.set_device(world.device.index or 0)
        out = fn(world, *args)
        with open(os.path.join(run_dir, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(run_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        try:
            dist.destroy_process_group()
        except Exception:
            pass


def spawn(fn: Callable, nprocs: int, *, run_dir: str, args=(),
          device: str = "cpu", join_timeout: float = 600.0) -> List[Any]:
    """Run ``fn(world, *args)`` on ``nprocs`` ranks; their results in
    rank order.  ``fn`` must be importable by name (a module-level
    function)."""
    os.makedirs(run_dir, exist_ok=True)
    for name in os.listdir(run_dir):
        if name == "store" or name.startswith(("result_", "error_")):
            os.remove(os.path.join(run_dir, name))
    shutil.rmtree(os.path.join(run_dir, "comm"), ignore_errors=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(r, nprocs, run_dir, fn, args, device),
                         daemon=False)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + join_timeout
    failed = None
    try:
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with code {codes[bad[0]]}"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = (f"ranks {[r for r, c in enumerate(codes) if c is None]}"
                          f" still running after {join_timeout} s")
                break
            time.sleep(0.05)
    finally:
        if failed is not None or any(p.is_alive() for p in procs):
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join(5)
    if failed is not None:
        detail = ""
        for r in range(nprocs):
            path = os.path.join(run_dir, f"error_{r}.txt")
            if os.path.exists(path):
                with open(path) as f:
                    detail = f"\n--- rank {r} ---\n{f.read()}"
                break
        raise RuntimeError(f"spawn: {failed}{detail}")
    out = []
    for r in range(nprocs):
        with open(os.path.join(run_dir, f"result_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
