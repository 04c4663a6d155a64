"""The PyTorch port stands alone: it imports neither ``jax`` nor anything of
the JAX package, builds nothing at import time, and never takes the CPU
unless asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers beside
    timing-sensitive multi-process tests, and idle OpenMP threads spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_jax():
    """In a fresh interpreter where ``import jax`` and ``import repro``
    fail, every module of the port and chip_smoke.py import, and the
    kernel library stays unbuilt."""
    script = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
import repro_torch
mods = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    mods.append(info.name)
import chip_smoke
from repro_torch.kernels import build
assert build._lib is None, "kernels built at import time"
print(len(mods))
"""
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 30     # every module was walked


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No result without a card, and none from a copy of the script
    alone, away from the package it drives."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_resolve_device_raises_without_a_card():
    from repro_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card():
    from repro_torch.models import get_config, init_params
    from repro_torch.serve import ServeEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("granite-3-8b", tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, seed=0)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)


def test_non_cpu_tensors_never_take_the_plain_version():
    """ops dispatch on the device: only a CPU tensor reaches the plain
    version.  A meta tensor (a traced step, ``kernels/meta.py``) gets the
    kernel's outputs from its meta op, never the plain version's
    products; the kernel wrappers, and an op without a meta twin, refuse
    what is not on a CUDA device instead of falling back."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_bshd
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.paged_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.rmsnorm.kernel import rms_norm_2d
    from repro_torch.kernels.rmsnorm.ops import rms_norm

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func._overloadpacket))
            return func(*args, **(kwargs or {}))

    m = torch.device("meta")
    q = torch.empty(1, 8, 4, 16, device=m)
    kv = torch.empty(1, 8, 2, 16, device=m)
    x, w = torch.empty(4, 64, device=m), torch.empty(64, device=m)
    with Ops() as ops:
        y = rms_norm(x, w)
        o = flash_attention(q, kv, kv)
    assert y.device == m and o.device == m and o.shape == q.shape
    assert [n for n in ops.names if not n.startswith("aten.")] == [
        "repro_torch.rmsnorm_fwd", "repro_torch.flash_fwd"]
    # the plain versions' arithmetic never ran
    assert not {"aten.bmm", "aten.mm", "aten._softmax", "aten.rsqrt",
                "aten.pow", "aten.mean", "aten.mul"} & set(ops.names)
    with pytest.raises(ValueError, match="CUDA"):
        rms_norm_2d(torch.empty(4, 64, device=m), torch.empty(64, device=m))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bshd(q, kv, kv)
    pages = torch.empty(5, 4, 2, 16, device=m)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(
            torch.empty(2, 1, 4, 16, device=m), pages, pages,
            torch.zeros(2, 3, dtype=torch.int32, device=m),
            torch.zeros(2, dtype=torch.int32, device=m))


def test_paged_engine_only():
    """An attention stack pages by default; ``paged=False`` serves it from
    the slot pool."""
    from repro_torch.models import get_config, init_params
    from repro_torch.serve import CachePool, PagedKVCache, ServeEngine

    cfg = get_config("granite-3-8b", tiny=True)
    params = init_params(cfg, seed=0, device="cpu")
    eng = ServeEngine(cfg, params, device="cpu", max_len=16)
    assert eng.paged
    assert isinstance(eng.router.replicas[0].pool, PagedKVCache)
    eng.shutdown()
    eng = ServeEngine(cfg, params, device="cpu", max_len=16, paged=False)
    assert not eng.paged
    assert isinstance(eng.router.replicas[0].pool, CachePool)
    rid = eng.submit([3, 1, 4], 3)
    out = eng.run()
    eng.shutdown()
    assert len(out[rid]) == 3
