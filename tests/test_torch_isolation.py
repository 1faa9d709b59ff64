"""pilosa_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless asked for the CPU."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pilosa_tpu_torch
from pilosa_tpu_torch.core import Holder
from pilosa_tpu_torch.device import resolve_device

PKG = Path(pilosa_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "pilosa_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not (_imported_roots(path) & set(FORBIDDEN))


def test_import_pulls_in_no_jax():
    """Importing every module of the package, in a fresh interpreter,
    loads no JAX module."""
    code = (
        "import pkgutil, sys, pilosa_tpu_torch\n"
        "for m in pkgutil.walk_packages(pilosa_tpu_torch.__path__, 'pilosa_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pilosa_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Holder()
    with pytest.raises(RuntimeError):
        Holder(device="cuda")
    assert Holder(device="cpu").device == torch.device("cpu")


def test_unsupported_device_refused():
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_every_kernel_source_is_bound():
    """Each csrc/*.cu the build compiles has its C signatures in
    ops/kernels.py, and each signature table names a source that exists
    (the GroupBy lattice's group_kernels.cu among them), with a launch
    counter for every wrapper."""
    from pilosa_tpu_torch.ops import build, kernels
    sources = {p.name for p in build.CSRC_DIR.glob("*.cu")}
    assert sources == set(kernels._SIGNATURES)
    assert "group_kernels.cu" in sources and "group_count" in kernels.LAUNCHES


def test_every_c_entry_point_has_a_signature():
    """Each ``extern "C"`` function of a csrc/*.cu has its argtypes in
    ops/kernels.py's table under that source, and the table names no
    function the source lacks."""
    from pilosa_tpu_torch.ops import build, kernels
    for src in build.CSRC_DIR.glob("*.cu"):
        names = set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
        assert names == set(kernels._SIGNATURES[src.name]), src.name


CLUSTER_MODULES = ("cluster/placement.py", "cluster/event.py", "cluster/breaker.py",
                   "cluster/client.py", "cluster/scrub.py", "cluster/cluster.py",
                   "cluster/dirty.py", "cluster/resize.py", "cluster/harness.py",
                   "cache/remote.py", "exec/device_reduce.py", "server/wire.py",
                   "server/httpclient.py")


@pytest.mark.parametrize("module", CLUSTER_MODULES)
def test_cluster_modules_stand_alone(module):
    """The cluster slice's modules are the port's own copies: present,
    importing neither JAX nor the JAX package."""
    path = PKG / module
    assert path.is_file()
    assert not (_imported_roots(path) & set(FORBIDDEN))


def test_reduce_kernels_are_bound():
    """csrc/reduce_kernels.cu's three C entry points are the signature
    table's for it, each with a launch counter."""
    from pilosa_tpu_torch.ops import build, kernels
    src = (build.CSRC_DIR / "reduce_kernels.cu").read_text()
    names = set(re.findall(r'extern "C" int (\w+)\(', src))
    assert names == set(kernels._SIGNATURES["reduce_kernels.cu"]) == {
        "pilosa_scatter_bits_grouped", "pilosa_scatter_bits", "pilosa_or_fold"}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        assert len(params.split(",")) == len(kernels._SIGNATURES["reduce_kernels.cu"][name])
    assert {"scatter_bits_grouped", "scatter_bits", "or_fold"} <= set(kernels.LAUNCHES)


ELASTIC_MODULES = ("faults", "sync", "cleaner", "migration", "translate_sync", "resize",
                   "scrub")


@pytest.mark.parametrize("name", ELASTIC_MODULES)
def test_elastic_cluster_modules_are_checked(name):
    """The elastic cluster's modules are the port's own copies, in the set
    ``test_no_jax_imports`` walks, and import nothing of JAX or the JAX
    package, at module level or inside a function."""
    path = PKG / "cluster" / f"{name}.py"
    assert path in set(PKG.rglob("*.py"))
    assert not (_imported_roots(path) & set(FORBIDDEN))
    code = (f"import sys, pilosa_tpu_torch.cluster.{name}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pilosa_tpu')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_elastic_entry_points_default_to_the_card(monkeypatch):
    """A joining node and an in-process cluster grown by ``add_node`` run
    on the card unless asked for the CPU."""
    from pilosa_tpu_torch.cluster.harness import LocalCluster
    from pilosa_tpu_torch.server.node import ServerNode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServerNode(bind="127.0.0.1:19999", join="127.0.0.1:1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalCluster(2)
    lc = LocalCluster(2, device="cpu")
    assert lc.add_node().holder.device == torch.device("cpu")
