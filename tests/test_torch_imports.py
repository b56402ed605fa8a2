"""The PyTorch port stands alone: it never imports JAX or the JAX package."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
# every module of the port; the walk below must find each of them
MODULES = ("core.kernels", "core.regularization", "core.nfft",
           "core.fastsum_exec", "core.fastsum", "core.lanczos", "core.error",
           "core.solvers", "kernels._build", "kernels.nfft_window",
           "kernels.kernel_matvec", "kernels.flash_attention",
           "graph.spectral", "graph.ssl", "graph.krr", "runtime.guards",
           "data.synthetic", "device", "quickstart", "ssl_crescent",
           "configs", "configs.base", "configs.archs", "models.common",
           "models.mlp", "models.attention", "models.model",
           "models.mamba",
           "serving.engine", "serving.graph", "launch.serve",
           "launch.trace_serve",
           "launch.time_window", "launch.time_kernel_matvec",
           "launch.time_flash",
           "core.nystrom", "image_segmentation", "figures", "figures.common",
           "figures.fig3_eigenvalues", "figures.fig5_segmentation",
           "figures.fig6_phasefield", "figures.fig7_kernel_ssl",
           "figures.fig8_kernel_ssl_laplacian", "figures.fig9_krr",
           "figures.run", "runtime.durable", "runtime.faultinject",
           "training", "training.checkpoint", "training.fault_tolerance",
           "serving.journal", "models.nfft_attention", "tree",
           "training.optimizer", "training.train_loop", "data.pipeline",
           "dist", "dist.compression", "launch.train", "train_lm",
           "launch.trace_train", "dist.fastsum_dist", "dist.pencil_fft",
           "launch.mesh", "launch.ranks", "dist.sharding", "launch.steps",
           "launch.specs", "launch.roofline", "launch.dryrun")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import pkgutil, sys\n"
        "import repro_torch\n"
        "found = set()\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "    found.add(m.name)\n"
        f"missing = {{'repro_torch.' + m for m in {MODULES!r}}} - found\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_source_file_names_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, (path, bad)


def _reexported(init: Path) -> list:
    """The names a package's ``__init__.py`` imports from its modules:
    its public surface, whatever else other code has imported since."""
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module != "__future__":
            names += [a.asname or a.name for a in node.names]
    return sorted(n for n in names if not n.startswith("_"))


@pytest.mark.parametrize("package", ["core", "data", "training"])
def test_reference_surface_names_import_from_the_port(package):
    """Every name that ``repro.core`` / ``repro.data`` re-exports
    (functions, classes and constants) imports from the port's package of
    the same name, so code written against the reference's imports runs
    on the port."""
    names = _reexported(ROOT / "src" / "repro" / package / "__init__.py")
    assert len(names) > 3
    port = importlib.import_module(f"repro_torch.{package}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing
    for name in names:
        exec(f"from repro_torch.{package} import {name}", {})


def test_dist_exports_the_reference_compression_names():
    """``repro.dist`` re-exports its compression module's names; the
    port's ``dist`` package exports the same."""
    tree = ast.parse((ROOT / "src" / "repro" / "dist" / "__init__.py")
                     .read_text())
    names = [a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom)
             and node.module == "repro.dist.compression"
             for a in node.names]
    assert len(names) == 6
    port = importlib.import_module("repro_torch.dist")
    assert [n for n in names if not hasattr(port, n)] == []


def test_dist_exports_the_reference_surface_but_sharding():
    """The port's ``dist`` exports every name of ``repro.dist.__all__``
    but ``shard_map`` (a jax version shim, no twin): since the sharded
    train step, the sharding rules too (the name is the test's from
    before they came)."""
    tree = ast.parse((ROOT / "src" / "repro" / "dist" / "__init__.py")
                     .read_text())
    names = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and node.targets[0].id == "__all__")
    sharding = {a.asname or a.name for node in tree.body
                if isinstance(node, ast.ImportFrom)
                and node.module == "repro.dist.sharding" for a in node.names}
    assert len(sharding) == 6 and sharding <= set(names)
    wanted = set(names) - {"shard_map"}
    assert len(wanted) == 20
    port = importlib.import_module("repro_torch.dist")
    assert sorted(n for n in wanted if not hasattr(port, n)) == []
