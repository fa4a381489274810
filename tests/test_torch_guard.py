"""Guard: the PyTorch port, ``chip_smoke.py`` and the ``perf/`` scripts never
import jax or the reference package, neither at run time nor anywhere in
their source."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")  # top-level package names


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = list(_port_modules())
    assert "repro_torch.core.solver" in mods and "repro_torch.krylov.api" in mods
    assert "repro_torch.models.model" in mods and "repro_torch.serve.engine" in mods
    assert {"repro_torch.train.step", "repro_torch.checkpoint.manager",
            "repro_torch.launch.train", "repro_torch.distributed.sharding",
            "repro_torch.launch.specs", "repro_torch.distributed.constraints"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_jax_or_reference_import_in_the_source():
    files = (sorted(PORT.rglob("*.py")) + sorted((ROOT / "perf").glob("*.py"))
             + [ROOT / "chip_smoke.py"])
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                          if n.split(".")[0] in FORBIDDEN]
    assert not offenders, offenders
