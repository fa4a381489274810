"""What the kernel-variant scripts (``perf/spmv_variants.py``,
``perf/trsm_variants.py``, ``perf/trsv_variants.py``) share: a copy of
``src/`` with one CUDA source edited, ``ptxas``'s registers per kernel,
device time from ``torch.profiler``, this checkout's bit oracles, and the
loop that checks and times each tree in a child process of its own (each
tree's ``repro_torch`` is imported fresh). Needs a CUDA device and
``nvcc``.
"""
from __future__ import annotations

import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")


def replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"expected one {old[:60]!r}, found {src.count(old)}")
    return src.replace(old, new)


def edits(*pairs):
    """An edit that replaces each ``old`` (found exactly once) by ``new``."""
    def edit(src: str) -> str:
        for old, new in pairs:
            src = replace_once(src, old, new)
        return src
    return edit


def variant_tree(kind: str, name: str, source: str, edit) -> Path:
    """A copy of ``src/`` under ``build/<kind>/<name>/`` with ``edit``
    applied to ``csrc/<source>.cu`` (``None``: the source as it is)."""
    out = ROOT / "build" / kind / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copytree(ROOT / "src", out / "src", ignore=shutil.ignore_patterns("__pycache__"))
    if edit is not None:
        path = out / CSRC / f"{source}.cu"
        path.write_text(edit(path.read_text()))
    return out


def _kernel_name(mangled: str) -> str:
    """The last name of an Itanium-mangled nested name (the function's)."""
    rest, names = mangled.removeprefix("_ZN"), []
    while (size := re.match(r"\d+", rest)):
        n, rest = int(size.group()), rest[size.end():]
        names.append(rest[:n])
        rest = rest[n:]
    return names[-1] if names else mangled


def resource_usage(tree: Path, source: str) -> str:
    """``ptxas``'s registers and spills per kernel of the tree's
    ``csrc/<source>.cu``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import extension

    flags = [f for f in extension.NVCC_FLAGS if f.startswith(("-O", "-std", "-gencode"))]
    run = subprocess.run([extension.nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
                          str(tree / f"{source}.cubin"), str(tree / CSRC / f"{source}.cu")],
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        return f"nvcc failed: {run.stderr[-2000:]}"
    usage, name = {}, None
    for line in run.stderr.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name = _kernel_name(hit.group(1))
        elif name and ("registers" in line or "spill" in line):
            usage.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return " | ".join(f"{n}: {'; '.join(v)}" for n, v in usage.items())


def oracles():
    """This checkout's ``kernels/ref.py`` (bit oracles included), loaded on
    its own, so every tree, the parent's too, is held to the same bits."""
    spec = importlib.util.spec_from_file_location(
        "bit_oracles", ROOT / "src/repro_torch/kernels/ref.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def device_ms(fn, kernel: str, iters: int = 50) -> float | None:
    """Mean device ms per call of the kernels matching ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and re.search(kernel, e.key))
    return us / 1e3 / iters if us > 0 else None


def run_trees(tag: str, script: Path, source: str, trees: list, make_tree, child_args: list):
    """Print the card line; then for each ``(label, path)`` in ``trees``
    (``path`` None: ``make_tree(label)`` builds it) the registers of its
    ``csrc/<source>.cu`` and the lines of ``script --time <src> <label>
    *child_args``, run in a child process."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60)
    print(f"[{tag}] card: {card.stdout.strip() or 'nvidia-smi failed'}", flush=True)
    for label, tree in trees:
        try:
            tree = tree or make_tree(label)
        except ValueError as e:
            print(f"[{tag}] {label}: edit does not apply: {e}", flush=True)
            continue
        print(f"[{tag}] {label} ptxas: {resource_usage(tree, source)}", flush=True)
        run = subprocess.run([sys.executable, str(script), "--time", str(tree / "src"), label,
                              *child_args], capture_output=True, text=True, timeout=900)
        print(run.stdout, end="", flush=True)
        if run.returncode != 0:
            print(f"[{tag}] {label}: failed (exit {run.returncode}): {run.stderr[-3000:]}",
                  flush=True)
