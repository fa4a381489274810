"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared library
with a plain C interface, loaded with :mod:`ctypes`; no source includes
PyTorch's headers, so a build takes seconds rather than minutes. Device code
that several sources share lives in ``csrc/*.cuh``. Builds happen at first
use (or through :func:`build`, which compiles every source in parallel) into
``build/torch_ext/`` at the repository root, a directory ``.gitignore``
lists. A library is named by a digest of its source, the shared headers and
the compiler flags, so an edited source never loads a stale build.

Flags: ``-O3`` and no ``--use_fast_math``: the row sweep's division
``(r_i - s) / L[i, i]`` must stay an IEEE division. ``-cudart shared`` links
each library against ``libcudart.so.12`` rather than a static copy. Loaded
after ``import torch``, that name resolves to the runtime PyTorch already
loaded, so the kernels and PyTorch share one runtime: one primary context,
PyTorch's stream handles, and one error state, from which each entry point
returns ``cudaGetLastError()`` right after its launch.

This builder stands in for ``torch.utils.cpp_extension.load``. That call
compiles a binding file against PyTorch's headers and needs ``ninja``;
``perf/build_cost.py`` measures both builders on the GPU machine.

Nothing here runs at import: the CPU tests import every module of the port
on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = ("block_trsv", "block_spmv", "superstep")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-cudart", "shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every entry point: pointers and the stream as void*, sizes as int
SIGNATURES = {
    "block_trsv": {"repro_trsv_f32": (_P, _P, _P, _I, _I, _P),
                   "repro_trsv_panel_f32": (_P, _P, _P, _I, _I, _I, _P),
                   "repro_trsm_f32": (_P, _P, _P, _I, _I, _I, _P)},
    "block_spmv": {"repro_gemv_f32": (_P, _P, _P, _I, _I, _P),
                   "repro_gemv_grouped_f32": (_P, _P, _P, _I, _I, _I, _P),
                   "repro_gemm_f32": (_P, _P, _P, _I, _I, _I, _P)},
    # nine table pointers, eight tensor pointers (the flags last), then the sizes
    "superstep": {"repro_superstep_f32": (_P,) * 17 + (_I,) * 9 + (_P,),
                  "repro_superstep_panel_f32": (_P,) * 17 + (_I,) * 10 + (_P,),
                  # eight table pointers, seven tensor pointers, then the sizes
                  "repro_superstep_streamed_f32": (_P,) * 15 + (_I,) * 13 + (_P,),
                  # the split form: eight table pointers, seven tensor pointers
                  "repro_superstep_split_f32": (_P,) * 15 + (_I,) * 9 + (_P,),
                  # seven table pointers, six tensor pointers
                  "repro_superstep_streamed_split_f32": (_P,) * 13 + (_I,) * 12 + (_P,)},
}


# entry points that launch nothing: (argument types, result type)
QUERIES = {
    "superstep": {"repro_superstep_shared_bytes": ((_I,) * 5, ctypes.c_size_t),
                  "repro_superstep_streamed_grid": ((_I,) * 6, ctypes.c_int)},
}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((str(Path(home) / "bin" / "nvcc")) if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # the sources' shared device code
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names: tuple = SOURCES) -> dict:
    """Compile every missing library in ``names``, one ``nvcc`` each, all
    started together. Returns ``{name: path}``; raises with the compiler's
    output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).is_file()}
    procs = {}
    for name, out in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, todo[name])  # atomic: a reader never sees half a library
        else:
            os.unlink(tmp)
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: library_path(n) for n in names}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if missing."""
    path = build((name,))[name]
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    for fn, (argtypes, restype) in QUERIES.get(name, {}).items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.repro_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, fn: str, device: torch.device, *args) -> None:
    """Call entry point ``fn`` of library ``name`` on ``device``'s current
    stream; raise if the launch was refused."""
    lib = library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} ({msg})")


def query(name: str, fn: str, *args):
    """Call entry point ``fn`` of library ``name`` that launches nothing
    (:data:`QUERIES`) and return its result."""
    return getattr(library(name), fn)(*args)


def check_operands(fn: str, mat: torch.Tensor, vec: torch.Tensor) -> None:
    """Shared operand contract of the four kernels: ``mat`` (k,B,B) and
    ``vec`` (k,B) or (k,B,R), float32, contiguous, on one device."""
    if mat.dtype != torch.float32 or vec.dtype != torch.float32:
        raise TypeError(f"{fn}: float32 operands required, got {mat.dtype}, {vec.dtype}")
    if mat.device != vec.device:
        raise ValueError(f"{fn}: operands on {mat.device} and {vec.device}")
    if mat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {mat.device}")
    if mat.ndim != 3 or mat.shape[1] != mat.shape[2]:
        raise ValueError(f"{fn}: tiles must be (k,B,B), got {tuple(mat.shape)}")
    if vec.ndim not in (2, 3) or tuple(vec.shape[:2]) != tuple(mat.shape[:2]):
        raise ValueError(f"{fn}: rhs must be (k,B) or (k,B,R) matching tiles "
                         f"{tuple(mat.shape)}, got {tuple(vec.shape)}")
    if not (mat.is_contiguous() and vec.is_contiguous()):
        raise ValueError(f"{fn}: operands must be contiguous")
