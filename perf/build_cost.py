#!/usr/bin/env python3
"""What building the CUDA kernels costs, two ways, on the GPU machine.

    python3 perf/build_cost.py

1. the port's builder (``repro_torch.kernels.extension.build``): one ``nvcc``
   per ``.cu`` source into a plain-C shared library, no PyTorch headers;
2. ``torch.utils.cpp_extension.load`` over the same two ``.cu`` sources plus
   a binding file that includes ``torch/extension.h`` and checks each launch
   with ``C10_CUDA_KERNEL_LAUNCH_CHECK``.

Each is timed in a fresh process into an empty directory (first build), then
again in a new process over that directory (cached). The ``load`` module's
TRSV must give the same bits as the port's. Prints one line per measurement
and the toolchain (ninja, nvcc, torch). Build output goes under
``build/build_cost/``. Needs a CUDA device.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "build_cost"
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"

BINDING = r"""
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAStream.h>

extern "C" {
int repro_trsv_f32(const float*, const float*, float*, int, int, void*);
int repro_trsm_f32(const float*, const float*, float*, int, int, int, void*);
int repro_gemv_f32(const float*, const float*, float*, int, int, void*);
int repro_gemm_f32(const float*, const float*, float*, int, int, int, void*);
}

static void* stream() { return c10::cuda::getCurrentCUDAStream().stream(); }

torch::Tensor trsv(torch::Tensor L, torch::Tensor r) {
  auto x = torch::empty_like(r);
  repro_trsv_f32(L.data_ptr<float>(), r.data_ptr<float>(), x.data_ptr<float>(),
                 r.size(0), r.size(1), stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return x;
}
torch::Tensor trsm(torch::Tensor L, torch::Tensor r) {
  auto x = torch::empty_like(r);
  repro_trsm_f32(L.data_ptr<float>(), r.data_ptr<float>(), x.data_ptr<float>(),
                 r.size(0), r.size(1), r.size(2), stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return x;
}
torch::Tensor gemv(torch::Tensor T, torch::Tensor v) {
  auto y = torch::empty_like(v);
  repro_gemv_f32(T.data_ptr<float>(), v.data_ptr<float>(), y.data_ptr<float>(),
                 v.size(0), v.size(1), stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return y;
}
torch::Tensor gemm(torch::Tensor T, torch::Tensor v) {
  auto y = torch::empty_like(v);
  repro_gemm_f32(T.data_ptr<float>(), v.data_ptr<float>(), y.data_ptr<float>(),
                 v.size(0), v.size(1), v.size(2), stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return y;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("trsv", &trsv);
  m.def("trsm", &trsm);
  m.def("gemv", &gemv);
  m.def("gemm", &gemm);
}
"""

# Each child prints one JSON line: {"seconds": build or load time, "same": bool}
PORT_CHILD = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, {src!r})
import torch
from repro_torch.kernels import extension
extension.BUILD_DIR = Path({out!r})
t0 = time.perf_counter()
extension.build()
print(json.dumps({{"seconds": time.perf_counter() - t0}}))
"""

LOAD_CHILD = """
import json, sys, time
from pathlib import Path
sys.path.insert(0, {src!r})
import torch
from torch.utils.cpp_extension import load
from repro_torch.kernels import ops
t0 = time.perf_counter()
mod = load(name="repro_build_cost", sources=[{binding!r}, {trsv!r}, {spmv!r}],
           build_directory={out!r}, extra_cuda_cflags=["-O3",
           "-gencode=arch=compute_90a,code=sm_90a"], extra_cflags=["-O3"], verbose=False)
seconds = time.perf_counter() - t0
g = torch.Generator(device="cuda").manual_seed(0)
L = torch.tril(torch.rand(64, 32, 32, device="cuda", generator=g), -1) / 32 \\
    + 2 * torch.eye(32, device="cuda")
r = torch.rand(64, 32, device="cuda", generator=g)
same = torch.equal(mod.trsv(L, r), ops.KERNELS["block_trsv"](L, r))
print(json.dumps({{"seconds": seconds, "same": bool(same)}}))
"""


def child(code: str) -> dict:
    """Run ``code`` in a fresh interpreter; its last stdout line is JSON."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        return {"error": (out.stdout + out.stderr)[-3000:],
                "process_seconds": time.perf_counter() - t0}
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["process_seconds"] = time.perf_counter() - t0
    return res


def main() -> None:
    import torch
    from torch.utils import cpp_extension

    if not torch.cuda.is_available():
        sys.exit("build_cost.py needs a CUDA device")
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    nvcc = subprocess.run([str(Path(cpp_extension.CUDA_HOME or "/usr/local/cuda")
                               / "bin" / "nvcc"), "--version"],
                          capture_output=True, text=True).stdout.strip().splitlines()[-1]
    print(f"[build_cost] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; nvcc {nvcc}; "
          f"ninja available: {cpp_extension.is_ninja_available()}", flush=True)
    src = str(ROOT / "src")

    port_dir = OUT / "port"
    for run in ("first", "cached"):
        res = child(textwrap.dedent(PORT_CHILD.format(src=src, out=str(port_dir))))
        print(f"[build_cost] port builder, {run}: {json.dumps(res)}", flush=True)

    load_dir = OUT / "load"
    load_dir.mkdir()
    binding = load_dir / "binding.cpp"
    binding.write_text(BINDING)
    code = textwrap.dedent(LOAD_CHILD.format(
        src=src, out=str(load_dir), binding=str(binding),
        trsv=str(CSRC / "block_trsv.cu"), spmv=str(CSRC / "block_spmv.cu")))
    for run in ("first", "cached"):
        res = child(code)
        print(f"[build_cost] cpp_extension.load, {run}: {json.dumps(res)}", flush=True)


if __name__ == "__main__":
    main()
