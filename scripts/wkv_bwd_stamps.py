#!/usr/bin/env python3
"""Where the WKV backward's gradient kernel spends a CTA's time, on the card:

    python3 scripts/wkv_bwd_stamps.py

Builds a copy of `src/repro_torch/kernels/csrc/wkv_chunk.cu` in which lane
0 of each warp of `wkv_bwd_grad_kernel` reads `clock64()` at its start,
after each `__syncthreads()` and at its end (into a device array, for 128
CTAs from the middle of the grid), into the git-ignored
`src/repro_torch/kernels/_build/`; runs the backward at rwkv6-3b's width
(H 40, S 4096, K 64, fp32) at B 4 and B 1, and prints the mean ms of a
launch (CUDA events over 10), the cycles of each phase between two stamps
(median over the CTAs of the slowest and of the fastest warp), a CTA's
total cycles, and the card's name, power limit and SM clock.  The phases
are the kernel's numbered steps: 0-1 the copies, the scan and the row
sums; 2 dA and A; 3 dq, dke, dv; 4 the elementwise pass up to its
segment sums; then dg and du.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
OUT = os.path.join(ROOT, "src", "repro_torch", "kernels", "_build")
CTAS = 128  # CTAs stamped, from the middle of the grid

HEADER = """__device__ long long g_stamps[%d][8][8];
__device__ int g_first;
#define STAMP(p) do { const int c_ = blockIdx.x - g_first; \\
  if (c_ >= 0 && c_ < %d && (threadIdx.x & 31) == 0) \\
    g_stamps[c_][threadIdx.x >> 5][p] = clock64(); } while (0)
""" % (CTAS, CTAS)

READER = """
extern "C" int wkv_stamps(long long* out, int first) {
  cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * %d * 64);
  return (int)cudaMemcpyToSymbol(g_first, &first, sizeof(int));
}
""" % CTAS


def stamped_source() -> tuple:
    """The source with the gradient kernel's stamps; returns the number of
    stamps a warp takes through the CTA's barriers."""
    src = open(os.path.join(CSRC, "wkv_chunk.cu")).read()
    head = "template <int K>\n__global__ void __launch_bounds__(4 * K"
    start = src.index("wkv_bwd_grad_kernel(const float* __restrict__ r")
    end = src.index("\ntemplate <typename Kernel>", start)
    body = src[start:end]
    body = body.replace("  const int gid = lane >> 2, tig = lane & 3;\n",
                        "  const int gid = lane >> 2, tig = lane & 3;\n  STAMP(0);\n", 1)
    parts = body.split("  __syncthreads();\n")
    body = parts[0] + "".join(f"  __syncthreads();\n  STAMP({i + 1});\n{p}"
                              for i, p in enumerate(parts[1:]))
    last = body.rindex("}")
    body = body[:last] + f"  STAMP({len(parts)});\n" + body[last:]
    src = src[:start] + body + src[end:]
    src = src.replace(head, HEADER + head, 1)
    return src + READER, len(parts) + 1


def build(source: str) -> str:
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "wkv_stamps.cu"), os.path.join(OUT, "libwkv_stamps.so")
    with open(cu, "w") as f:
        f.write(re.sub(r'#include "(\w+\.cuh)"', lambda m: f'#include "{CSRC}/{m.group(1)}"',
                       source))
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, cu], check=True)
    return so


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("wkv_bwd_stamps: no CUDA card is available", file=sys.stderr)
        return 1
    source, points = stamped_source()
    lib = ctypes.CDLL(build(source))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv_bwd_launch.argtypes = [p] * 14 + [i, i, i, i, ctypes.c_float, p]
    lib.wkv_bwd_workspace_floats.argtypes = [i, i, i, i]
    lib.wkv_bwd_workspace_floats.restype = ctypes.c_longlong
    lib.wkv_stamps.argtypes = [p, i]
    dev = torch.device("cuda")
    H, S, K = 40, 4096, 64
    for B in (4, 1):
        gen = torch.Generator(device=dev).manual_seed(1)
        r, k, v, dy = (torch.randn((B, H, S, K), generator=gen, device=dev) * 0.5
                       for _ in range(4))
        g = -torch.exp(torch.randn((B, H, S, K), generator=gen, device=dev) * 0.8 - 0.5)
        u = torch.randn((H, K), generator=gen, device=dev) * 0.3
        outs = [torch.empty_like(r) for _ in range(4)]
        ws = [torch.empty((lib.wkv_bwd_workspace_floats(B * H, S, K, w),), device=dev)
              for w in (0, 1, 2)]
        stamps = np.zeros((CTAS, 8, 8), np.int64)
        lib.wkv_stamps(stamps.ctypes.data, B * H * (S // 32) // 2)

        def launch():
            err = lib.wkv_bwd_launch(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), u.data_ptr(),
                dy.data_ptr(), None, *(o.data_ptr() for o in outs), ws[2].data_ptr(),
                ws[0].data_ptr(), ws[1].data_ptr(), B * H, H, S, K, -1.2,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            launch()
        end.record()
        torch.cuda.synchronize()
        lib.wkv_stamps(stamps.ctypes.data, B * H * (S // 32) // 2)
        phases = np.diff(stamps[:, :, :points], axis=2)  # [cta, warp, phase]
        print(dict(B=B, H=H, S=S, K=K, ms=start.elapsed_time(end) / 10,
                   phase_cycles_slowest_warp=np.median(phases.max(1), 0).tolist(),
                   phase_cycles_fastest_warp=np.median(phases.min(1), 0).tolist(),
                   cta_cycles=float(np.median(stamps[:, :, points - 1].max(1)
                                              - stamps[:, :, 0].min(1)))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
