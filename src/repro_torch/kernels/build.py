"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source `csrc/<name>.cu` exposes a plain C interface and compiles into
its own shared library `_build/<name>-<hash>.so`, keyed by the hash of the
source, of every header of `csrc/` it includes (directly or through another
header) and of the full compiler command line, so an edited source or
header is rebuilt and an unchanged one is built once per checkout.  The
build runs at first use, never at import: the CPU-only test hosts have no
nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built on a host with the CUDA toolkit")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(src: Path) -> List[Path]:
    """src and every header of its directory it includes with quotes,
    directly or through another header, each once, in include order."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen or (path != src and not path.exists()):
            continue
        seen.append(path)
        todo += [path.parent / m.decode()
                 for m in _INCLUDE.findall(path.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu"):
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: List[str]) -> Dict[str, dict]:
    """Compile every named source that has no library yet, all nvcc
    processes started together.  Returns, per name, the library path, the
    build seconds (0 when it was already built) and ptxas' resource lines
    (registers, then stack and spills, per kernel)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    info, running = {}, {}
    for name in names:
        so = library_path(name)
        if so.exists():
            info[name] = dict(library=str(so), seconds=0.0, ptxas=[])
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (so, tmp, time.perf_counter(),
                         subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    failures = []
    for name, (so, tmp, t0, proc) in running.items():
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}{err}")
            continue
        os.replace(tmp, so)
        info[name] = dict(library=str(so), seconds=seconds,
                          ptxas=[l.strip() for l in (out + err).splitlines()
                                 if "ptxas" in l or "spill" in l])
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return info


def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it first if needed."""
    return ctypes.CDLL(build([name])[name]["library"])
