"""Build the CUDA kernels under csrc/ into shared libraries and load them.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` for ``sm_90a``
into ``build/kernels/<name>-<hash>.so`` at the root of the checkout, with a
plain C interface that the wrappers call through ctypes. The hash covers
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header builds anew and an unchanged one is reused. `build_all`
starts one nvcc per source, all at once, and gives them `NVCC_TIMEOUT_S`
seconds: past that it kills every nvcc still running and raises, naming
the sources. The kernels reach the driver's tensor map encoder through
cudaGetDriverEntryPoint, so no build links -lcuda.

Importing this module needs no nvcc: only a build does, and without one it
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
#: seconds the nvcc processes of one build may run before it kills them
NVCC_TIMEOUT_S = 600

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels are built on the machine "
                           "with the card")
    return nvcc


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns name -> library path."""
    names = sources() if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        # build beside the target, then rename: a reader never sees a
        # half-written library
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    failed = []
    deadline = time.monotonic() + NVCC_TIMEOUT_S
    for name, (proc, tmp) in procs.items():
        try:
            out = proc.communicate(
                timeout=max(0.0, deadline - time.monotonic()))[0]
        except subprocess.TimeoutExpired:
            late = [n for n, (p, _) in procs.items() if p.poll() is None]
            for p, t in procs.values():
                p.kill()
                p.wait()
                if os.path.exists(t):
                    os.remove(t)
            raise RuntimeError(f"kernel build: nvcc ran past "
                               f"{NVCC_TIMEOUT_S} s on {', '.join(late)} "
                               "and was killed") from None
        out = out.decode(errors="replace")
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, cached per process. The first use builds every
    kernel whose library is missing (all of csrc/ together), so a training
    step's first backward finds its kernels built."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(path)
            _libs[name] = lib
    return lib
