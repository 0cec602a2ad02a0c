"""Build and load the native (C++) data libraries — the counterpart of the
JAX package's ``data/native_build.py`` `build_native_lib` (:163) and
`load_abi_checked` (:205).

The port compiles the repo's unedited ``native/*.cc`` sources, and its own
``distributed_vgg_f_tpu_torch/native/*.cc`` (`PORT_NATIVE_DIR`: the
snapshot cache's batch I/O), with g++ and the JAX package's flags into
``build/native/<name>-<hash>.so`` at the root of the checkout, the hash
covering the source, the headers it is compiled against and every flag, as
`kernels/build.py` keys the CUDA kernels. A library of its own keeps the
two packages from racing on one path, and an edited source gets a new
path, so glibc never hands back a stale mapping of the old one. The hash
covers this CPU's feature flags too: `-march=native` code built on one
machine is never loaded on another, even when a copy of the checkout
carries `build/` along. Processes that need the same library at once
(pytest-xdist workers, ranks) take an `fcntl` lock around the compile, so
one of them compiles and the others load its result; the compile writes a
pid-unique temp file that `os.replace` moves into place.

Nothing falls back: a failed build raises with the compiler's output, a
library whose ABI version differs from the binding's raises, and a host
without a libjpeg of ABI 62 raises, naming what it looked for.

libjpeg: the decoder compiles against the headers of libjpeg-turbo 2.1.5
(ABI 62) carried in ``third_party/libjpeg`` and links a ``libjpeg.so.62``
by its path (with an rpath to its directory): the one the dynamic loader
knows (``ldconfig -p``) or, on a host without one, the copy Pillow's wheel
bundles in ``pillow.libs`` (located without importing Pillow).
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import importlib.util
import os
import shutil
import subprocess
from typing import Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
NATIVE_DIR = os.path.join(_ROOT, "native")
PORT_NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
JPEG_HEADERS = os.path.join(_PKG, "third_party", "libjpeg")

#: The JAX package's flags (its native_build.py:34). -march=native is right
#: because every host builds its own copy (`_cpu_flags` keys it).
_CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread",
              "-shared"]
#: seconds one g++ run may take
CXX_TIMEOUT_S = 300


def _ldconfig_libjpeg62():
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        out = subprocess.run([ldconfig, "-p"], capture_output=True,
                             text=True, timeout=60).stdout
    except OSError:
        return None
    for line in out.splitlines():
        name, _, path = line.strip().partition(" => ")
        if name.startswith("libjpeg.so.62 ") and "x86-64" in name \
                and os.path.exists(path):
            return path
    return None


def _pillow_libjpeg62():
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.origin:
        return None
    site = os.path.dirname(os.path.dirname(spec.origin))
    found = sorted(glob.glob(os.path.join(site, "pillow.libs",
                                          "libjpeg-*.so.62*")))
    return found[0] if found else None


def libjpeg_path() -> str:
    """Absolute path of the libjpeg (ABI 62) the decoder links: the dynamic
    loader's ``libjpeg.so.62``, else Pillow's bundled copy. Raises when the
    host has neither."""
    path = _ldconfig_libjpeg62() or _pillow_libjpeg62()
    if path is None:
        raise RuntimeError(
            "no libjpeg of ABI 62 on this host: neither `ldconfig -p` "
            "lists libjpeg.so.62 nor does Pillow's pillow.libs hold a "
            "libjpeg-*.so.62; the native JPEG decoder cannot be built")
    return os.path.realpath(path)


def jpeg_build_args():
    """(compile args, link args) of the JPEG decoder: the carried headers,
    then libjpeg by path with an rpath to it, and -ldl (the loader dlsym-
    probes libjpeg-turbo's partial-decode API)."""
    lib = libjpeg_path()
    return (["-I", JPEG_HEADERS],
            [lib, f"-Wl,-rpath,{os.path.dirname(lib)}", "-ldl"])


def _cpu_flags() -> str:
    """This CPU's feature flags (the first `flags` line of /proc/cpuinfo;
    empty where there is none): what -march=native compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.strip()
    except OSError:
        pass
    return ""


def library_path(src_name: str, name: str, compile_args: Sequence[str] = (),
                 link_args: Sequence[str] = (),
                 src_dir: str = NATIVE_DIR) -> str:
    digest = hashlib.sha256(" ".join(
        [*_CXX_FLAGS, *compile_args, "|", *link_args, "|",
         _cpu_flags()]).encode())
    with open(os.path.join(src_dir, src_name), "rb") as f:
        digest.update(f.read())
    # the headers of every -I directory: an edited header builds anew
    args = list(compile_args)
    for flag, directory in zip(args, args[1:]):
        if flag != "-I":
            continue
        for h in sorted(os.listdir(directory)):
            if h.endswith(".h"):
                with open(os.path.join(directory, h), "rb") as f:
                    digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_native_lib(src_name: str, name: str,
                     compile_args: Sequence[str] = (),
                     link_args: Sequence[str] = (),
                     src_dir: str = NATIVE_DIR) -> str:
    """Compile ``<src_dir>/<src_name>`` unless its library exists; returns
    the library's path. Raises RuntimeError with g++'s output when the
    compile fails."""
    path = library_path(src_name, name, compile_args, link_args, src_dir)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):  # another process built it meanwhile
                return path
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = ["g++", *_CXX_FLAGS, *compile_args, "-o", tmp,
                   os.path.join(src_dir, src_name), *link_args]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=CXX_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(
                    f"native build of {src_name} could not run: {e}") from e
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise RuntimeError(
                    f"native build of {src_name} failed (g++ exit "
                    f"{proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr[-4000:]}")
            os.replace(tmp, path)
            return path
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def load_abi_checked(src_name: str, name: str, abi_symbol: str,
                     expected_abi: int, compile_args: Sequence[str] = (),
                     link_args: Sequence[str] = (),
                     src_dir: str = NATIVE_DIR) -> ctypes.CDLL:
    """Build (when needed) and dlopen ``<src_dir>/<src_name>``, checking
    that `abi_symbol`() returns `expected_abi`: a library of another ABI
    raises instead of being called with the wrong signatures."""
    path = build_native_lib(src_name, name, compile_args, link_args,
                            src_dir)
    lib = ctypes.CDLL(path)
    fn = getattr(lib, abi_symbol)
    fn.restype = ctypes.c_int64
    fn.argtypes = []
    got = int(fn())
    if got != expected_abi:
        raise RuntimeError(
            f"{path}: {abi_symbol}() = {got}, but the binding expects "
            f"{expected_abi}")
    return lib
