"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host
code, built with the host C++ compiler) exposes a plain C interface.  At
first use it is compiled (the ``.cu`` for Hopper, ``sm_90a``) into
``_build/lib<name>.so`` beside this file, and rebuilt whenever the source
is newer than the library.  An
exclusive file lock serialises concurrent builds (several processes on
first use), and the compiler writes to a temporary path that is renamed
into place, so no process loads a half-written library.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import shutil
import subprocess
import threading

_HERE = osp.dirname(osp.abspath(__file__))
CSRC_DIR = osp.join(_HERE, "csrc")
BUILD_DIR = osp.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) of every library
# built by this process, by name
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), osp.join(cuda_home, "bin", "nvcc")):
        if cand and osp.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "gdm_tpu_torch are built from source on the GPU host")


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler ($CXX, c++ or g++): the host "
                       "helpers of gdm_tpu_torch are built from source")


def _fresh(src: str, lib: str) -> bool:
    return osp.exists(lib) and osp.getmtime(lib) >= osp.getmtime(src)


def _compile(name: str) -> str:
    import fcntl

    src = osp.join(CSRC_DIR, f"{name}.cu")
    if not osp.exists(src):
        src = osp.join(CSRC_DIR, f"{name}.cpp")
    lib = osp.join(BUILD_DIR, f"lib{name}.so")
    if _fresh(src, lib):
        return lib
    cmd = ([_nvcc(), *NVCC_FLAGS] if src.endswith(".cu")
           else [_cxx(), *CXX_FLAGS])
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(lib + ".lock", "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        if _fresh(src, lib):                 # built by another process
            return lib
        tmp = f"{lib}.tmp{os.getpid()}"
        proc = subprocess.run([*cmd, "-o", tmp, src],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{cmd[0]} failed on {src} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        build_logs[name] = proc.stdout + proc.stderr
    return lib


def build_all(names) -> dict[str, float]:
    """Compile the named sources at once (one compiler process each,
    started together), then load them; returns each one's wall seconds."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        t0 = time.perf_counter()
        _compile(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(names)) as pool:
        secs = dict(zip(names, pool.map(one, names)))
    for name in names:
        load(name)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu`` or ``.cpp``, built if
    stale.

    Raises RuntimeError when the compiler is missing or the build fails;
    the caller sets ``argtypes``/``restype`` of the functions it uses."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_compile(name))
        return _libs[name]
