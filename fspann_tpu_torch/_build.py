"""Build the port's native libraries from the repository's sources at first use.

Two kinds of library, both plain C ABIs loaded with ctypes:

* CUDA kernels: ``csrc/<name>.cu`` → ``build/lib<name>.so`` by ``nvcc`` for
  ``sm_90a`` (Hopper).  No PyTorch headers are included, so a build takes
  seconds.
* Host C kernels, compiled from the port's own byte-for-byte copies of the
  JAX package's C sources (``fspann_tpu/crypto/native/aes_gcm.c`` and
  ``fspann_tpu/ops/native/hamming_topl.c``; tests/test_torch_isolation.py
  holds the copies to them) with their Makefiles' flags: AES-256-GCM
  (``csrc/native/aes_gcm.c`` → ``build/libfspann_crypto.so``) and the
  packed Hamming top-L scan (``csrc/native/hamming_topl.c`` →
  ``build/libfspann_scan.so``).  Beside them the port's own host C, the
  pooled candidate read (``csrc/native/open_pool.c``, which includes
  ``aes_gcm.c``, → ``build/libfspann_open_pool.so``, with the AES-GCM
  flags).

``build/`` is git-ignored; every fresh checkout builds here on first use.
A lock file per library serialises concurrent builds of that library
(parallel test workers) while different libraries build side by side
(:func:`build_all`), and each library is written under a temporary name and
renamed into place, so a reader never loads a half-written file.  A failed build raises with the
compiler's output — nothing falls back to a prebuilt or plain version.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "build")
CSRC_DIR = os.path.join(_PKG, "csrc")
AES_GCM_SRC = os.path.join(CSRC_DIR, "native", "aes_gcm.c")
# the JAX package's crypto/native/Makefile: CFLAGS, plus -shared
AES_GCM_CFLAGS = ["-O3", "-Wall", "-Wextra", "-maes", "-mpclmul", "-mssse3",
                  "-msse4.1", "-mf16c", "-fPIC", "-pthread", "-shared"]
NATIVE_SCAN_SRC = os.path.join(CSRC_DIR, "native", "hamming_topl.c")
# the JAX package's ops/native/Makefile: CFLAGS, plus -shared
NATIVE_SCAN_CFLAGS = ["-O3", "-Wall", "-Wextra", "-mpopcnt", "-fPIC",
                      "-pthread", "-shared"]
OPEN_POOL_SRC = os.path.join(CSRC_DIR, "native", "open_pool.c")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# wall seconds of each build this process ran (a cached library adds none)
build_seconds: dict[str, float] = {}
# compiler diagnostics of each build (nvcc: ptxas register/smem report)
build_logs: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _build(out_name: str, sources: list[str], cmd) -> str:
    """Compile ``sources`` into ``build/out_name`` unless an up-to-date
    library is already there.  ``cmd(out_path)`` gives the compiler argv."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, out_name)
    with open(os.path.join(BUILD_DIR, f".{out_name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        newest = max(os.path.getmtime(s) for s in sources)
        if os.path.exists(out) and os.path.getmtime(out) >= newest:
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(cmd(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {out_name} failed:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        build_seconds[out_name] = time.perf_counter() - t0
        build_logs[out_name] = proc.stdout + proc.stderr
    return out


def aes_gcm_library_path() -> str:
    """Path of the host AES-GCM library, built on first use."""
    cc = os.environ.get("CC", "gcc")
    return _build("libfspann_crypto.so", [AES_GCM_SRC],
                  lambda out: [cc, *AES_GCM_CFLAGS, "-o", out, AES_GCM_SRC])


def native_scan_library_path() -> str:
    """Path of the host packed Hamming scan library, built on first use."""
    cc = os.environ.get("CC", "gcc")
    return _build("libfspann_scan.so", [NATIVE_SCAN_SRC],
                  lambda out: [cc, *NATIVE_SCAN_CFLAGS, "-o", out,
                               NATIVE_SCAN_SRC])


def open_pool_library_path() -> str:
    """Path of the host pooled candidate-read library, built on first use."""
    cc = os.environ.get("CC", "gcc")
    return _build("libfspann_open_pool.so", [OPEN_POOL_SRC, AES_GCM_SRC],
                  lambda out: [cc, *AES_GCM_CFLAGS, "-o", out,
                               OPEN_POOL_SRC])


def cuda_library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built for sm_90a and loaded (cached per process)."""
    lib = _LIBS.get(name)
    if lib is None:
        src = os.path.join(CSRC_DIR, f"{name}.cu")
        path = _build(f"lib{name}.so", [src],
                      lambda out: [_nvcc(), *NVCC_FLAGS, "-o", out, src])
        lib = _LIBS[name] = ctypes.CDLL(path)
    return lib


def build_all() -> None:
    """Build every library at once: one ``nvcc`` per ``csrc/*.cu`` and gcc
    for each host library, all started together (a library that is up to
    date is only loaded)."""
    names = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    with ThreadPoolExecutor(len(names) + 3) as ex:
        jobs = [ex.submit(cuda_library, n) for n in names]
        jobs.append(ex.submit(aes_gcm_library_path))
        jobs.append(ex.submit(native_scan_library_path))
        jobs.append(ex.submit(open_pool_library_path))
        for job in jobs:
            job.result()
