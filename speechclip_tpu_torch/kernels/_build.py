"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source of ``csrc/`` into one shared library with a
plain C interface, which is loaded with ``ctypes``. The build runs at first
use, from the checkout's own sources only, into ``build/kernels/`` at the
repository root; the library's name carries a hash of the sources and the
command, so an unchanged tree reuses it and a changed one rebuilds. A failed
or impossible build raises: nothing degrades to another path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
GENCODE = "arch=compute_90a,code=sm_90a"

_LIB: Optional[ctypes.CDLL] = None
_BUILD_LOG = ""


def sources() -> List[Path]:
    """Every file the library is built from (``.cu`` and ``.cuh``)."""
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


def nvcc_command(nvcc: str, output: Path) -> List[str]:
    """The one compile-and-link command for ``libscl_kernels``."""
    return [
        nvcc,
        "-gencode", GENCODE,
        "-std=c++17",
        "-O3",
        "-shared",
        "-Xcompiler", "-fPIC",
        "-Xptxas", "-v",
        "-o", str(output),
        *[str(p) for p in sorted(CSRC_DIR.glob("*.cu"))],
    ]


def _library_path() -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(nvcc_command("nvcc", Path("x"))).encode())
    return BUILD_DIR / f"libscl_kernels_{h.hexdigest()[:16]}.so"


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scl_gemm_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.scl_gemm_bf16.restype = i
    lib.scl_layer_norm.argtypes = [p, i, p, p, p, i, i, ctypes.c_float, p]
    lib.scl_layer_norm.restype = i
    lib.scl_attention.argtypes = [p, p, p, i, i, i, i, p]
    lib.scl_attention.restype = i
    lib.scl_attention_smem_bytes.argtypes = [i, i]
    lib.scl_attention_smem_bytes.restype = i


def build() -> Path:
    """Compile the library unless a build of these exact sources exists.
    Concurrent callers serialize on a lock file; the library is written
    under a temporary name and renamed into place."""
    global _BUILD_LOG
    lib_path = _library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return lib_path
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(find_nvcc(), tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _BUILD_LOG = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"CUDA kernel build failed (exit {proc.returncode}):\n{_BUILD_LOG}"
            )
        os.replace(tmp, lib_path)
    return lib_path


def build_log() -> str:
    """The command and compiler output of this process's build ("" if the
    library was already built)."""
    return _BUILD_LOG


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _LIB = lib
    return _LIB


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (refused launch, bad shape)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
