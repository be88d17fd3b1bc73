"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source of ``csrc/`` (one process per ``.cu``, all
started together) and links the objects into one shared library with a
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
import threading
from pathlib import Path
from typing import List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
GENCODE = "arch=compute_90a,code=sm_90a"

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()  # threads of one process (a server's batchers) load it once
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


def nvcc_commands(nvcc: str, output: Path) -> Tuple[List[List[str]], List[str]]:
    """(one compile command per ``csrc/*.cu``, the link command) for
    ``libscl_kernels``; the compiles run in parallel, objects beside
    ``output``."""
    flags = ["-gencode", GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objects, compiles = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = output.with_name(f"{output.name}.{src.stem}.o")
        compiles.append([nvcc, *flags, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)])
        objects.append(str(obj))
    return compiles, [nvcc, *flags, "-shared", "-o", str(output), *objects]


def _library_path() -> Path:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    compiles, link = nvcc_commands("nvcc", Path("x"))
    h.update(" ".join(sum(compiles, []) + link).encode())
    return BUILD_DIR / f"libscl_kernels_{h.hexdigest()[:16]}.so"


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.scl_gemm_bf16.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.scl_gemm_bf16.restype = i
    lib.scl_gemm_bf16_tiled.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.scl_gemm_bf16_tiled.restype = i
    lib.scl_gemm_smem_bytes.argtypes = [i, i]
    lib.scl_gemm_smem_bytes.restype = i
    lib.scl_layer_norm.argtypes = [p, i, p, p, p, i, i, ctypes.c_float, p]
    lib.scl_layer_norm.restype = i
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.scl_rowwise_attention.argtypes = [
        p, p, p, p, p, i, i, i, i, i, strides, i, i, ctypes.c_float, p,
    ]
    lib.scl_rowwise_attention.restype = i
    lib.scl_rowwise_smem_bytes.argtypes = [i]
    lib.scl_rowwise_smem_bytes.restype = i
    lib.scl_flash_attention.argtypes = [
        p, p, p, p, p, i, i, i, i, i, strides, i, ctypes.c_float, p, p,
    ]
    lib.scl_flash_attention.restype = i
    lib.scl_flash_attention_f32.argtypes = [
        p, p, p, p, p, i, i, i, i, i, strides, i, ctypes.c_float, p,
    ]
    lib.scl_flash_attention_f32.restype = i
    lib.scl_conv_chain_layer.argtypes = [
        p, p, p, i, i, i, i, i, ctypes.POINTER(ctypes.c_longlong), i, p,
    ]
    lib.scl_conv_chain_layer.restype = i
    lib.scl_conv_chain_plan.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.scl_conv_chain_plan.restype = i
    lib.scl_pos_conv.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.scl_pos_conv.restype = i
    lib.scl_pos_conv_smem_bytes.argtypes = [i, i]
    lib.scl_pos_conv_smem_bytes.restype = i


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
        compiles, link = nvcc_commands(find_nvcc(), tmp)
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for cmd in compiles
        ]
        log, failed = [], []
        for cmd, proc in zip(compiles, procs):
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(cmd[-3])
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append("link")
        for cmd in compiles:
            Path(cmd[-1]).unlink(missing_ok=True)
        _BUILD_LOG = "\n".join(log)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"CUDA kernel build failed ({', '.join(failed)}):\n{_BUILD_LOG}")
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
        with _LIB_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(build()))
                _declare(lib)
                _LIB = lib
    return _LIB


def stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, which every
    kernel launches on (through torch's own accessor: ``torch.cuda.
    current_stream(device).cuda_stream`` builds a Stream object first, a
    few microseconds of each launch's host path)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (refused launch, bad shape)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
