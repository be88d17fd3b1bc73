"""ctypes bindings for the native ingest library (port of
speechclip_tpu/data/native.py over the same ``native/wavio.cc`` and
``native/jpegio.cc``).

Loads ``native/libwavio.so`` (built by ``native/build.sh``; not committed),
or the file ``SPEECHCLIP_WAVIO_PATH`` names, when it exists and loads; it
links ``libjpeg.so.62``. Exposes the threaded batch WAV decode, the
header-only length probe and the batch JPEG decode. The pure-Python readers
of ``data/audio.py`` and ``data/image.py`` are the fallback: the loader
takes the native path when the library is there, and falls back to Python
for a batch whose native decode fails.
"""

from __future__ import annotations

import ctypes
import logging
import os
from typing import List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libwavio.so",
    )


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.environ.get("SPEECHCLIP_WAVIO_PATH", _lib_path())
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.wavio_decode_batch.restype = ctypes.c_int
        lib.wavio_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.wavio_num_samples.restype = ctypes.c_int
        lib.wavio_num_samples.argtypes = [ctypes.c_char_p, ctypes.c_int]
        if hasattr(lib, "jpegio_decode_batch"):
            lib.jpegio_decode_batch.restype = ctypes.c_int
            lib.jpegio_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
            ]
        _LIB = lib
        logger.info("native wavio loaded from %s", path)
    except (OSError, AttributeError) as e:  # pragma: no cover
        # OSError: unloadable .so; AttributeError: a loadable ELF that
        # lacks the wavio symbols (stale build / wrong SPEECHCLIP_WAVIO_PATH)
        # — both must degrade to the python reader, not crash dataset
        # construction through available()
        logger.warning("could not load native wavio (%s)", e)
        _LIB = None
    return _LIB


def available() -> bool:
    return load_library() is not None


def decode_wav_batch(
    paths: List[str],
    max_len: int,
    target_sr: int = 16_000,
    threads: int = 0,
    out: Optional[np.ndarray] = None,
    offsets: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (wav (N, max_len) f32 zero-padded, lengths (N,) int32). offsets:
    per-file start sample (train random crop). Raises RuntimeError listing
    the first failed file."""
    lib = load_library()
    assert lib is not None, "native wavio not built (native/build.sh)"
    n = len(paths)
    if out is None:
        out = np.zeros((n, max_len), np.float32)
    assert out.shape == (n, max_len) and out.dtype == np.float32
    # .ctypes hands the C side a bare base pointer that it fills assuming
    # dense row-major — a strided view would be silently corrupted
    assert out.flags["C_CONTIGUOUS"], "out must be C-contiguous"
    lens = np.zeros((n,), np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if offsets is not None:
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        assert offsets.shape == (n,), "offsets must have one entry per path"
        c_offsets = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long))
    else:
        c_offsets = None
    rc = lib.wavio_decode_batch(
        c_paths,
        n,
        target_sr,
        max_len,
        c_offsets,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        threads,
    )
    if rc != 0:
        raise RuntimeError(f"native decode failed for {paths[rc - 1]!r}")
    return out, lens


def wav_num_samples(path: str, target_sr: int = 16_000) -> int:
    lib = load_library()
    assert lib is not None
    n = lib.wavio_num_samples(path.encode(), target_sr)
    if n < 0:
        raise RuntimeError(f"native header probe failed for {path!r}")
    return n


def has_jpeg() -> bool:
    lib = load_library()
    return lib is not None and hasattr(lib, "jpegio_decode_batch")


def decode_jpeg_batch(
    paths: List[str], out_size: int, threads: int = 0
) -> np.ndarray:
    """Threaded native JPEG decode (native/jpegio.cc): DCT-prescaled decode,
    bilinear shorter-side resize, center crop -> (N, out_size, out_size, 3)
    uint8. Raises RuntimeError naming the first failed file."""
    lib = load_library()
    assert lib is not None and has_jpeg(), "native jpegio not built"
    n = len(paths)
    out = np.zeros((n, out_size, out_size, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.jpegio_decode_batch(
        c_paths,
        n,
        out_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads,
    )
    if rc != 0:
        raise RuntimeError(f"native jpeg decode failed for {paths[rc - 1]!r}")
    return out
