"""The program's native WAV ingest library, built as ``native/build.sh``
builds it (its g++ line; WAV only: the trainer reads no image once the
feature cache is built, and the card's machine has no libjpeg headers),
into a fixed directory of the benchmark's cache named by a hash of the
source and the command, and loaded through the program's own
``SPEECHCLIP_WAVIO_PATH``. A run that cannot load it stops: the loader's
Python decode is not what users who build the library run.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

from .harness import ROOT

CMD = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]


def ensure_wavio(cache_dir: str) -> str:
    src = os.path.join(ROOT, "native", "wavio.cc")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CMD).encode()).hexdigest()[:16]
    out_dir = os.path.join(cache_dir, "native")
    out = os.path.join(out_dir, f"libwavio-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(out_dir, exist_ok=True)
        tmp = out + ".partial"
        subprocess.run(CMD + ["-o", tmp, src], check=True)
        os.replace(tmp, out)
    os.environ["SPEECHCLIP_WAVIO_PATH"] = out
    from speechclip_tpu_torch.data import native

    if not native.available():
        raise RuntimeError(f"the native WAV decode did not load from {out}")
    return out
