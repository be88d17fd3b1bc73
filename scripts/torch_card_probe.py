#!/usr/bin/env python3
"""What the card's machine offers the port's host code, one fact a line:

    python3 scripts/torch_card_probe.py

the card (``nvidia-smi`` name and power limit), Python, torch and CUDA
versions, which optional packages import (PIL, PyYAML, regex, tensorboard
and ``torch.utils.tensorboard``, tensorflow, scipy), whether ``ldconfig``
lists ``libjpeg.so.62`` and whether ``native/libwavio.so`` loads through
ctypes (the loaders' native WAV decode), cores, memory and free disk.
"""

import ctypes
import importlib
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def main() -> int:
    print(run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]))
    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    for name in ("PIL", "yaml", "regex", "tensorboard", "torch.utils.tensorboard", "tensorflow",
                 "scipy"):
        try:
            module = importlib.import_module(name)
            print(f"{name}: imports {getattr(module, '__version__', '')}".rstrip())
        except Exception as e:  # an optional package: any failure is the fact to report
            print(f"{name}: fails ({type(e).__name__}: {e})")
    libs = [line.strip() for line in run(["ldconfig", "-p"]).splitlines() if "libjpeg" in line]
    print(f"ldconfig libjpeg: {libs or 'none'}")
    lib = os.path.join(REPO, "native", "libwavio.so")
    if not os.path.exists(lib):
        print("native/libwavio.so: absent (git does not track it; native/build.sh builds it)")
    else:
        try:
            ctypes.CDLL(lib)
            print("native/libwavio.so: loads")
        except OSError as e:
            print(f"native/libwavio.so: does not load ({e})")
    total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 2**30
    free = shutil.disk_usage(os.environ.get("TMPDIR", "/tmp")).free / 1e9
    print(f"cores {os.cpu_count()}, memory {total:.1f} GiB, free disk for temporaries {free:.1f} GB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
