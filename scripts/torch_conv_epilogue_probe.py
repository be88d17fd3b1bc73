#!/usr/bin/env python3
"""What the GELU epilogue of the port's conv chain kernel costs, on the card.

    python3 scripts/torch_conv_epilogue_probe.py

Run from the repository root on a machine with an NVIDIA H100 and nvcc.
It copies ``speechclip_tpu_torch/`` into ``build/epilogue_probe/<variant>/``
once per variant, with the body of ``gelu_erf`` in ``csrc/conv_chain.cu``
swapped, builds each copy and times ``fused_conv_chain`` at (64, 20479, 512)
in a subprocess per variant, in turns (each variant, then back in reverse):
a CUDA-event median of 20 runs of 5 back-to-back chains, then the SM clock
and power draw while the chain runs back to back for 3 s (``nvidia-smi``
every 250 ms). Variants: ``erff`` (the kernel as it is), ``identity`` (no
GELU: the bare products, rounded), ``twice`` (GELU applied twice) and
``as_poly`` (the TPU kernel's A&S erf: one reciprocal, one exp, five FMAs).
Only ``erff`` computes the kernel's function; the others are timed only.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "epilogue_probe"
ERFF = "  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));"
VARIANTS = {
    "erff": ERFF,
    "identity": "  return x;",
    "twice": (
        "  const float y = 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));\n"
        "  return 0.5f * y * (1.0f + erff(y * 0.7071067811865476f));"
    ),
    "as_poly": (
        "  const float z = fabsf(x) * 0.7071067811865476f;\n"
        "  const float t = __fdividef(1.0f, fmaf(0.3275911f, z, 1.0f));\n"
        "  float e = fmaf(1.061405429f, t, -1.453152027f);\n"
        "  e = fmaf(e, t, 1.421413741f);\n"
        "  e = fmaf(e, t, -0.284496736f);\n"
        "  e = fmaf(e, t, 0.254829592f);\n"
        "  e *= t * __expf(-z * z);\n"
        "  const float h = 0.5f * x * e;\n"
        "  return x >= 0.f ? x - h : h;"
    ),
}
# Run in each variant's directory (its package first on sys.path), with
# chip_smoke importable from the repository root.
TIMER = """
import torch
import chip_smoke as c
from speechclip_tpu_torch.kernels import conv_frontend as cf
x, ws = c._conv_inputs(torch.Generator(device="cuda").manual_seed(15))
fn = lambda: cf.fused_conv_chain(x, ws, c.CONV_KERNELS)
ms = c.cuda_time_ms(fn, calls=5)
clocks, watts = c._sustained_clocks(fn)
clocks.sort(); watts.sort()
print(f"{ms:.4f} ms, SM clock median {clocks[len(clocks) // 2]:.0f} MHz "
      f"({clocks[0]:.0f}-{clocks[-1]:.0f}), power median {watts[len(watts) // 2]:.2f} W")
"""


def variant_dir(name: str) -> Path:
    """A copy of the package with ``gelu_erf``'s body swapped for ``name``'s."""
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(ROOT / "speechclip_tpu_torch", d / "speechclip_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = d / "speechclip_tpu_torch" / "csrc" / "conv_chain.cu"
    text = src.read_text()
    if ERFF not in text:
        raise SystemExit("conv_chain.cu's gelu_erf is not the erff form this probe swaps")
    src.write_text(text.replace(ERFF, VARIANTS[name]))
    return d


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dirs = {name: variant_dir(name) for name in VARIANTS}
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    order = list(VARIANTS)
    for name in order + order[::-1]:
        run = subprocess.run([sys.executable, "-c", TIMER], cwd=dirs[name], env=env,
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        print(f"conv chain (64, 20479, 512), epilogue {name} on {smi}: "
              f"{run.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
