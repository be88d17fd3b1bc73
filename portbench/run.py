"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s workload) names a configuration and a
traffic mix under ``portbench/``. Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit. The same comparisons are
the last lines of standard error. Exits non-zero, printing no result,
without a CUDA card (or fewer than the cell asks for), or if JAX, jaxlib,
flax or the JAX package were loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from portbench import harness

    spec = harness.cell_spec(args.workload)
    import torch

    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or torch.cuda.get_device_name()}", flush=True)
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", cache_dir=CACHE, t_start=T_START)
    loaded = harness.jax_modules()
    if loaded:
        print(f"portbench: JAX modules loaded in the run: {loaded[:10]}", file=sys.stderr)
        return 3
    print("notes: " + json.dumps(out["notes"], default=str), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) {'ok' if c['ok'] else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
