"""Finds a cell's pieces by the names in ``BENCHMARK.json`` and runs it.

- the configuration's ``file``: the configuration as it is run (the plain
  tree the program reads, ``sizes`` for the yardstick and the reference,
  the keys the harness overrides and why);
- ``portbench/traffic/<traffic>.json``: the mix's parameters, with the
  ``driver`` (a module of ``portbench/drivers/``) that generates it;
- ``portbench/limits/<workload>.json``: the limit of each number compared;
- ``portbench/metrics/<metric>.py``: one per per-layer metric, whose
  ``read(ctx)`` returns the number or None when it finds nothing to read.

The harness never imports JAX or the JAX package; ``jax_modules`` is the
check a run makes once its window has closed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "speechclip_tpu")


def jax_modules(names=None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is JAX's,
    jaxlib's, flax's or the JAX package's (whole names:
    ``speechclip_tpu_torch`` is not one)."""
    names = list(sys.modules) if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell_spec(name: str, root: str = ROOT) -> Dict:
    """The workload ``name`` with its configuration, traffic and limits
    files loaded, and the metrics it reports."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(root, "portbench", "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return {"workload": w, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": e2e, "per_layer": layer}


def metric_reader(name: str, root: str = ROOT):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(numbers: Dict[str, Dict], limits: Dict[str, Dict]) -> Dict[str, Dict]:
    """{name: {"value", "limit", "ok"}} for every limit of the cell; a
    number the run did not produce fails."""
    out = {}
    for name, lim in limits.items():
        value = numbers.get(name, {}).get("value")
        ok = value is not None and value == value and value <= lim["limit"]
        out[name] = {"value": value, "limit": lim["limit"], "ok": bool(ok)}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cache_dir: Optional[str] = None, t_start: float = 0.0, fault=None,
             root: str = ROOT) -> Dict:
    """Run one cell once -> {"line": the result object, "checks", "notes"}."""
    import torch

    spec = cell_spec(name, root)
    driver = importlib.import_module(f"portbench.drivers.{spec['traffic']['driver']}")
    cache_dir = cache_dir or os.path.join(HERE, ".cache")
    res = driver.run(spec, seed, seconds, trace, device, cache_dir, t_start, fault=fault)
    checks = judge(res["numbers"], spec["limits"])
    metrics = {}
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    if trace:
        for m in spec["per_layer"]:
            value = metric_reader(m["name"], root)(res["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": float(res["e2e"][m["name"]]), "unit": units[m["name"]]}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": int(spec["workload"]["chips"]),
           "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": all(c["ok"] for c in checks.values()), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    tr = res["ctx"].get("trace")
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        line["breakdown"] = {"device_ops": [[n, s] for n, s in tr["device_ops"]],
                             "idle_gaps": [[n, s] for n, s in tr["idle_gaps"]]}
    line["checks"] = {n: {"value": c["value"], "limit": c["limit"]} for n, c in checks.items()}
    notes = {"e2e": res["e2e"], "numbers": res["numbers"],
             "ctx": {k: v for k, v in res["ctx"].items() if k != "trace"}}
    if tr is not None:
        notes["trace"] = {k: tr[k] for k in ("ops", "unknown_ops", "unattributed_device_s")}
    return {"line": line, "checks": checks, "notes": notes}
