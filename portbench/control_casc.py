"""Readings of a cascaded train cell's control and planted faults, at the
cell's own size, for setting its limits (the benchmark's own runs never
run this); ``control.py``'s readings for the ``trainer_fit_casc`` driver.

    python3 portbench/control_casc.py --workload train.large_casc.flickr --seeds 21,22 [--out <file>.jsonl]

Per seed: one run of the program with a short window, whose own numbers are
a sound reading ("program"); then

- ``control_fp8``: the plain reference computed on float8 (e4m3) operands
  in every product and convolution, its own keyword ids taken, in the
  program's place: its first steps and its step inside the window (from the
  program's state before it), read against the float32 reference
  teacher-forced on the control's ids;
- ``half_batch``: a step that drops half of its rows and takes the mean
  over the rest, planted in the reference (teacher-forced on the
  program's ids), read against the run's own reference (the keyword
  numbers are left out: the rows differ);
- ``far_id``: the program's keyword choice with one row's id, drawn from
  the seed, replaced by the row's farthest subword, the lowest in the
  reference's scores (the keyword numbers only).

kw-BN's statistics left unchanged read ``bn_state_gap`` = 1 by the
measure's definition, as a state left unchanged reads ``change_gap`` = 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

TRAIN_WINDOW_S = 8.0  # long enough for the checked step (at most 8 steps of ~0.55 s)


def _as_program(other, snap, win, batches, window_batch):
    prog = {"losses": other["losses"], "first_grads": other["first_grads"],
            "params_after": {k: other["initial"][k] + other["change"][k] for k in other["change"]},
            "batches": batches, "scores": other["scores"], "ids": other["own"],
            "bn_change": other["bn_change"]}
    if snap is not None:
        prog["window"] = dict(
            snap, loss=win["loss"], scores=win["scores"], ids=win["own"], batch=window_batch,
            after={k: snap["params"][k].float() + win["change"][k] for k in win["change"]})
    return prog


def far_id_numbers(prog, ref, seed: int):
    """The keyword numbers with one of the program's ids replaced by its
    row's lowest-scored subword."""
    import numpy as np

    from portbench.compare_casc import keyword_numbers

    rng = np.random.default_rng([int(seed), 2])
    ids = [t.clone() for t in prog["ids"]]
    step = int(rng.integers(len(ids)))
    b, k = ids[step].shape
    row, col = int(rng.integers(b)), int(rng.integers(k))
    ids[step][row, col] = int(ref["scores"][step][row, col].argmin())
    return keyword_numbers(prog["scores"], ids, ref["scores"], ref["own"])


def train_readings(spec, seed: int, device, cache_dir: str, seconds: float = TRAIN_WINDOW_S):
    import time

    from portbench import corpus as corpus_mod
    from portbench.compare import train_numbers
    from portbench.compare_casc import casc_numbers
    from portbench.drivers import trainer_fit_casc
    from portbench.reference import train_ref_casc
    from portbench.reference.speechclip_par import Precision

    res = trainer_fit_casc.run(spec, seed, seconds, False, device, cache_dir,
                               time.perf_counter())
    out = {"program": {k: v["value"] for k, v in res["numbers"].items()}}
    prog, ref = res["prog"], res["ref"]
    snap = prog["window"]
    del res
    config = spec["config"]
    root = corpus_mod.ensure_corpus(os.path.join(cache_dir, "corpus"), spec["traffic"]["corpus"])
    steps = len(ref["losses"])
    out["far_id"] = {k: v["value"] for k, v in far_id_numbers(prog, ref, seed).items()}

    fp8 = Precision(fp8=True)
    low = train_ref_casc.run_reference(config, root, seed, steps, device, fp8)
    low_win = (train_ref_casc.window_step(config, root, seed, snap, device, fp8)
               if snap is not None else None)
    forced = train_ref_casc.run_reference(config, root, seed, steps, device, ids=low["own"])
    if snap is not None:
        forced["window"] = train_ref_casc.window_step(config, root, seed, snap, device,
                                                      ids=low_win["own"])
    control = _as_program(low, snap, low_win, low["batches"],
                          None if snap is None else low_win["batch"])
    out["control_fp8"] = {k: v["value"] for k, v in casc_numbers(control, forced).items()}
    del low, low_win, forced, control

    half = train_ref_casc.run_reference(config, root, seed, steps, device, half_batch=True,
                                        ids=prog["ids"])
    half_win = (train_ref_casc.window_step(config, root, seed, snap, device, half_batch=True,
                                           ids=snap["ids"]) if snap is not None else None)
    faulty = _as_program(half, snap, half_win, ref["batches"],
                         None if snap is None else ref["window"]["batch"])
    out["half_batch"] = {k: v["value"] for k, v in train_numbers(faulty, ref).items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from portbench import harness

    spec = harness.cell_spec(args.workload)
    if spec["traffic"]["driver"] != "trainer_fit_casc":
        raise SystemExit(f"{args.workload} is not a cascaded train cell: use control.py")
    cache_dir = os.path.join(HERE, ".cache")
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        got = train_readings(spec, seed, "cuda", cache_dir)
        rec = {"workload": args.workload, "seed": seed, "readings": got}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
