"""Readings of a cell's control and planted faults, at the cell's own size,
for setting its limits (the benchmark's own runs never run this).

    python3 portbench/control.py --workload <name> --seeds 21,22,23 [--program] [--out <file>.jsonl]

The control is the plain reference put in the program's place and
computed a precision step below the configuration's bf16: every matrix
product and convolution on float8 (e4m3) operands. Each is read against
the float32 reference with the cell's own numbers (``compare.py``).

- train cells: one run of the program with a short window, whose own
  numbers are a sound reading ("program"); then the control's first steps
  and its step inside the window (from the program's state before it, as
  the run's reference takes it); and the fault of a step that drops half
  of its rows and takes the mean over the rest, planted in the reference
  in the same places. (A step that returns its state unchanged reads
  ``change_gap`` and ``window_change_gap`` = 1 by the measure's
  definition; an altered row reads ``rows_mismatch`` >= 1, whose limit is
  0.)
- encode cells: the control's features and top-k on batches of the cell's
  pool; and a top-k answer swapped for a gallery item drawn from the seed
  (half of the rows left unencoded reads ``feature_gap`` >= 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


TRAIN_WINDOW_S = 8.0  # long enough for the checked step (at most 8 steps of ~0.55 s)


def train_readings(spec, seed: int, device, cache_dir: str, seconds: float = TRAIN_WINDOW_S):
    import time

    from portbench import corpus as corpus_mod
    from portbench.compare import train_numbers
    from portbench.drivers import trainer_fit
    from portbench.reference import train_ref
    from portbench.reference.speechclip_par import Precision

    res = trainer_fit.run(spec, seed, seconds, False, device, cache_dir, time.perf_counter())
    out = {"program": {k: v["value"] for k, v in res["numbers"].items()}}
    ref, snap = res["ref"], res["prog"]["window"]
    del res
    root = corpus_mod.ensure_corpus(os.path.join(cache_dir, "corpus"), spec["traffic"]["corpus"])
    steps = len(ref["losses"])
    for name, kwargs in (("control_fp8", {"precision": Precision(fp8=True)}),
                         ("half_batch", {"half_batch": True})):
        other = train_ref.run_reference(spec["config"], root, seed, steps, device, **kwargs)
        prog = {"losses": other["losses"], "first_grads": other["first_grads"],
                "params_after": {k: other["initial"][k] + other["change"][k] for k in other["change"]},
                "batches": other["batches"] if name == "control_fp8" else ref["batches"]}
        del other
        if snap is not None:
            win = train_ref.window_step(spec["config"], root, seed, snap, device, **kwargs)
            prog["window"] = dict(
                snap, loss=win["loss"],
                after={k: snap["params"][k].float() + win["change"][k] for k in win["change"]},
                batch=win["batch"] if name == "control_fp8" else ref["window"]["batch"])
        out[name] = {k: v["value"] for k, v in train_numbers(prog, ref).items()}
    return out


def encode_readings(spec, seed: int, device):
    import numpy as np
    import torch

    from portbench.compare import encode_numbers
    from portbench.drivers.encode_retrieve import make_gallery, make_pool, reference_features
    from portbench.reference.speechclip_par import Precision, f32_math

    tf, config = spec["traffic"], spec["config"]
    pool = make_pool(tf, seed, device)
    gallery = make_gallery(tf, seed, config["sizes"]["vision"]["output_dim"], device)
    picks = [pool[i] for i in range(min(2, len(pool)))]
    k = int(tf["top_k"])
    rows = int(tf["reference_rows"])
    ref = reference_features(config, seed, picks, device, rows)
    low = reference_features(config, seed, picks, device, rows, Precision(fp8=True))
    rng = np.random.default_rng(seed)
    out = {"control_fp8": {}, "answer_altered": {}}
    P = Precision(fp8=True)
    with f32_math():
        for r, c in zip(ref, low):
            scores = r @ gallery.T
            idx = torch.topk(P.mm(c, gallery.T), k, dim=-1).indices
            got = encode_numbers(c, idx, r, scores)
            ref_idx = torch.topk(scores, k, dim=-1).indices.clone()
            ref_idx[int(rng.integers(len(ref_idx))), int(rng.integers(k))] = int(
                rng.integers(gallery.shape[0]))
            alt = encode_numbers(r, ref_idx, r, scores)
            for name, res in (("control_fp8", got), ("answer_altered", alt)):
                for key, v in res.items():
                    out[name][key] = max(out[name].get(key, 0.0), v["value"])
    return out


def program_readings(name: str, seed: int, cache_dir: str):
    """The program's own numbers on ``seed``: a run with a short window; the
    numbers do not depend on its length once it holds the checked step."""
    from portbench import harness

    spec = harness.cell_spec(name)
    seconds = TRAIN_WINDOW_S if spec["traffic"]["driver"] == "trainer_fit" else 3.0
    out = harness.run_cell(name, seed, seconds, False, cache_dir=cache_dir)
    return {"program": {k: v["value"] for k, v in out["notes"]["numbers"].items()}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true",
                    help="read the program's own numbers instead (sound runs, in one process)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    from portbench import harness

    spec = harness.cell_spec(args.workload)
    cache_dir = os.path.join(HERE, ".cache")
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        if args.program:
            got = program_readings(args.workload, seed, cache_dir)
        elif spec["traffic"]["driver"] == "trainer_fit":
            got = train_readings(spec, seed, "cuda", cache_dir)
        else:
            got = encode_readings(spec, seed, "cuda")
        rec = {"workload": args.workload, "seed": seed, "readings": got}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
