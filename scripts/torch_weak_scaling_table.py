"""The collectives of the port's train step by mesh axis, at a fixed batch
per data rank: the counterpart of scripts/weak_scaling_table.py over
``speechclip_tpu_torch/parallel/inventory.py``.

For each ``(data, model)`` in (1, 1), (2, 1), (1, 2), (2, 2) it spawns
``data * model`` gloo ranks on the CPU (world 1 runs in this process),
builds the tiny flagship (both branches, precision 32) from one seed on
every rank, takes one warm-up step, then records the collectives of one
train step on rank 0: their count and payload per step on each axis (the
data axis: the features' all-gather and the gradients' mean; the model
axis: the attention heads' all-gather and the row-parallel partials'
all-reduce), the rank-3 float gathers of the data axis (JAX's gate: none)
and the step's wall time. The inventory does not depend on the hardware;
the CPU times only show that each mesh steps (the ranks share one host).

Run: python scripts/torch_weak_scaling_table.py [BATCH_PER_DATA_RANK]
Imports torch and the port only.
"""

import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MESHES = ((1, 1), (2, 1), (1, 2), (2, 2))


def _batch(n: int):
    import numpy as np

    rng = np.random.default_rng(0)
    wav_len = rng.integers(1000, 2001, n).astype(np.int32)
    wav = rng.standard_normal((n, 2000)).astype(np.float32)
    wav *= np.arange(2000)[None, :] < wav_len[:, None]
    return {"wav": wav, "wav_len": wav_len,
            "image": rng.standard_normal((n, 32, 32, 3)).astype(np.float32),
            "id": (np.arange(n) // 2).astype(np.int32)}


def measure(mesh, global_batch: int) -> dict:
    """One rank's warm-up step and recorded step -> the inventory by axis
    and the recorded step's wall seconds."""
    import dataclasses

    import torch

    from speechclip_tpu_torch.config import tiny_flagship_config
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
    from speechclip_tpu_torch.parallel.inventory import recording
    from speechclip_tpu_torch.parallel.mesh import shard_batch
    from speechclip_tpu_torch.training.optim import build_optimizer
    from speechclip_tpu_torch.training.train_step import (
        create_train_state,
        make_train_step,
        place_state,
        to_device,
    )

    model = SpeechCLIPModel(dataclasses.replace(tiny_flagship_config(), precision=32),
                            device="cpu")
    state = create_train_state(model, seed=0, mesh=mesh)
    optimizer, scheduler = build_optimizer(model.config, state.params,
                                           model.trainable_mask(state.params))
    state = place_state(state, mesh, model, optimizer)
    step = make_train_step(model, optimizer, scheduler, mesh=mesh)
    batch = to_device(shard_batch(_batch(global_batch), mesh), "cpu")
    state, _ = step(state, batch)
    with recording(mesh) as inv:
        t0 = time.perf_counter()
        step(state, batch)
        seconds = time.perf_counter() - t0
    rank3 = sum(1 for op, dt, dims, _, axis in inv.entries
                if op == "all-gather" and axis == "data" and len(dims) >= 3
                and dt in ("f32", "bf16"))
    return {"by_axis": inv.by_axis(), "rank3": rank3, "seconds": seconds}


def _rank(rank: int, out_dir: str, data: int, model: int, global_batch: int) -> None:
    import torch

    from speechclip_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    got = measure(make_mesh(devices=["cpu"] * (data * model), model=model), global_batch)
    if rank == 0:
        torch.save(got, os.path.join(out_dir, "rank0.pt"))


def run(data: int, model: int, per_data_rank: int) -> dict:
    import torch

    from speechclip_tpu_torch.parallel.mesh import make_mesh, spawn

    global_batch = per_data_rank * data
    if data * model == 1:
        torch.set_num_threads(1)
        return measure(make_mesh(devices=["cpu"]), global_batch)
    tmp = tempfile.mkdtemp(prefix="scl_scaling_")
    try:
        spawn(_rank, data * model, "gloo", args=(tmp, data, model, global_batch))
        return torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cell(inv: dict, op: str) -> str:
    count, nbytes = inv.get(op, (0, 0))
    return f"{count}, {nbytes / 1024:.1f}"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    per_data_rank = int(argv[0]) if argv else 4
    print("| data | model | global batch | axis | all-gather (n, KB/step) | "
          "all-reduce (n, KB/step) | rank-3 data gathers | step ms (CPU, gloo) |")
    print("|---|---|---|---|---|---|---|---|")
    for data, model in MESHES:
        got = run(data, model, per_data_rank)
        axes = {a: got["by_axis"][a] for a in ("data", "model") if a in got["by_axis"]}
        axes = axes or {"-": {}}
        for axis, inv in axes.items():
            print(f"| {data} | {model} | {per_data_rank * data} | {axis} | "
                  f"{_cell(inv, 'all-gather')} | {_cell(inv, 'all-reduce')} | {got['rank3']} | "
                  f"{got['seconds'] * 1e3:.1f} |")


if __name__ == "__main__":
    main()
