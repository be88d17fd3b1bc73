#!/usr/bin/env python3
"""Whether ``chip_smoke.py``'s phase-20 ``wsum_remat`` check catches a
recompute that drops its centring term, on the card.

    python3 scripts/torch_wsum_fault_probe.py

Run from the repository root on a machine with an NVIDIA H100 and nvcc.
It builds the port's kernels as ``chip_smoke.py`` does (its phase 1), takes
phase 20's B = 128 batch (``bench_variant_config("large_par")``, backend
"auto") and runs ``chip_smoke.wsum_on_off`` twice: as shipped, and with
``FrozenWeightedSumFn.backward`` replaced in this process by one that returns
``w * dots`` for the logits' gradient, without ``- <w, dots>``. It exits 0
when the first passes and the second fails, else 1. It prints no result line.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def _uncentred_backward(ctx, g):
    """``FrozenWeightedSumFn.backward`` with the centring term dropped."""
    import torch

    from speechclip_tpu_torch.models.hubert import _wsum_pass
    from speechclip_tpu_torch.ops.attention import attention_backend

    logits, wav, wav_lengths = ctx.saved_tensors
    w = torch.softmax(logits.float(), dim=0)
    with torch.no_grad(), attention_backend(ctx.backend):
        dots = _wsum_pass(ctx.cfg, ctx.norm_type, ctx.params, wav, wav_lengths, w, g=g,
                          plain=ctx.plain)
    return (w * dots).to(logits.dtype), None, None, None, None, None, None


def _held(models, batch) -> bool:
    """True when ``wsum_on_off`` passes, False when it calls ``fail``."""
    try:
        smoke.wsum_on_off(models, batch)
    except SystemExit:
        return False
    return True


def main() -> int:
    import torch

    from speechclip_tpu_torch.models import hubert
    from speechclip_tpu_torch.ops.attention import attention_backend

    smoke.phase_card_and_build()
    models = {remat: smoke._large_train_model(remat) for remat in (False, True)}
    gen = torch.Generator(device="cuda").manual_seed(36)
    batch = smoke._train_batch(smoke.LARGE_TRAIN_BATCHES[0], gen)
    with attention_backend("auto"):
        smoke.say("as shipped:")
        shipped = _held(models, batch)
        smoke.say("planted fault, the logits' gradient without - <w, dots>:")
        hubert.FrozenWeightedSumFn.backward = staticmethod(_uncentred_backward)
        planted = _held(models, batch)
    smoke.say(f"shipped recompute passes: {shipped}; planted fault caught: {not planted}")
    return 0 if shipped and not planted else 1


if __name__ == "__main__":
    sys.exit(main())
