#!/usr/bin/env python3
"""How far the flagship train step moves under bf16 rounding alone, on the card.

    python3 scripts/torch_train_probe.py

Run from the repository root on a machine with an NVIDIA H100 and nvcc.
It builds the port's kernels as ``chip_smoke.py`` does (its phase 1) and
takes one train-mode forward and backward of ``flagship_config()`` at
``chip_smoke.py``'s phase-16 point (backend "auto", dropout 0, B = 256 6.4 s
utterances) five ways (``main``), printing for each pair the losses, the
share of the cascaded branch's keyword ids that agree, the keywords' per-row
cosine before VQ, and each trainable leaf's gradient cosine and norm ratio.
It holds nothing and prints no result line: it shows why phase 16 holds the
kernel path's features and gradients against the plain path with the
kernel path's keyword ids imposed.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402

PROBE_NOISE = 2.0 ** -8


def _leaf_names(params, mask, prefix=""):
    """Dotted paths of the trainable leaves, in ``trainable_leaves`` order."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from _leaf_names(v, mask[k], f"{prefix}{k}.")
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from _leaf_names(v, mask[i], f"{prefix}{i}.")
    elif params is not None and mask:
        yield prefix[:-1]


def main():
    """How far phase 16's train step moves under rounding alone. At phase
    16's point ("auto", dropout 0, B = TRAIN_BATCH) one train-mode forward
    and backward five ways: the kernel path; the
    all-plain path; the plain branches on the kernel path's HuBERT features
    (the frozen forward's kernels alone); the all-plain path with the HuBERT
    features scaled by ``1 + u``, ``u`` uniform in +-PROBE_NOISE, and
    rounded to bf16 (no kernel at all); and the all-plain path with the
    kernel path's keyword ids imposed (``imposed_keyword_ids``). Under
    "auto" the cascaded branch runs no kernel. For each pair: the losses,
    the keyword ids that agree, the pre-VQ keywords' per-row cosine, and
    each trainable leaf's gradient cosine and norm ratio."""
    import torch

    from speechclip_tpu_torch.models import branches

    model = smoke._train_model()
    batch = smoke._train_batch(smoke.TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(22))
    pre_vq = {}
    inner = branches._pre_vq_keywords

    def recording(*args):
        keywords, new_state = inner(*args)
        pre_vq["keywords"] = keywords.detach()
        return keywords, new_state

    forward_audio = model.forward_audio

    def kernel_hubert(*args, **kwargs):
        return forward_audio(*args, **{**kwargs, "plain": False})

    def noisy(*args, **kwargs):
        feat, lens = forward_audio(*args, **kwargs)
        gen = torch.Generator(device="cuda").manual_seed(5)
        u = (torch.rand(feat.shape, generator=gen, device="cuda") * 2 - 1) * PROBE_NOISE
        return (feat.float() * (1 + u)).to(feat.dtype), lens

    def run(plain, audio, ids=None):
        model.forward_audio = audio
        state, optimizer, _ = smoke._train_state(model, plain=plain)
        with contextlib.ExitStack() as stack:
            if ids is not None:
                stack.enter_context(smoke.imposed_keyword_ids(ids))
            losses, _, got_ids, grads, _ = smoke._train_grads(model, state, optimizer, batch, plain)
        names = list(_leaf_names(state.params, model.trainable_mask(state.params)))
        model.forward_audio = forward_audio
        return dict(losses=losses, ids=got_ids, grads=grads, keywords=pre_vq["keywords"],
                    names=names)

    branches._pre_vq_keywords = recording
    try:
        runs = {"kernel": run(False, forward_audio), "plain": run(True, forward_audio),
                "plain on kernel HuBERT": run(True, kernel_hubert),
                "plain, noisy input": run(True, noisy)}
        runs["plain, kernel ids"] = run(True, forward_audio, runs["kernel"]["ids"])
    finally:
        branches._pre_vq_keywords = inner
    for a, b in (("kernel", "plain"), ("plain on kernel HuBERT", "plain"),
                 ("kernel", "plain on kernel HuBERT"), ("plain, noisy input", "plain"),
                 ("kernel", "plain, kernel ids")):
        ra, rb = runs[a], runs[b]
        ids = float((ra["ids"] == rb["ids"]).float().mean())
        kcos = smoke.row_cosine_min(ra["keywords"].flatten(0, 1), rb["keywords"].flatten(0, 1))
        smoke.say(f"train probe {a} vs {b}: losses {ra['losses']} vs {rb['losses']}; keyword ids "
            f"agree {ids:.4f}; pre-VQ keywords min row cosine {kcos:.6f}")
        for name, ga, gb in zip(ra["names"], ra["grads"], rb["grads"]):
            cos = float(torch.nn.functional.cosine_similarity(
                ga.float().flatten(), gb.float().flatten(), dim=0))
            ratio = float(ga.float().norm() / gb.float().norm().clamp(min=1e-30))
            smoke.say(f"  {name}: cosine {cos:.6f}, norm ratio {ratio:.6f}, |g| "
                f"{float(gb.float().norm()):.4e}")


if __name__ == "__main__":
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the probe needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smoke.phase_card_and_build()
    main()
