#!/usr/bin/env python3
"""Drive the PyTorch port (speechclip_tpu_torch) once on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device. Phases, one
line each (a failed check exits non-zero before the last line):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (nvcc, sm_90a, from ``speechclip_tpu_torch/csrc``);
2. each hand-written kernel against its plain PyTorch version on the card,
   at the main path's shapes (HuBERT-base layers: B=64, T=319, H=12;
   branch layer: T=320, H=8, Dh=96), with the error, the tolerance and
   median CUDA-event times of kernel and plain;
3. the main path at full SpeechCLIP-base width from the port's seeded random
   init: ``encode_speech`` on 64 utterances of 6.4 s, then ``retrieve`` top-10
   against a 5000 x 512 L2-normalized gallery; each kernel must have run 13
   times in that forward, and the features must agree with the all-plain
   path on the card;
4. encode + retrieve throughput at one batch (256 utterances if it fits) on
   the kernel path and the plain path.

The last lines are a JSON summary of the kernels and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

BF16_ATOL = 0.125  # bf16 outputs of magnitude <= 8 differ by <= 4 ulp
MIN_COSINE = 0.999
HUBERT_SHAPE = dict(b=64, t=319, d=768, heads=12, f=3072)
BRANCH_SHAPE = dict(b=64, t=320, d=768, heads=8, f=3072)
WAV_SAMPLES = 102400
GALLERY = 5000
TOPK = 10


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median per-call device time, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def row_cosine_min(a, b) -> float:
    import torch

    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def phase_card_and_build():
    import torch

    from speechclip_tpu_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    log = _build.build_log()
    cmd = log.splitlines()[0] if log else "(library already built for these sources)"
    ptxas = [l.strip() for l in log.splitlines() if "registers" in l or "smem" in l]
    say(
        f"phase 1 build: {dt:.1f} s, {_build.GENCODE}, torch {torch.__version__} "
        f"cuda {torch.version.cuda}, cmd: {cmd}"
    )
    for line in ptxas:
        say(f"  ptxas: {line}")
    return smi


def _layer_inputs(shape, gen):
    import torch

    b, t, d, f = shape["b"], shape["t"], shape["d"], shape["f"]
    dev = gen.device
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    bf = torch.bfloat16
    x = rn(b, t, d).to(bf)
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev).to(torch.int32)
    mha = dict(
        w_in=(rn(d, 3 * d) * d**-0.5).to(bf), b_in=0.1 * rn(3 * d),
        w_out=(rn(d, d) * d**-0.5).to(bf), b_out=0.1 * rn(d),
        ln_g=1 + 0.1 * rn(d), ln_b=0.1 * rn(d),
    )
    ffn = dict(
        w1=(rn(d, f) * d**-0.5).to(bf), b1=0.1 * rn(f),
        w2=(rn(f, d) * f**-0.5).to(bf), b2=0.1 * rn(d),
        ln_g=1 + 0.1 * rn(d), ln_b=0.1 * rn(d),
    )
    return x, lens, mha, ffn


def phase_kernels():
    import torch

    from speechclip_tpu_torch.kernels.ffn_block import ffn_block, ffn_block_plain
    from speechclip_tpu_torch.kernels.mha_block import (
        mha_layer_block,
        mha_layer_block_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {"mha_layer_block": {}, "ffn_block": {}}
    for label, shape in (("hubert", HUBERT_SHAPE), ("branch", BRANCH_SHAPE)):
        x, lens, m, f = _layer_inputs(shape, gen)
        h = shape["heads"]
        calls = {
            "mha_layer_block": (
                lambda: mha_layer_block(x, m["w_in"], m["b_in"], m["w_out"], m["b_out"],
                                        m["ln_g"], m["ln_b"], lens, h, "post", 1e-5),
                lambda: mha_layer_block_plain(x, m["w_in"], m["b_in"], m["w_out"], m["b_out"],
                                              m["ln_g"], m["ln_b"], lens, h, "post", 1e-5),
            ),
            "ffn_block": (
                lambda: ffn_block(x, f["w1"], f["b1"], f["w2"], f["b2"],
                                  f["ln_g"], f["ln_b"], "post", 1e-5),
                lambda: ffn_block_plain(x, f["w1"], f["b1"], f["w2"], f["b2"],
                                        f["ln_g"], f["ln_b"], "post", 1e-5),
            ),
        }
        for name, (kern, plain) in calls.items():
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = float((got.float() - want.float()).abs().max())
            cos = row_cosine_min(got, want)
            finite = bool(torch.isfinite(got).all())
            ms = cuda_time_ms(kern)
            plain_ms = cuda_time_ms(plain)
            say(
                f"phase 2 {name} [{label} B={shape['b']} T={shape['t']} "
                f"H={h} Dh={shape['d'] // h} post]: max_abs_err {err:.6f} "
                f"(tol {BF16_ATOL}), min row cosine {cos:.6f} (tol {MIN_COSINE}), "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            )
            if not (finite and err <= BF16_ATOL and cos >= MIN_COSINE):
                fail(f"{name} [{label}] disagrees with its plain version")
            results[name][label] = dict(err=err, ms=ms, plain_ms=plain_ms)
    return results


def _model(batch_chunk: int):
    from speechclip_tpu_torch import SpeechCLIPModel, base_config

    cfg = base_config()
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, conv_batch_chunk=batch_chunk)
    )
    return SpeechCLIPModel(cfg)


def _wavs(b: int, gen):
    import torch

    wav_len = torch.randint(
        WAV_SAMPLES // 2, WAV_SAMPLES + 1, (b,), generator=gen, device="cuda"
    )
    wav = torch.randn(b, WAV_SAMPLES, generator=gen, device="cuda") * 0.1
    pad = torch.arange(WAV_SAMPLES, device="cuda")[None, :] >= wav_len[:, None]
    return wav.masked_fill(pad, 0.0), wav_len


def phase_main_path(model, params, gallery):
    import torch

    from speechclip_tpu_torch import retrieve
    from speechclip_tpu_torch.kernels.ffn_block import ffn_block
    from speechclip_tpu_torch.kernels.mha_block import mha_layer_block

    gen = torch.Generator(device="cuda").manual_seed(2)
    wav, wav_len = _wavs(64, gen)
    n_layers = model.audio_cfg.encoder_layers + model.config.parallel_branch.n_layers
    mha_layer_block.launches = 0
    ffn_block.launches = 0
    feats = model.encode_speech(params, wav, wav_len)["parallel_audio_feat"]
    torch.cuda.synchronize()
    launches = {"mha_layer_block": mha_layer_block.launches, "ffn_block": ffn_block.launches}
    _, top = retrieve(feats, gallery, TOPK)
    plain_feats = model.encode_speech(params, wav, wav_len, plain=True)["parallel_audio_feat"]
    _, plain_top = retrieve(plain_feats, gallery, TOPK)
    torch.cuda.synchronize()

    cos = row_cosine_min(feats, plain_feats)
    norms = feats.norm(dim=-1)
    top1 = float((top[:, 0] == plain_top[:, 0]).float().mean())
    overlap = sum(
        len(set(a.tolist()) & set(b.tolist())) for a, b in zip(top, plain_top)
    ) / float(top.numel())
    say(
        f"phase 3 main path: encode_speech B=64 x {WAV_SAMPLES} samples (lengths "
        f"{int(wav_len.min())}..{int(wav_len.max())}) -> {tuple(feats.shape)}, "
        f"launches {launches} (expect {n_layers} each), min row cosine vs plain "
        f"{cos:.6f} (tol {MIN_COSINE}), |feat| in [{float(norms.min()):.6f}, "
        f"{float(norms.max()):.6f}], retrieve top-{TOPK} of {gallery.shape[0]}: "
        f"top-1 agreement {top1:.4f}, top-{TOPK} overlap {overlap:.4f}"
    )
    if tuple(feats.shape) != (64, model.config.clip_embed_dim):
        fail(f"feature shape {tuple(feats.shape)}")
    if not bool(torch.isfinite(feats).all()):
        fail("non-finite features")
    if any(n != n_layers for n in launches.values()):
        fail(f"kernel launches {launches}, expected {n_layers} each")
    if cos < MIN_COSINE:
        fail(f"kernel-path features disagree with the plain path (cosine {cos})")
    if tuple(top.shape) != (64, TOPK):
        fail(f"top-k shape {tuple(top.shape)}")
    return launches


def phase_throughput(model, params, gallery, smi):
    import torch

    from speechclip_tpu_torch import retrieve

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for batch in (256, 128):
        try:
            wav, wav_len = _wavs(batch, gen)
            for plain in (False, True):
                def step():
                    feats = model.encode_speech(params, wav, wav_len, plain=plain)
                    return retrieve(feats["parallel_audio_feat"], gallery, TOPK)[1]

                step()
                torch.cuda.synchronize()
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    step()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                times.sort()
                out["plain" if plain else "kernel"] = batch / times[1]
            break
        except torch.cuda.OutOfMemoryError:
            say(f"phase 4: batch {batch} does not fit; halving")
            out = {}
            torch.cuda.empty_cache()
    if not out:
        fail("no throughput batch fits")
    say(
        f"phase 4 encode+retrieve throughput at B={batch} on {smi}: kernel path "
        f"{out['kernel']:.2f} utt/s, plain path {out['plain']:.2f} utt/s "
        f"(median of 3, host clock, after one warm-up)"
    )
    return batch, out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the port's smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    try:
        import speechclip_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"speechclip_tpu_torch not importable beside this script: {e}", file=sys.stderr)
        return 2

    from speechclip_tpu_torch.models.speechclip import cast_params

    smi = phase_card_and_build()
    kern = phase_kernels()

    model = _model(batch_chunk=64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cast_params(model.init(gen), model.compute_dtype)
    gallery = torch.nn.functional.normalize(
        torch.randn(GALLERY, model.config.clip_embed_dim, generator=gen, device="cuda"),
        dim=-1,
    )
    launches = phase_main_path(model, params, gallery)
    phase_throughput(model, params, gallery, smi)

    replaces = {
        "mha_layer_block": ("speechclip_tpu_torch/csrc/attention_core.cu",
                            "speechclip_tpu/kernels/mha_block.py:59"),
        "ffn_block": ("speechclip_tpu_torch/csrc/gemm_epilogue.cu",
                      "speechclip_tpu/kernels/ffn_block.py:40"),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": replaces[name][0],
            "replaces": replaces[name][1],
            "launches": launches[name],
            "max_abs_err": max(r["err"] for r in kern[name].values()),
            "ms": kern[name]["hubert"]["ms"],
            "plain_ms": kern[name]["hubert"]["plain_ms"],
        }
        for name in ("mha_layer_block", "ffn_block")
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
