#!/usr/bin/env python3
"""Drive the PyTorch port (speechclip_tpu_torch) once on one NVIDIA H100.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA device. Phases, one
line each (a failed check exits non-zero before the last line):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (nvcc, sm_90a, from ``speechclip_tpu_torch/csrc``);
2. each hand-written kernel against its plain PyTorch version on the card,
   at the shapes its paths give it (HuBERT-base layers: B=64, T=319, H=12;
   branch layer: T=320, H=8, Dh=96; ``mha_layer_block`` also at T=600 and
   at its gate's largest T=782; ``attention_vmem`` at the 17 s shapes and a
   causal one; ``flash_attention`` at the flash-backend shape, a 17 s shape
   and the causal CLIP-text shape, in bf16 and, as ``forward_text`` runs
   it, in f32; the large models' layers: HuBERT-large's pre-norm layer at
   B=64, T=319, H=16, the large branch's post-norm layer at T=320, H=8,
   Dh=128, and the large cascaded head at Dh=1024 in bf16 and f32;
   ``pos_conv`` at the encode and large train batches, B=256, T=319, D=768
   and 1024, and a served 17 s batch, beside cuDNN's grouped conv), with
   the error, the tolerance and
   median CUDA-event times of kernel and plain; and the wgmma GEMM of
   ``mha_layer_block`` and ``ffn_block`` alone at the main path's four
   products (QKV, out-proj, fc1, fc2 at M = 64 x 319) and one ragged shape,
   against the f32 product plus epilogue, beside ``torch.matmul``;
3. the main path at full SpeechCLIP-base width from the port's seeded random
   init: ``encode_speech`` on 64 utterances of 6.4 s, then ``retrieve`` top-10
   against a 5000 x 512 L2-normalized gallery; each kernel must have run 13
   times in that forward, and the features must agree with the all-plain
   path on the card;
4. encode + retrieve throughput at one batch (256 utterances if it fits) on
   the kernel path and the plain path;
5. the long-utterance paths: 16 buffers of 272000 samples (17 s, T=849:
   13 ``attention_vmem`` launches, no fused kernel) and of 192000 samples
   (12 s, T=599: 13 ``mha_layer_block`` launches, the FFN on the torch
   chain), each checked against the plain path and retrieved as in 3;
6. the flash backend (``attention_backend("pallas")``): 64 utterances of
   6.4 s, 13 ``flash_attention`` launches and no fused kernel;
7. encode + retrieve throughput of each path of 5 and 6, kernel and plain;
8. the conv A/B: ``fused_conv_chain`` against the port's cuDNN conv1..6
   chain (``models/hubert.py``) on the same weights and input, CUDA-event
   medians taken in turns (times only: the two differ in GELU form and
   rounding point); phase 2 gives the chain's layers one by one (event and
   device time, share of each layer's bound);
9. the cascaded branch (``shipped_cascaded_config()``: K = 8 keywords, one
   768-wide attention head, kw-BN, VQ over the 8112-row Flickr vocabulary,
   the CLIP text tower over K + 2 tokens) on 64 utterances of 6.4 s,
   backend "auto" (12 ``mha_layer_block`` + 12 ``ffn_block``) and
   "pallas" (25 ``flash_attention``: 12 HuBERT layers, the 768-wide head,
   12 causal text layers), each against the all-plain path: pre-VQ cosine
   scores, keyword ids, features of the rows whose ids all agree, top-k;
10. encode + retrieve throughput of both cascaded paths, kernel and plain;
11. the ViT-B/32 gallery: ``forward_image`` on 256 uint8 images of 256 x 256
    (on-device resize and normalize, the tower, the projection) under "auto"
    (no kernel) and "pallas" (12 ``flash_attention``), against the all-plain
    path and each other; images/s;
12. text: ``forward_text`` on 256 x 77 token ids with their EOT positions;
    the tower runs in f32 (the token table's dtype, as in JAX): under
    "auto" no kernel, under "pallas" 12 causal ``flash_attention`` in its
    f32 form, held to the plain path with f32 limits; sequences/s;
13. the validation epoch's retrieval eval at Flickr8k's test-split shape
    (5000 utterances of up to 6.4 s, 1000 uint8 images; encode_speech and
    forward_image in batches, ``collect_validation_outputs``,
    ``retrieval_metrics`` at recall@1/5/10 both ways), held to a float64
    recompute; its wall time;
14. the ViT-L/14 image tower alone at B=64 under "auto" (24
    ``mha_layer_block``), against the plain path; images/s;
15. the ModifiedResNet RN50 tower at B=64 (no kernel): bf16 features
    against f32 (TF32 off); images/s;
16. training (``flagship_config()``: both branches over the frozen HuBERT
    and CLIP towers; bench.py's train batch of 256 utterances of 6.4 s,
    224 x 224 images, ids ``arange(B) % (B // 5)``) at dropout 0: one
    train-mode forward and backward on the kernel path and on the all-plain
    path from the same params, held to each other (losses 1e-2 relative;
    then, against the plain path with the kernel path's keyword ids
    imposed on its VQ, whose argmax flips under rounding alone: features
    per-row cosine 0.999, each live trainable leaf's gradient cosine 0.99,
    ``grad_norm`` 2 %, the kw-BN running statistics 1e-3; the cascaded
    branch's keywords before VQ, on the kernel path's HuBERT output: mean
    row cosine 0.999 against the plain branch, the worst row against the
    f32 branch within 1e-3 of the plain bf16 branch's); then one step through
    ``make_train_step`` on each, with every count at 0 before it: under
    "auto" 13 ``mha_layer_block`` + 13 ``ffn_block`` (12 frozen HuBERT
    layers under no_grad, the parallel branch's layer with a gradient) and
    one backward recompute of each; under "pallas" at B = 64, 38
    ``flash_attention`` (HuBERT 12, the image tower 12, the cascaded head,
    the text tower's 12 and the parallel branch, the last 14 with a
    gradient and a recompute each);
17. the timed train step at the flagship's dropout 0.1 (12 + 12 launches a
    step: dropout keeps the branch layer off the kernels): ms per step (the
    median and range of 10 back-to-back steps by CUDA events, after 2
    warm-up steps) on the kernel path, with the image-feature cache
    (``image_feat_frozen``, the frozen tower's output computed once) and on
    the plain path, each from its own train state; peak memory; every
    step's loss finite;
18. the trainer: a seeded Flickr8k-shaped corpus written to a temporary
    directory (770 train pairs of 6.5-10 s, 250 dev pairs of 3-17 s,
    JPEGs where PIL works, else a FlickrDataset subclass hands out the
    seeded images); ``configs/base/spchclp_p.yaml`` through the port's CLI
    (``run_task.main``, in this process) and ``spchclp_c.yaml`` through
    ``Trainer`` with slim checkpoints, each at full width, B = 256, 6 steps,
    2 validations (batches of 16) and checkpoints: every train step's and
    eval batch's launches against the gates' counts (``attention_vmem`` on
    the 17 s bucket), no plain kernel on a CUDA tensor, recall against a
    float64 recompute, the files and ``config.yaml``, step 1 against
    ``make_train_step`` bitwise, step 3's checkpoint restored bitwise, a
    resumed fit to step 6; the trainer's ms/step from its
    ``steps_per_sec``, the loop's host share, the cache, validation and
    save times; the cascaded run with the CLIP tokenizer (over a synthetic
    merges file with CLIP's 49 408-id layout, ``SPEECHCLIP_BPE_PATH``:
    CLIP's own file is not in the repository), ``tokenizeText`` and the
    keyword diagnostics at each validation: ``detokenizeText/`` files,
    ``kw_hit_rate/kw_0..7`` in the validation lines, the hit rates equal to
    a float64 recompute, their host seconds;
19. the large models' encode + retrieve (``bench_variant_config("large_par")``:
    HuBERT-large's 24 pre-norm layers of 16 heads, the s3prl per-state
    LayerNorm, the 1024-wide parallel branch, 768-wide features; seeded
    random weights) at B = 64 and B = 256 x 6.4 s against the all-plain
    path, 25 ``mha_layer_block`` a forward and no ``ffn_block``
    (``ffn_eligible`` fails at D = 1024, F = 4096); the forward with
    ``wsum_remat`` on against it off (bf16 limits) and its launches; utt/s
    at B = 256 (bench.py's hubert_large_utt_per_sec shape); the large
    cascaded branch under "auto" (24 ``mha_layer_block``) and "pallas" (37
    ``flash_attention``: 24 HuBERT layers, the 1024-wide head, 12 text
    layers) at B = 64 against the all-plain path;
20. the large train step (``large_par``, dropout 0.1) at B = 128 and 256:
    ``wsum_remat`` on against off from one train state (loss, the
    weighted-sum logits' gradient, ``grad_norm``); ms per step and peak GiB
    off and on with the image-feature cache (24 ``mha_layer_block`` a step,
    48 with the recompute) and at B = 128 with the images (24 more for the
    ViT-L/14 tower);
21. the trainer on phase 18's corpus with ``configs/large_flickr``:
    ``spchclp_p.yaml`` through the CLI and ``spchclp_c.yaml`` with
    ``audio_encoder.wsum_remat=true`` through ``Trainer``, each checked as
    phase 18 checks (the eval buckets past T = 460 run ``attention_vmem``
    at D = 1024), each with a resumed fit;
22. the trainable encoder and towers (``flagship_config()`` with the
    trainable switches, seeded random weights, 6.4 s utterances): (a) the
    full fine-tune (``audio_trainable``, HuBERT's dropouts at 0, as
    ``audio_encoder.custom`` sets them) at B = 64, one train-mode forward
    and backward on the kernel path against the plain path at phase 16's
    limits, with the gradient cosines of the conv front end, ``pos_conv``
    and each HuBERT layer, then a counted step: 13 ``mha_layer_block`` + 13
    ``ffn_block`` launches and 13 + 13 recomputes; (b) ``unfreeze_layers``
    [10, 11]: only those layers (and the branches, projections and weighted
    sum) hold a gradient and move in a step, 3 + 3 recomputes; and
    ``reinit_layers`` [11]: ``load_pretrained`` changes layer 11 alone, a
    step moves it and the top LayerNorm alone; (c) ms per step (median and
    range of 3 steps by CUDA events after 2 warm-ups) and peak GiB at the
    largest of B = 256 / 128 / 64 that fits: the full fine-tune at dropout
    0 on the kernel and the plain path (and the kernel path again at the
    plain path's batch), at HuBERT's dropout 0.1 with ``remat`` off and
    on, and ``unfreeze_layers`` with the image cache;
    (d) the trainable ViT-B/32 tower under "auto" and "pallas" (12 more
    ``flash_attention`` recomputes) and the trainable text tower under
    "pallas", each against the plain path; the trainer's image cache and
    an RN50 config refuse a trainable image tower; (e) the large partial
    fine-tune (``large_par``, ``unfreeze_layers`` [22, 23], ``remat`` on,
    dropout 0, the image cache, B = 128): 24 + 2 + 1 ``mha_layer_block``
    launches (the two layers again under ``remat``), 2 + 1 recomputes, ms
    per step and peak GiB;
23. serving (``speechclip_tpu_torch/serving.py``): the seeded
    ``flagship_config()`` train state written as a slim run checkpoint
    (``config.yaml`` beside it), served through
    ``EncoderService.from_checkpoint`` at bench.py's b32 serving point
    (buckets of 102400 and 272000 samples, a fixed batch of 32, bf16-cast
    weights, int16 wav, 60 ms coalescing, ``warmup()`` first):
    ``drive_requests`` of 256 requests at concurrency 64 over bench.py's 8
    wavs of 3.2-6.4 s (one untimed half drive, then 3 timed: the best utt/s,
    the range, p50 / p99 latency), then 32 requests of 12-17 s; each
    drive's launches against the gates' count per batch (13
    ``mha_layer_block`` + 13 ``ffn_block`` on the 6.4 s bucket, 13
    ``attention_vmem`` on the 17 s one; the cascaded head's route at each
    T from ``ops/attention.py``'s table) times the batches run, no plain
    kernel version on a CUDA tensor; 8 served answers per bucket against
    ``encode_speech(plain=True)`` on the batch they were padded into
    (parallel feature per-row cosine 0.999, keyword ids 0.9, the cascaded
    feature on the rows whose ids all agree); one batch's encoder call
    timed alone and back to back; and the HTTP front on a thread
    (``/encode_speech`` npy float32 and int16, ``/gallery/add`` JPEG where
    PIL works, ``/retrieve?k=5``, ``/encode_text``, ``/gallery/save`` and
    ``/gallery/load``, ``GET /healthz``, each held to the direct call; a
    malformed payload answers 400);
24. the text side: the CLIP tokenizer over the synthetic merges file
    (256 seeded captions tokenized on the host, ms), ``ClipWrapper`` over
    ViT-B/32 from a seeded init: ``prep_text`` -> ``encode_text`` under
    "pallas" (12 f32 ``flash_attention``) against the plain path at phase
    12's f32 limits, with the full table and with the reduced Flickr one
    (8112 rows, SOT and EOT remapped); ``get_scores`` against
    ``encode_image`` and ``encode_text`` in float64; ``deTokenize`` of each
    row to its EOT equal to its caption; sequences/s;
25. the s3prl upstreams (``audio_encoder.type: s3prl_plus``): APC at its own
    widths (80 mels, 3 GRU layers of 512) under the parallel branch at
    d_model 512 (CLS prepended at the upstream's width, no input
    projection), encode + retrieve at B = 256 x 6.4 s against the plain path
    (phase 3's cosine limit), the branch layer's launches against the gates
    (``mha_layer_block`` and ``ffn_block`` once a forward), utt/s, the
    log-mel, GRU-stack and branch times and cuDNN's GRU beside the step
    loop (timed only); one train step at B = 64 (finite loss, the frozen
    upstream unchanged, the branch and weighted sum moved); and
    ``modified_cpc`` with ``feat_select_idx`` [1]: one forward at B = 64;
26. export and the artifact backend (run right after phase 23): phase 23's
    checkpoint exported by ``python -m speechclip_tpu_torch.export`` in a
    subprocess (``--batch 32 --wav-samples 102400 272000 --dtype bf16
    --compact-wav``: ``encode_speech@<n>.pt2``, ``encode_image.pt2``,
    ``encode_text.pt2``), and through the Python API ``encode_speech`` at
    6.4 s and ``encode_text`` under "pallas" (both ``flash_attention``
    forms) and a polymorphic ``encode_speech`` (the same weights,
    ``conv_batch_chunk`` 0); each artifact's export seconds and MB; each
    loaded in a fresh process that must not import the model code, its
    graph's kernel nodes equal to ``_expected_launches`` for its surface
    and bucket and one call's launches equal to its nodes; the artifacts
    against the direct calls on seeded inputs (max abs difference and
    whether bitwise; per-row cosine 0.99999, keyword ids and ``retrieve``'s
    top-10 equal), the polymorphic one at B = 1, 3 and 32; where the host
    first waits for the card in an artifact call and in the direct call
    (``set_sync_debug_mode("error")``); then the CLI's artifacts served by
    ``EncoderService(artifact_dir)`` with phase 23's drives (launches per
    batch times the batches, no plain version on a CUDA tensor), utt/s and
    p50 / p99 printed beside phase 23's;
27. data parallelism (``speechclip_tpu_torch/parallel/``): (a), run inside
    phase 18 while its corpus exists, the same CLI argv in a world-1
    ``torchrun`` environment, so the task joins an NCCL group and every
    collective runs at world 1: its metric records and its final params
    and kw-BN statistics bitwise phase 18's, the NCCL version printed; (b)
    ``flagship_config()`` at full width from one seeded init, world 1 in
    this process and a world of two gloo ranks on cuda:0
    (``parallel.mesh.spawn``) on one global batch: dropout 0 under "auto"
    (B = 256, 128 a rank, 2 steps: 13 ``mha_layer_block`` + 13
    ``ffn_block`` a rank a step) and "pallas" (B = 64, phase 16's flash
    counts a rank), and dropout 0.1 (2 steps, the global batch's masks):
    the loss, each live leaf's gradient cosine and norm, ``grad_norm``, the
    params after the steps, kw-BN's statistics and the VQ's perplexities
    within DP_LIMITS, the ranks' params bitwise equal, and a planted
    gather without the sum over the ranks outside the limits; each rank's
    step ms (two ranks sharing one card: not a scaling figure); (c) rank
    0's collectives of one step: the features and ids the only gathers,
    one gradient all-reduce of the trainable leaves' bytes, the rest
    statistics and the features' gradients.

Rates (utt/s, images/s, sequences/s) come from CUDA events around as many
back-to-back calls as fill about 1 s.

Phase 2 also holds each kernel's backward (the four with a JAX
``custom_vjp``: ``mha_layer_block`` at the HuBERT layer and at
HuBERT-large's "pre" layer, ``ffn_block`` at the HuBERT layer,
``attention_vmem`` at a 17 s shape, ``flash_attention`` at the cascaded
head, at the text tower's causal K + 2 rows in bf16 and f32, at ViT-B/32's
layer and at the text tower's f32 causal layer): the gradients through the
kernel's autograd.Function must equal the plain version's own autograd
gradients bit for bit (the backward is the plain recompute), and the
backward is timed (CUDA events, then torch.profiler) beside one SDPA
forward + backward on the same inputs (for the layer rows, on the layer's
attention core alone).

Phase 2 also gives each kernel's bound (the larger of its FLOPs over 989
TFLOP/s and its bytes over 3.35 TB/s, counted from that row's shapes and
key lengths) and, for the attention kernels and the GEMM, the time of one
library call on the same inputs (``F.scaled_dot_product_attention``,
``torch.matmul``, and ``F.multi_head_attention_forward`` for
``mha_layer_block``'s "none" form; timed only, the port never calls
them). The event times
of a row include the host's launch path, which dominates rows under ~0.1
ms; so every row also gives the kernel's (and the library call's) device
time per call from a torch.profiler pass over 20 calls of each (the
kernels each launched, summed; ours told apart by name, and split one by
one for the layer rows), after every event timing of phase 2.

Before each path runs, every kernel's launch count is set to 0; it is read
right after, so the counts in the summary are that path's own.

The last lines are a JSON summary of the kernels (with their backward
rows and recompute counts), of the timed train step, of the trainer, of
serving, of export, of the text side, of the upstreams and of data
parallelism (``data_parallel``) and, last,
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.

    python3 chip_smoke.py --profile

runs phase 1, then, in place of the checks, an A/B of the wgmma GEMM (both
tile widths) against ``torch.matmul`` at the main path's four products with
each call's host launch path, the conv kernel's two warpgroup tiles on each
layer of the chain and the SM clock and power the chain holds the card at,
one torch.profiler step per path of 3, 5, 6
and 9 (wall and device ms, peak memory, the largest kernels), the HuBERT
front end split into its parts (conv0, conv1..6, pos_conv), and the same
for the gallery side (the ViT-B/32 gallery under both backends and its
preprocessing alone, text, the ViT-L/14 and RN50 towers; the eval of
phase 13 in parts), and the train step of phase 17 (profiled, with the
image-feature cache, and split into the frozen HuBERT forward, the frozen
image tower and the rest), and the large paths (``phase_profile_large``:
phase 19's encode at B = 256, profiled and split into HuBERT-large's front
end, its layers, the s3prl weighted sum and the rest; phase 20's B = 256
image-cache step with ``wsum_remat`` off and on), and phase 22's full
fine-tune (``phase_profile_trainable``: one profiled step, and the step
split into HuBERT's forward, the plain recomputes, ``pos_conv``'s backward
and the rest); it prints no result line.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()

BF16_ATOL = 0.125  # bf16 outputs of magnitude <= 8 differ by <= 4 ulp
MIN_COSINE = 0.999
HUBERT_SHAPE = dict(b=64, t=319, d=768, heads=12, f=3072)
BRANCH_SHAPE = dict(b=64, t=320, d=768, heads=8, f=3072)
# mha_layer_block on longer rows: 12 s of audio, and the gate's largest T
# at base width
REPAIR_SHAPES = {"12 s": dict(HUBERT_SHAPE, b=16, t=600),
                 "gate limit": dict(HUBERT_SHAPE, b=16, t=782)}
# The large models' layers: HuBERT-large's pre-norm layer (16 heads of 64)
# and the large parallel branch's post-norm layer (8 heads of 128); their
# FFN fails ffn_eligible at D = 1024, F = 4096 and runs in torch
LARGE_LAYER_SHAPES = {"hubert-large": dict(b=64, t=319, d=1024, heads=16, f=4096, mode="pre"),
                      "large branch": dict(b=64, t=320, d=1024, heads=8, f=4096, mode="post")}
# flash_attention on the large cascaded branch's one 1024-wide head over
# T + K = 327 rows under "pallas", in bf16 and (precision 32) in f32
LARGE_FLASH_SHAPE = (64, 1, 327, 1024, True, False, True)
# (b, h, l, dh, lens, causal, packed): packed = head-split views of one qkv
# buffer, as the dispatcher hands them over
ATTENTION_SHAPES = {
    "attention_vmem": {
        "hubert 17s": (16, 12, 849, 64, True, False, True),
        "branch 17s": (16, 8, 850, 96, True, False, True),
        "causal": (64, 8, 256, 64, False, True, False),
        # phase 28's model axis: a rank's 8 of HuBERT-large's and ViT-L/14's
        # 16 heads at B = 32
        "hubert-large local heads": (32, 8, 319, 64, True, False, True),
        "vit-l/14 local heads": (32, 8, 257, 64, False, False, True),
    },
    "flash_attention": {
        "flash backend": (64, 12, 319, 64, True, False, True),
        "hubert 17s": (16, 12, 849, 64, True, False, True),
        "clip text causal": (64, 8, 77, 64, False, True, False),
        # the cascaded branch: one 768-wide head over T + K = 327 rows, and
        # the CLIP text tower's causal K + 2 = 10 tokens
        "cascaded 768": (64, 1, 327, 768, True, False, True),
        "text tower K+2": (64, 8, 10, 64, False, True, True),
    },
}
# The gallery's phase-2 rows: flash_attention under "pallas" on ViT-B/32's
# and ViT-L/14's layers, and mha_layer_block on ViT-L/14's under "auto"
GALLERY_FLASH_SHAPES = {
    "vit-b/32": (256, 12, 50, 64, False, False, True),
    "vit-l/14": (64, 16, 257, 64, False, False, True),
}
VIT_L14_SHAPE = dict(b=64, t=257, d=1024, heads=16, f=4096)
# forward_text's causal layers under "pallas", in f32 (the tower runs in its
# f32 token table's dtype): flash_attention's f32 form
TEXT_F32_FLASH_SHAPE = (256, 8, 77, 64, False, True, True)
# The wgmma GEMM's rows: label -> (M, N, K, epilogue id), the four
# products of the main path's layer at M = 64 x 319, and one ragged shape
GEMM_SHAPES = {
    "qkv": (64 * 319, 2304, 768, 0),
    "out-proj": (64 * 319, 768, 768, 2),
    "fc1": (64 * 319, 3072, 768, 1),
    "fc2": (64 * 319, 768, 3072, 2),
    "ragged": (383, 776, 1000, 3),
}
# HuBERT-base conv1..conv6 (k, stride 2) on conv0's output for 6.4 s
CONV_KERNELS = (3, 3, 3, 3, 2, 2)
CONV_SHAPE = dict(b=64, t=20479, c=512)
PEAK_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
F32_TOL = 1e-4  # f32 outputs: max abs diff, in units of max(1, max |want|)
MIN_F32_COSINE = 0.99999
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
WAV_SAMPLES = 102400
# path label -> (batch, samples per buffer, shortest length, backend,
# launches expected per forward)
PATHS = {
    "main": (64, WAV_SAMPLES, WAV_SAMPLES // 2, "auto",
             dict(mha_layer_block=13, ffn_block=13, attention_vmem=0, flash_attention=0,
                  fused_conv_chain=0)),
    "long 17s": (16, 272000, 251200, "auto",
                 dict(mha_layer_block=0, ffn_block=0, attention_vmem=13, flash_attention=0,
                      fused_conv_chain=0)),
    "long 12s": (16, 192000, 144000, "auto",
                 dict(mha_layer_block=13, ffn_block=0, attention_vmem=0, flash_attention=0,
                      fused_conv_chain=0)),
    "flash backend": (64, WAV_SAMPLES, WAV_SAMPLES // 2, "pallas",
                      dict(mha_layer_block=0, ffn_block=0, attention_vmem=0, flash_attention=13,
                           fused_conv_chain=0)),
}
CASCADED_PATHS = {
    "cascaded auto": ("auto", dict(mha_layer_block=12, ffn_block=12, attention_vmem=0,
                                   flash_attention=0, fused_conv_chain=0)),
    "cascaded pallas": ("pallas", dict(mha_layer_block=0, ffn_block=0, attention_vmem=0,
                                       flash_attention=25, fused_conv_chain=0)),
}
MIN_KEYWORD_AGREEMENT = 0.9  # share of the B*K keyword ids (VQ argmax)
GALLERY_IMAGES = 256
RATE_WINDOW_S = 1.0  # rates: CUDA events around back-to-back calls over ~1 s
TEXT_BATCH = 256
VIT_L14_BATCH = 64
RN50_BATCH = 64
# phases 14 and 15: tower -> (batch, seed)
TOWERS = {"ViT-L/14": (VIT_L14_BATCH, 20), "RN50": (RN50_BATCH, 21)}
# Flickr8k's test split: 1000 images with 5 captions each
EVAL_IMAGES, EVAL_CAPTIONS, EVAL_BATCH = 1000, 5, 250
EVAL_RECALL_AT = (1, 5, 10)
GALLERY = 5000
TOPK = 10
# Phase 2's backward rows: each kernel with a gradient (the JAX custom_vjp's
# counterpart) at one shape of the train path, label -> spec; the attention
# specs as ATTENTION_SHAPES', with a dtype
BACKWARD_LAYER_SHAPES = {"hubert": dict(HUBERT_SHAPE, mode="post"),
                         "hubert-large": LARGE_LAYER_SHAPES["hubert-large"]}
BACKWARD_ATTENTION_SHAPES = {
    "attention_vmem": {"hubert 17s": ((16, 12, 849, 64, True, False, True), "bfloat16")},
    "flash_attention": {
        "cascaded 768": ((64, 1, 327, 768, True, False, True), "bfloat16"),
        "text tower K+2": ((64, 8, 10, 64, False, True, True), "bfloat16"),
        "text tower K+2 f32": ((64, 8, 10, 64, False, True, True), "float32"),
        # the trainable towers (phase 22): ViT-B/32's layer, the text
        # tower's f32 causal layer as forward_text runs it
        "vit-b/32": ((256, 12, 50, 64, False, False, True), "bfloat16"),
        "text tower f32": ((256, 8, 77, 64, False, True, True), "float32"),
    },
}
# The large models (phases 19-21): bench_variant_config("large_par") and
# ("large_casc") at full width, seeded random weights. Path label ->
# (batch, samples per buffer, shortest length, backend, launches expected per
# forward: HuBERT-large's 24 layers and the parallel branch's 1 on
# mha_layer_block, no ffn_block: ffn_eligible fails at D = 1024, F = 4096)
LARGE_PATHS = {
    "large main": (64, WAV_SAMPLES, WAV_SAMPLES // 2, "auto",
                   dict(mha_layer_block=25, ffn_block=0, attention_vmem=0, flash_attention=0,
                        fused_conv_chain=0)),
}
# the large cascaded branch (K = 8, one 1024-wide head, the 49408-row
# vocabulary, ViT-L/14's 768-wide text tower): "auto" runs HuBERT-large's 24
# layers on mha_layer_block (the head and the 10-token text layers take
# sdpa_plain); "pallas" 24 + the head + 12 text layers on flash_attention
LARGE_CASCADED_PATHS = {
    "large cascaded auto": ("auto", dict(mha_layer_block=24, ffn_block=0, attention_vmem=0,
                                         flash_attention=0, fused_conv_chain=0)),
    "large cascaded pallas": ("pallas", dict(mha_layer_block=0, ffn_block=0, attention_vmem=0,
                                             flash_attention=37, fused_conv_chain=0)),
}
LARGE_THROUGHPUT_BATCH = 256  # bench.py's hubert_large_utt_per_sec batch
# phase 20: the large train step at bench.py's train_step_ms_large_par_b128
# batch and the shipped configs' 256, wsum_remat off and on
LARGE_TRAIN_BATCHES = (128, 256)
# phase 20: wsum_remat on against off at B = 128. The two differ only in
# the recompute's f32 weights (the stacked s3prl sum rounds them to bf16):
# measured on the H100 1e-6 apart in loss (relative), 3.5e-5 in 1 - the
# logits' gradient cosine and 1.4e-4 in grad_norm (relative); the limits
# sit 100x, 3x and 7x above. The logits' gradient without its centring
# term <w, dots> gives a cosine of 0.754 and fails
# (scripts/torch_wsum_fault_probe.py).
WSUM_LOSS_RTOL = 1e-4
WSUM_MIN_GRAD_COSINE = 0.9999
WSUM_GRAD_NORM_RTOL = 1e-3

# The training phase (flagship_config(): both branches, frozen towers):
# bench.py's train batch (6.4 s, lengths U[3.2 s, 6.4 s], 224 x 224 f32
# images, ids arange(B) % (B // 5))
TRAIN_BATCH = 256
TRAIN_PALLAS_BATCH = 64
TRAIN_LOSS_RTOL = 1e-2
TRAIN_MIN_GRAD_COSINE = 0.99
TRAIN_GRAD_NORM_RTOL = 0.02
TRAIN_BN_RTOL = 1e-3  # of the statistic's largest magnitude
# phase 16: the kernel branch's worst keyword row before VQ, against the
# f32 branch, may fall this far (in cosine) below the plain bf16 branch's
TRAIN_PRE_VQ_SLACK = 1e-3
TRAIN_TIMED_STEPS = 10  # phase 17: steps timed a path, after
TRAIN_WARMUP_STEPS = 2  # warm-up steps
# leaves whose gradient norm is under this share of the largest leaf's carry
# rounding alone (the biases kw-BN cancels): not held to a cosine
TRAIN_LIVE_GRAD = 1e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3, calls: int = 1) -> float:
    """Median per-call time from CUDA events around ``calls`` back-to-back
    calls (one: the call's host launch path included; more: hidden behind
    the device where its work per call takes longer)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    times.sort()
    return times[len(times) // 2]


# The port's kernels as the profiler names them (the attention kernels all
# take scl::AttnArgs); any other kernel in a device-time pass is the
# library's or plain torch's.
PORT_KERNELS = re.compile(
    r"scl::AttnArgs|\b(rowwise_kernel|flash_kernel|flash_f32_kernel|wide_scores_kernel|wide_pv_kernel|"
    r"gemm_bf16_kernel|layer_norm_kernel|conv_layer_kernel|pos_conv_kernel)\b")


def _device_pass(fn, reps: int, ours_only: bool):
    """(device ms per call, {port kernel: ms per call}) of ``reps`` calls of
    ``fn`` under one torch.profiler pass: the self device time of every
    kernel launched (``ours_only``: the port's kernels only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, parts = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1000.0 / reps
        if PORT_KERNELS.search(e.key):
            name = re.search(r"(\w+(?:<[^()]*?>)?)\(", e.key + "(").group(1)
            parts[name] = parts.get(name, 0.0) + ms
        elif ours_only:
            continue
        total += ms
    return total, parts


def device_ms(kern, library=None, reps: int = 20):
    """(kernel, library, {port kernel: ms}) device ms per call, each from
    its own torch.profiler pass over ``reps`` calls after one warm-up call
    (the kernel's: the port's kernels only, also given one by one). A pass
    that records no device time is run again, up to twice; None where none
    showed."""
    import torch

    out = []
    for fn, ours_only in ((kern, True), (library, False)):
        total, parts = 0.0, {}
        if fn is not None:
            fn()
            torch.cuda.synchronize()
            for _attempt in range(3):
                total, parts = _device_pass(fn, reps, ours_only)
                if total:
                    break
        out.append((total or None, parts))
    return out[0][0], out[1][0], out[0][1]


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def row_cosine_min(a, b) -> float:
    import torch

    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    return float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS):
    """(least ms the card could take, "operations" or "bytes"): bf16
    tensor-core operations unless another peak is given."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_keys(b, l, s, lens, causal) -> int:
    """Query-key pairs the masks leave: sum over batches and rows of the
    valid keys (the kernels skip the rest)."""
    import torch

    lens = torch.full((b,), s) if lens is None else lens.long().cpu()
    row = torch.arange(l)[None, :]
    keys = lens[:, None].clamp(max=s).expand(b, l)
    if causal:
        keys = torch.minimum(keys, row + 1)
    return int(keys.sum())


def layer_work(shape, lens):
    """(FLOPs, bytes) of ``mha_layer_block`` and of ``ffn_block`` at a
    layer row: inputs read once, outputs written once."""
    b, t, d, f = shape["b"], shape["t"], shape["d"], shape["f"]
    m = b * t
    mha = (2 * m * d * 4 * d + 4 * d * t * int(lens.long().sum()),
           2 * m * d * 2 + 4 * d * d * 2 + 6 * d * 4 + b * 4)
    ffn = (4 * m * d * f, 2 * m * d * 2 + 2 * d * f * 2 + (f + 3 * d) * 4)
    return mha, ffn


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


def _check_row(name, label, got, want, ms, plain_ms, results, work=None, library_ms=None,
               library_name="torch SDPA"):
    """Layer outputs (|y| ~ 4-8 after LayerNorm) are held to BF16_ATOL and
    MIN_COSINE; attention outputs, means of v far smaller than that, also
    to limits tied to their own scale (``attention_agrees``)."""
    import torch

    from speechclip_tpu_torch.kernels import _attention_common as ac

    err = float((got.float() - want.float()).abs().max())
    cos = row_cosine_min(got, want)
    ok = bool(torch.isfinite(got).all()) and err <= BF16_ATOL and cos >= MIN_COSINE
    scaled = ""
    if name in ("attention_vmem", "flash_attention"):
        st = ac.attention_agreement(got, want)
        ok = ok and ac.attention_agrees(st)
        scaled = (
            f", f32: max abs {st['max_abs_err']:.3e} (tol {ac.F32_MAX_ABS}), min row cosine "
            f"{st['min_cosine']:.7f} (tol {ac.MIN_ATTN_COSINE})" if st["f32"] else
            f", worst row {st['row_ulps']:.4f} x 2^-7 max|row| (tol {ac.MAX_ROW_ULPS}), "
            f"min row cosine {st['min_cosine']:.7f} (tol {ac.MIN_ATTN_COSINE}), "
            f"elements differing {st['mismatch']:.6f} (tol {ac.MAX_MISMATCH})"
        )
    bound_ms, bound_by = bound(*work)
    lib = "" if library_ms is None else f", {library_name} {library_ms:.4f} ms"
    say(
        f"phase 2 {name} [{label}]: max_abs_err {err:.6f} (tol {BF16_ATOL}), "
        f"min row cosine {cos:.6f} (tol {MIN_COSINE}){scaled}, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms{lib}, bound {bound_ms:.4f} ms ({bound_by}; "
        f"{work[0] / 1e9:.3f} GFLOP, {work[1] / 1e6:.3f} MB), {100 * bound_ms / ms:.1f} % of bound"
    )
    if not ok:
        fail(f"{name} [{label}] disagrees with its plain version")
    results.setdefault(name, {})[label] = dict(
        err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, device_ms=None, library_device_ms=None,
        library_name=library_name)


def _compare(name, label, kern, plain, results, work, library=None, deferred=None,
             library_name="torch SDPA"):
    """One phase-2 row: the kernel's output against its plain version's on
    the same inputs, then both timed (and the library call, if any). The
    row goes on ``deferred`` for its device times. These launches count for
    no path."""
    import torch

    got = kern()
    torch.cuda.synchronize()
    want = plain()
    _check_row(name, label, got, want, cuda_time_ms(kern), cuda_time_ms(plain), results,
               work, None if library is None else cuda_time_ms(library), library_name)
    deferred.append((name, label, kern, library))


def _device_rows(deferred, results):
    """Each row's kernel (and library call's) device time per call, taken
    after every event timing of phase 2: once torch.profiler has run, the
    host's launch path stays slower in that process, which single-call
    event times would absorb."""
    for name, label, kern, library in deferred:
        row = results[name][label]
        row["device_ms"], row["library_device_ms"], parts = device_ms(kern, library)
        lib = row["library_name"]
        extra = "" if library is None else (
            f", {lib} {_ms(row['library_device_ms'])}; event times kernel {row['ms']:.4f} ms, "
            f"{lib} {row['library_ms']:.4f} ms")
        flops = row.get("flops")
        if flops and row["device_ms"]:
            extra += (f"; {flops / row['device_ms'] / 1e9:.1f} TFLOP/s on the device, "
                      f"{100 * row['bound_ms'] / row['device_ms']:.1f} % of bound")
            if row["library_device_ms"]:
                extra += f" ({lib}: {flops / row['library_device_ms'] / 1e9:.1f} TFLOP/s)"
        if name in ("mha_layer_block", "ffn_block"):
            extra += " (" + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + ")"
        say(f"phase 2 {name} [{label}]: device time per call (torch.profiler, 20 calls "
            f"each): kernel {_ms(row['device_ms'])}{extra}")


def _attention_inputs(b, h, l, dh, with_lens, packed, gen, dtype=None):
    import torch

    bf = dtype or torch.bfloat16
    if packed:
        qkv = torch.randn(b, l, 3, h, dh, generator=gen, device="cuda").to(bf)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q, k, v = (torch.randn(b, h, l, dh, generator=gen, device="cuda").to(bf)
                   for _ in range(3))
    lens = None
    if with_lens:
        lens = torch.randint(l // 2, l + 1, (b,), generator=gen, device="cuda").to(torch.int32)
    return q, k, v, lens


def phase_kernels():
    import torch

    from speechclip_tpu_torch.kernels.ffn_block import ffn_block, ffn_block_plain
    from speechclip_tpu_torch.kernels.mha_block import (
        mha_layer_block,
        mha_layer_block_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    results, deferred = {}, []
    # the GEMM rows draw from a generator of their own, so every other row
    # sees the inputs it saw before they were added
    _gemm_rows(torch.Generator(device="cuda").manual_seed(14), results, deferred)
    layer_shapes = [("hubert", HUBERT_SHAPE, True), ("branch", BRANCH_SHAPE, True)]
    layer_shapes += [(label, shape, False) for label, shape in REPAIR_SHAPES.items()]
    for label, shape, with_ffn in layer_shapes:
        x, lens, m, f = _layer_inputs(shape, gen)
        h = shape["heads"]
        mha_args = (x, m["w_in"], m["b_in"], m["w_out"], m["b_out"], m["ln_g"], m["ln_b"],
                    lens, h, "post", 1e-5)
        ffn_args = (x, f["w1"], f["b1"], f["w2"], f["b2"], f["ln_g"], f["ln_b"], "post", 1e-5)
        row = f"{label} B={shape['b']} T={shape['t']} H={h} Dh={shape['d'] // h} post"
        mha_work, ffn_work = layer_work(shape, lens)
        _compare("mha_layer_block", row, functools.partial(mha_layer_block, *mha_args),
                 functools.partial(mha_layer_block_plain, *mha_args), results, mha_work,
                 deferred=deferred)
        if with_ffn:
            _compare("ffn_block", row, functools.partial(ffn_block, *ffn_args),
                     functools.partial(ffn_block_plain, *ffn_args), results, ffn_work,
                     deferred=deferred)
    for name, shapes in ATTENTION_SHAPES.items():
        for label, spec in shapes.items():
            _attention_row(name, label, spec, gen, results, deferred)
    conv_layers = _conv_row(gen, results, deferred)
    # the gallery's rows, from a generator of their own (as the GEMM rows)
    gallery_gen = torch.Generator(device="cuda").manual_seed(16)
    for label, spec in GALLERY_FLASH_SHAPES.items():
        _attention_row("flash_attention", label, spec, gallery_gen, results, deferred)
    _vit_l14_block_row(gallery_gen, results, deferred)
    _attention_row("flash_attention", "clip text f32", TEXT_F32_FLASH_SHAPE, gallery_gen, results,
                   deferred, torch.float32)
    # the large models' rows, from a generator of their own
    _large_rows(torch.Generator(device="cuda").manual_seed(24), results, deferred)
    # pos_conv's rows, from a generator of their own
    _pos_conv_rows(torch.Generator(device="cuda").manual_seed(26), results, deferred)
    # the backward rows, from a generator of their own (as the gallery's)
    backward = _backward_rows(torch.Generator(device="cuda").manual_seed(18), results)
    _device_rows(deferred, results)
    _conv_layer_device_rows(conv_layers, results)
    _backward_device_rows(backward, results)
    return results


def _large_rows(gen, results, deferred):
    """Phase 2's rows of the large models: ``mha_layer_block`` on
    HuBERT-large's pre-norm layer and on the large branch's post-norm layer
    (LARGE_LAYER_SHAPES; their FFN fails ``ffn_eligible`` and runs in torch),
    and ``flash_attention`` on the large cascaded head in bf16 and in f32
    (LARGE_FLASH_SHAPE)."""
    import torch

    from speechclip_tpu_torch.kernels.ffn_block import ffn_eligible
    from speechclip_tpu_torch.kernels.mha_block import mha_layer_block, mha_layer_block_plain

    for label, shape in LARGE_LAYER_SHAPES.items():
        if ffn_eligible(shape["b"], shape["t"], shape["d"], shape["f"], 2):
            fail(f"{label}: ffn_eligible admits D = {shape['d']}, F = {shape['f']}")
        x, lens, m, _ = _layer_inputs(shape, gen)
        h, mode = shape["heads"], shape["mode"]
        args = (x, m["w_in"], m["b_in"], m["w_out"], m["b_out"], m["ln_g"], m["ln_b"], lens, h,
                mode, 1e-5)
        row = f"{label} B={shape['b']} T={shape['t']} H={h} Dh={shape['d'] // h} {mode}"
        _compare("mha_layer_block", row, functools.partial(mha_layer_block, *args),
                 functools.partial(mha_layer_block_plain, *args), results,
                 layer_work(shape, lens)[0], deferred=deferred)
    for dtype in (torch.bfloat16, torch.float32):
        _attention_row("flash_attention", "large cascaded 1024", LARGE_FLASH_SHAPE, gen, results,
                       deferred, dtype)


# pos_conv's rows: the encode cell's and the large train cell's 6.4 s batch,
# and a served 17 s batch of 32 (label -> B, T, D)
POS_CONV_SHAPES = {"hubert-base": (256, 319, 768), "hubert-large": (256, 319, 1024),
                   "hubert-base 17 s": (32, 849, 768)}


def _pos_conv_rows(gen, results, deferred):
    """Phase 2's rows of ``pos_conv`` (POS_CONV_SHAPES): the op on the card
    against its plain version (cuDNN's grouped conv, then the bias, GELU and
    residual passes), held to ``pos_conv_agrees`` and the layer limits;
    cuDNN's grouped conv alone (``F.conv1d`` in bf16) as the library call,
    timed only. x ~ N(0, 1); w with a std of 0.02 (HuBERT's init)."""
    import torch
    import torch.nn.functional as F

    from speechclip_tpu_torch.kernels import pos_conv as pc

    for label, (b, t, d) in POS_CONV_SHAPES.items():
        c = d // pc.GROUPS
        x = torch.randn(b, t, d, generator=gen, device="cuda").bfloat16()
        w = (0.02 * torch.randn(d, c, pc.KERNEL_SIZE, generator=gen, device="cuda")).bfloat16()
        bias = 0.1 * torch.randn(d, generator=gen, device="cuda")
        got = pc.pos_conv(x, w, bias)
        torch.cuda.synchronize()
        st = pc.pos_conv_agreement(got, pc.pos_conv_plain(x, w, bias), x)
        row = f"{label} B={b} T={t} D={d} k={pc.KERNEL_SIZE} groups={pc.GROUPS}"
        say(f"phase 2 pos_conv [{row}]: largest difference {st['max_steps']:g} bf16 steps of "
            f"max(|x|, |term|, |out|, 1) (tol {pc.MAX_STEPS}), elements differing "
            f"{st['mismatch']:.6f} (tol {pc.MAX_MISMATCH}), tiles {pc.tile_plan(t)}")
        if not pc.pos_conv_agrees(st):
            fail(f"pos_conv [{row}] disagrees with its plain version: {st}")
        del got
        work = (2.0 * b * t * d * c * pc.KERNEL_SIZE,
                2 * (2 * b * t * d + w.numel() + d))
        _compare("pos_conv", row, functools.partial(pc.pos_conv, x, w, bias),
                 functools.partial(pc.pos_conv_plain, x, w, bias), results, work,
                 library=functools.partial(F.conv1d, x.transpose(1, 2), w,
                                           padding=pc.KERNEL_SIZE // 2, groups=pc.GROUPS),
                 deferred=deferred, library_name="cuDNN grouped conv1d")
        results["pos_conv"][row]["flops"] = work[0]


def _backward_row(name, label, kern, plain, args, diff, g, results, backward, library=None):
    """One phase-2 backward row: the gradients through the kernel's
    autograd.Function (kernel forward, recompute backward) against the plain
    version's own autograd gradients for the same upstream gradient ``g``:
    bitwise equal, since the backward IS the plain recompute. Then the
    backward's time (CUDA events) beside ``library`` (one SDPA forward +
    backward on the same inputs, where there is one)."""
    import torch

    leaves = [args[i] for i in diff]
    out = kern(*args)
    fn_name = type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    want = torch.autograd.grad(plain(*args), leaves, g)
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    bwd = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    ms = cuda_time_ms(bwd)
    lib_ms = None if library is None else cuda_time_ms(library)
    lib = "" if lib_ms is None else f", torch SDPA forward + backward {lib_ms:.4f} ms"
    say(f"phase 2 {name} backward [{label}]: through {fn_name}, gradients of "
        f"{len(leaves)} inputs bitwise equal to the plain version's autograd: {equal}, "
        f"finite {finite}; backward (the plain recompute) {ms:.4f} ms{lib}")
    if not (equal and finite and fn_name.endswith("FnBackward")):
        fail(f"{name} [{label}]: the backward is not the plain recompute's gradient")
    results.setdefault("backward", {}).setdefault(name, {})[label] = dict(
        ms=ms, library_ms=lib_ms, device_ms=None, library_device_ms=None)
    backward.append((name, label, bwd, library))


def _backward_rows(gen, results):
    """Phase 2's backward rows (BACKWARD_LAYER_SHAPES, BACKWARD_ATTENTION_SHAPES); the
    layer rows beside SDPA forward + backward on their attention core alone."""
    import torch
    import torch.nn.functional as F

    from speechclip_tpu_torch.kernels import attention_vmem as av
    from speechclip_tpu_torch.kernels import ffn_block as fb
    from speechclip_tpu_torch.kernels import flash_attention as fa
    from speechclip_tpu_torch.kernels import mha_block as mb
    from speechclip_tpu_torch.kernels._attention_common import key_mask

    backward = []
    req = lambda t: t.detach().clone().requires_grad_(True)
    for name, shape in BACKWARD_LAYER_SHAPES.items():
        x, lens, m, f = _layer_inputs(shape, gen)
        h, mode = shape["heads"], shape["mode"]
        row = f"{name} B={shape['b']} T={shape['t']} H={h} Dh={shape['d'] // h} {mode}"
        g = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
        mha_args = [req(x)] + [req(m[k])
                               for k in ("w_in", "b_in", "w_out", "b_out", "ln_g", "ln_b")]
        # beside it, SDPA forward + backward on the layer's attention core alone
        q, k, v, _ = _attention_inputs(shape["b"], h, shape["t"], shape["d"] // h, False, True,
                                       gen)
        q, k, v = (req(t) for t in (q, k, v))
        mask = key_mask(lens, False, shape["t"], shape["t"], q.device)
        core = (lambda q=q, k=k, v=v, mask=mask: torch.autograd.grad(
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask), (q, k, v), q))
        _backward_row("mha_layer_block", row, mb.mha_layer_block, mb.mha_layer_block_plain,
                      mha_args + [lens, h, mode, 1e-5], range(7), g, results, backward, core)
        if name == "hubert":  # the large layer's FFN fails ffn_eligible: torch's FFN
            ffn_args = [req(x)] + [req(f[k]) for k in ("w1", "b1", "w2", "b2", "ln_g", "ln_b")]
            _backward_row("ffn_block", row, fb.ffn_block, fb.ffn_block_plain,
                          ffn_args + [mode, 1e-5], range(7), g, results, backward)
    kernels = {"attention_vmem": (av.attention_vmem, av.attention_vmem_plain),
               "flash_attention": (fa.flash_attention, fa.flash_attention_plain)}
    for name, shapes in BACKWARD_ATTENTION_SHAPES.items():
        kern, plain = kernels[name]
        for label, (spec, dtype) in shapes.items():
            b, h, l, dh, with_lens, causal, packed = spec
            q, k, v, lens = _attention_inputs(b, h, l, dh, with_lens, packed, gen,
                                              getattr(torch, dtype))
            q, k, v = (req(t) for t in (q, k, v))
            g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
            mask = None if lens is None else key_mask(lens, causal, l, l, q.device)
            sdpa = (lambda q=q, k=k, v=v, g=g, mask=mask, causal=causal: torch.autograd.grad(
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               is_causal=causal and mask is None), (q, k, v), g))
            row = (f"{label} B={b} H={h} L=S={l} Dh={dh} lens={'yes' if with_lens else 'no'} "
                   f"causal={'yes' if causal else 'no'} {dtype}")
            _backward_row(name, row, kern, plain, [q, k, v, lens, causal], range(3), g,
                          results, backward, sdpa)
    return backward


def _backward_device_rows(backward, results):
    """Each backward row's device time per call (torch.profiler, 20 calls,
    every kernel counted: the recompute is plain torch), and SDPA's."""
    for name, label, bwd, library in backward:
        row = results["backward"][name][label]
        for key, fn in (("device_ms", bwd), ("library_device_ms", library)):
            if fn is not None:
                fn()
                row[key] = _device_pass(fn, 20, ours_only=False)[0] or None
        lib = "" if library is None else f", torch SDPA forward + backward {_ms(row['library_device_ms'])}"
        say(f"phase 2 {name} backward [{label}]: device time per call (torch.profiler, 20 "
            f"calls): the plain recompute {_ms(row['device_ms'])}{lib}")


def _attention_row(name, label, spec, gen, results, deferred, dtype=None):
    """One phase-2 row of ``attention_vmem`` or ``flash_attention`` at
    ``spec`` = (b, h, l, dh, lens, causal, packed), bf16 unless ``dtype``
    says otherwise, beside torch SDPA. An f32 row's bound takes the f32
    CUDA-core peak: the f32 form runs no tensor core."""
    import torch

    from speechclip_tpu_torch.kernels import attention_vmem as av
    from speechclip_tpu_torch.kernels import flash_attention as fa

    kern, plain = {"attention_vmem": (av.attention_vmem, av.attention_vmem_plain),
                   "flash_attention": (fa.flash_attention, fa.flash_attention_plain)}[name]
    b, h, l, dh, with_lens, causal, packed = spec
    q, k, v, lens = _attention_inputs(b, h, l, dh, with_lens, packed, gen, dtype)
    f32 = q.dtype == torch.float32
    row = (f"{label} B={b} H={h} L=S={l} Dh={dh} lens={'yes' if with_lens else 'no'} "
           f"causal={'yes' if causal else 'no'}" + (" f32" if f32 else ""))
    work = (4 * h * dh * attention_keys(b, l, l, lens, causal),
            4 * b * h * l * dh * q.element_size() + (0 if lens is None else 4 * b),
            PEAK_F32_FLOPS if f32 else PEAK_FLOPS)
    _compare(name, row, functools.partial(kern, q, k, v, lens, causal),
             functools.partial(plain, q, k, v, lens, causal), results, work,
             library=_sdpa_call(q, k, v, lens, causal), deferred=deferred)


def _vit_l14_block_row(gen, results, deferred):
    """The phase-2 row of ``mha_layer_block`` on ViT-L/14's layer under
    "auto" (ln_mode "none", no key lengths), beside one
    ``F.multi_head_attention_forward`` call on the same weights (the
    function "none" computes; timed only, the port never calls it)."""
    import torch.nn.functional as F

    from speechclip_tpu_torch.kernels.mha_block import mha_layer_block, mha_layer_block_plain

    shape = VIT_L14_SHAPE
    x, _, m, _ = _layer_inputs(shape, gen)
    b, t, d, h = shape["b"], shape["t"], shape["d"], shape["heads"]
    args = (x, m["w_in"], m["b_in"], m["w_out"], m["b_out"], None, None, None, h, "none", 1e-5)
    work = (2 * b * t * d * 4 * d + 4 * d * t * b * t,
            2 * b * t * d * 2 + 4 * d * d * 2 + 4 * d * 4)
    xt = x.transpose(0, 1)  # (T, B, D), the functional form's layout
    w_in, w_out = m["w_in"].t().contiguous(), m["w_out"].t().contiguous()
    b_in, b_out = m["b_in"].bfloat16(), m["b_out"].bfloat16()

    def library():
        return F.multi_head_attention_forward(
            xt, xt, xt, d, h, w_in, b_in, None, None, False, 0.0, w_out, b_out,
            training=False, need_weights=False)

    _compare("mha_layer_block", f"vit-l/14 B={b} T={t} H={h} Dh={d // h} none",
             functools.partial(mha_layer_block, *args),
             functools.partial(mha_layer_block_plain, *args), results, work, library=library,
             deferred=deferred, library_name="F.multi_head_attention_forward")


def _gemm_operands(gen, m, n, k, epilogue):
    """bf16 operands at unit output scale (weights ~ K^-0.5), f32 bias, and
    the bf16 residual where the epilogue takes one."""
    import torch

    from speechclip_tpu_torch.kernels import mha_block as mb

    a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(k, n, generator=gen, device="cuda") * k**-0.5).bfloat16()
    bias = 0.1 * torch.randn(n, generator=gen, device="cuda")
    resid = None
    if epilogue in (mb.EPI_BIAS_RESID_F32, mb.EPI_BIAS_RESID):
        resid = torch.randn(m, n, generator=gen, device="cuda").bfloat16()
    return a, w, bias, resid


def _gemm_reference(a, w, bias, epilogue, resid):
    """The f32 product plus the epilogue, with the kernel's rounding points."""
    from speechclip_tpu_torch.kernels import mha_block as mb
    from speechclip_tpu_torch.ops.basic import gelu

    y = a.float() @ w.float() + bias
    if epilogue == mb.EPI_BIAS_GELU:
        return gelu(y.bfloat16())
    if resid is not None:
        y = y + resid.float()
    return y if epilogue == mb.EPI_BIAS_RESID_F32 else y.bfloat16()


def _gemm_agreement(got, want):
    """(max abs error, worst excess over the tolerance, ok) of a GEMM output:
    bf16 outputs within 2^-5 + 2^-7 |y| (one rounding flip of a GELU input
    at |x| ~ 4), f32 outputs within 1e-3 + 1e-3 |y| (summation order)."""
    import torch

    rtol, atol = (1e-3, 1e-3) if want.dtype == torch.float32 else (2**-7, 2**-5)
    diff = (got.float() - want.float()).abs()
    excess = float((diff - atol - rtol * want.float().abs()).max())
    return float(diff.max()), excess, bool(torch.isfinite(got).all()) and excess <= 0


def _gemm_rows(gen, results, deferred):
    """Phase-2 rows of the wgmma GEMM, one per product of the main path at
    M = 64 x 319 rows and one ragged shape: the kernel against the f32
    product plus epilogue (``_gemm_agreement``), its event time, TFLOP/s and
    bound 2MNK / 989 TFLOP/s,
    beside one ``torch.matmul`` on the same bf16 operands (timed only; the
    port never calls it)."""
    import torch

    from speechclip_tpu_torch.kernels import mha_block as mb

    for label, (m, n, k, epi) in GEMM_SHAPES.items():
        a, w, bias, resid = _gemm_operands(gen, m, n, k, epi)
        kern = functools.partial(mb.gemm, a, w, bias, epi, resid)
        got = kern()
        torch.cuda.synchronize()
        want = _gemm_reference(a, w, bias, epi, resid)
        err, excess, ok = _gemm_agreement(got, want)
        ms = cuda_time_ms(kern)
        library = functools.partial(torch.matmul, a, w)
        lib_ms = cuda_time_ms(library)
        flops = 2 * m * n * k
        out_bytes = m * n * (4 if want.dtype == torch.float32 else 2)
        nbytes = (m * k + k * n) * 2 + n * 4 + out_bytes + (0 if resid is None else m * n * 2)
        bound_ms, bound_by = bound(flops, nbytes)
        row = f"{label} M={m} N={n} K={k} epilogue {epi}"
        say(f"phase 2 gemm [{row}]: max_abs_err {err:.6f} (worst excess over the "
            f"tolerance {excess:.6f}), kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"torch.matmul {lib_ms:.4f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s), bound "
            f"{bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.3f} GFLOP), "
            f"{100 * bound_ms / ms:.1f} % of bound")
        if not ok:
            fail(f"gemm [{row}] disagrees with the f32 product")
        results.setdefault("gemm", {})[row] = dict(
            err=err, ms=ms, plain_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms, device_ms=None, library_device_ms=None,
            library_name="torch.matmul", flops=flops)
        deferred.append(("gemm", row, kern, library))


def _sdpa_call(q, k, v, lens, causal):
    """One ``F.scaled_dot_product_attention`` call computing the same
    function on the same inputs (the library yardstick; never in the port)."""
    import torch
    import torch.nn.functional as F

    from speechclip_tpu_torch.kernels._attention_common import key_mask

    if lens is None:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    mask = key_mask(lens, causal, q.shape[2], k.shape[2], q.device)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def _conv_inputs(gen):
    """conv0's output for 64 utterances of 6.4 s as the chain sees it (a
    GELU of unit-variance values, (B, T, C)) and conv1..6 weights (k, C, C)
    with the HuBERT init's scale."""
    import torch

    b, t, c = CONV_SHAPE["b"], CONV_SHAPE["t"], CONV_SHAPE["c"]
    x = torch.nn.functional.gelu(torch.randn(b, t, c, generator=gen, device="cuda")).bfloat16()
    ws = [(torch.randn(k, c, c, generator=gen, device="cuda") * (k * c) ** -0.5).bfloat16()
          for k in CONV_KERNELS]
    return x, ws


def _conv_layers(x, ws):
    """Each layer of the chain alone, fed the plain chain's input to it:
    (k, its input, its weight, (FLOPs, bytes)) per layer, and the plain
    chain's output."""
    from speechclip_tpu_torch.kernels import conv_frontend as cf

    layers, h = [], x
    for w, k in zip(ws, CONV_KERNELS):
        b, t, c = h.shape
        t_out = cf.layer_out_len(t, k)
        work = (2 * b * t_out * k * c * w.shape[2],
                (b * t * c + w.numel() + b * t_out * w.shape[2]) * 2)
        layers.append((k, h, w, work))
        h = cf.fused_conv_chain_plain(h, [w], (k,)).contiguous()
    return layers, h


def _conv_row(gen, results, deferred):
    """Phase-2 row of ``fused_conv_chain``: each layer alone, fed the plain
    chain's input to it, within MAX_LAYER_MISMATCH (its event time and
    bound beside), then the whole chain against its plain version at the
    layer limits. Returns the layers, whose device times come after every
    event timing (``_conv_layer_device_rows``)."""
    from speechclip_tpu_torch.kernels import conv_frontend as cf

    x, ws = _conv_inputs(gen)
    b, t, c = x.shape
    layers, plain_out = _conv_layers(x, ws)
    wants = [h for _, h, _, _ in layers[1:]] + [plain_out]
    worst = 0.0
    for i, ((k, h, w, work), want) in enumerate(zip(layers, wants), 1):
        st = cf.conv_chain_agreement(cf.fused_conv_chain(h, [w], (k,)), want)
        worst = max(worst, st["mismatch"])
        if not (st["finite"] and st["mismatch"] <= cf.MAX_LAYER_MISMATCH):
            fail(f"fused_conv_chain layer k={k} at T={h.shape[1]} disagrees with its plain "
                 f"version: {st}")
        ms = cuda_time_ms(functools.partial(cf.conv_layer, h, w, k))
        bound_ms, _ = bound(*work)
        t_out = cf.layer_out_len(h.shape[1], k)
        say(f"phase 2 fused_conv_chain layer {i} (k={k}, T {h.shape[1]} -> "
            f"{t_out}, tile {cf.CONV_TILES[cf.conv_tile(t_out, w.shape[2])]}): "
            f"elements differing {st['mismatch']:.6f} (tol {cf.MAX_LAYER_MISMATCH}), kernel "
            f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({work[0] / 1e9:.1f} GFLOP), "
            f"{100 * bound_ms / ms:.1f} % of bound")
    work = (sum(wk[0] for *_, wk in layers),
            b * t * c * 2 + sum(w.numel() for w in ws) * 2
            + b * cf.chain_out_len(t, CONV_KERNELS) * c * 2)
    say(f"phase 2 fused_conv_chain per layer: worst share of elements differing {worst:.6f} "
        f"(tol {cf.MAX_LAYER_MISMATCH})")
    _compare("fused_conv_chain", f"hubert conv1..6 B={b} T={t} C={c} k={CONV_KERNELS}",
             lambda: cf.fused_conv_chain(x, ws, CONV_KERNELS),
             lambda: cf.fused_conv_chain_plain(x, ws, CONV_KERNELS), results, work,
             deferred=deferred)
    return layers


def _conv_layer_device_rows(layers, results):
    """Each conv layer's device time per call (torch.profiler, 20 calls) and
    its share of the layer's bound; kept with the chain's phase-2 row."""
    from speechclip_tpu_torch.kernels import conv_frontend as cf

    row = next(r for label, r in results["fused_conv_chain"].items()
               if label.startswith("hubert conv1..6"))
    row["layers"] = []
    for i, (k, h, w, work) in enumerate(layers, 1):
        dev, _, _ = device_ms(functools.partial(cf.conv_layer, h, w, k))
        bound_ms, _ = bound(*work)
        row["layers"].append(dict(k=k, t_in=h.shape[1], device_ms=dev, bound_ms=bound_ms))
        share = "not measured" if dev is None else f"{100 * bound_ms / dev:.1f} % of bound"
        say(f"phase 2 fused_conv_chain layer {i} (k={k}, T {h.shape[1]}): device time per "
            f"call (torch.profiler, 20 calls) {_ms(dev)}, bound {bound_ms:.4f} ms, {share}")


def _model(cfg, batch_chunk: int = 64):
    """The model on the card, its conv frontend in chunks of ``batch_chunk``
    utterances, and its seeded random (params, state) cast to the compute
    dtype."""
    from speechclip_tpu_torch import SpeechCLIPModel
    from speechclip_tpu_torch.models.speechclip import cast_params

    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, conv_batch_chunk=batch_chunk)
    )
    model = SpeechCLIPModel(cfg)
    params, state = model.init(0)
    return model, cast_params(params, model.compute_dtype), cast_params(state, model.compute_dtype)


def _wavs(b: int, samples: int, shortest: int, gen):
    import torch

    wav_len = torch.randint(shortest, samples + 1, (b,), generator=gen, device="cuda")
    wav = torch.randn(b, samples, generator=gen, device="cuda") * 0.1
    pad = torch.arange(samples, device="cuda")[None, :] >= wav_len[:, None]
    return wav.masked_fill(pad, 0.0), wav_len


def _counters():
    from speechclip_tpu_torch.kernels.attention_vmem import attention_vmem
    from speechclip_tpu_torch.kernels.conv_frontend import fused_conv_chain
    from speechclip_tpu_torch.kernels.ffn_block import ffn_block
    from speechclip_tpu_torch.kernels.flash_attention import flash_attention
    from speechclip_tpu_torch.kernels.mha_block import mha_layer_block

    return {f.__name__: f for f in (mha_layer_block, ffn_block, attention_vmem, flash_attention,
                                    fused_conv_chain)}


def _reset(counters):
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "recomputes"):
            f.recomputes = 0


def _recomputes(counters):
    return {name: f.recomputes for name, f in counters.items() if hasattr(f, "recomputes")}


def phase_path(phase, label, model, params, gallery, seed, spec=None):
    """Drive one path (``spec``, else PATHS[label]) once through
    ``encode_speech`` + ``retrieve`` with every launch count set to 0 just
    before and read just after; check the features against the all-plain
    path on the same card."""
    import torch

    from speechclip_tpu_torch import retrieve
    from speechclip_tpu_torch.kernels.pos_conv import pos_conv
    from speechclip_tpu_torch.models.hubert import conv_output_length
    from speechclip_tpu_torch.ops.attention import attention_backend

    b, samples, shortest, backend, expect = spec or PATHS[label]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    wav, wav_len = _wavs(b, samples, shortest, gen)
    counters = _counters()
    with attention_backend(backend):
        _reset(counters)
        pos_conv_before = pos_conv.launches
        feats = model.encode_speech(params, {}, wav, wav_len)["parallel_audio_feat"]
        _, top = retrieve(feats, gallery, TOPK)
        torch.cuda.synchronize()
        launches = {name: f.launches for name, f in counters.items()}
        pos_conv_launches = pos_conv.launches - pos_conv_before
        plain_feats = model.encode_speech(params, {}, wav, wav_len, plain=True)["parallel_audio_feat"]
    _, plain_top = retrieve(plain_feats, gallery, TOPK)
    torch.cuda.synchronize()

    cos = row_cosine_min(feats, plain_feats)
    norms = feats.norm(dim=-1)
    top1, overlap = _top_agreement(top, plain_top)
    say(
        f"phase {phase} {label} path (backend {backend}): encode_speech B={b} x {samples} "
        f"samples (T={conv_output_length(model.audio_cfg, samples)}, lengths "
        f"{int(wav_len.min())}..{int(wav_len.max())}) -> {tuple(feats.shape)}, "
        f"launches {launches} (expect {expect}), pos_conv {pos_conv_launches} (expect 1), "
        f"min row cosine vs plain {cos:.6f} (tol {MIN_COSINE}), |feat| in "
        f"[{float(norms.min()):.6f}, {float(norms.max()):.6f}], retrieve top-{TOPK} of "
        f"{gallery.shape[0]}: "
        f"top-1 agreement {top1:.4f}, top-{TOPK} overlap {overlap:.4f}"
    )
    if tuple(feats.shape) != (b, model.config.clip_embed_dim):
        fail(f"{label}: feature shape {tuple(feats.shape)}")
    if not bool(torch.isfinite(feats).all()):
        fail(f"{label}: non-finite features")
    if launches != expect:
        fail(f"{label}: kernel launches {launches}, expected {expect}")
    if pos_conv_launches != 1:
        fail(f"{label}: pos_conv launched {pos_conv_launches} times in one forward, expected 1")
    if cos < MIN_COSINE:
        fail(f"{label}: kernel-path features disagree with the plain path (cosine {cos})")
    if tuple(top.shape) != (b, TOPK):
        fail(f"{label}: top-k shape {tuple(top.shape)}")
    return launches


def _top_agreement(top, plain_top):
    """(top-1 agreement, top-k overlap) of two (B, k) index tensors."""
    top1 = float((top[:, 0] == plain_top[:, 0]).float().mean())
    overlap = sum(
        len(set(a.tolist()) & set(c.tolist())) for a, c in zip(top, plain_top)
    ) / float(top.numel())
    return top1, overlap


RATE_NOTE = f"CUDA events around back-to-back calls over ~{RATE_WINDOW_S:g} s, after a warm-up"


def _rate(step, n: int) -> float:
    """``n`` items per second of ``step``: CUDA events around as many
    back-to-back calls as fill RATE_WINDOW_S (sized by one timed call, after
    one warm-up call); any host wait inside a call stays in the window."""
    import torch

    step()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    step()
    end.record()
    end.synchronize()
    calls = max(2, round(RATE_WINDOW_S * 1e3 / start.elapsed_time(end)))
    start.record()
    for _ in range(calls):
        step()
    end.record()
    end.synchronize()
    return n * calls / (start.elapsed_time(end) / 1e3)


def _utt_per_s(model, params, gallery, wav, wav_len, plain, state=None, key="parallel_audio_feat"):
    """Encode + retrieve rate (``_rate``)."""
    from speechclip_tpu_torch import retrieve

    def step():
        feats = model.encode_speech(params, state or {}, wav, wav_len, plain=plain)
        return retrieve(feats[key], gallery, TOPK)[1]

    return _rate(step, wav.shape[0])


def phase_throughput(model, params, gallery, smi):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for batch in (256, 128):
        try:
            wav, wav_len = _wavs(batch, WAV_SAMPLES, WAV_SAMPLES // 2, gen)
            for plain in (False, True):
                out["plain" if plain else "kernel"] = _utt_per_s(
                    model, params, gallery, wav, wav_len, plain)
            break
        except torch.cuda.OutOfMemoryError:
            say(f"phase 4: batch {batch} does not fit; halving")
            out = {}
            torch.cuda.empty_cache()
    if not out:
        fail("no throughput batch fits")
    say(
        f"phase 4 encode+retrieve throughput at B={batch} on {smi}: kernel path "
        f"{out['kernel']:.2f} utt/s, plain path {out['plain']:.2f} utt/s ({RATE_NOTE})"
    )
    return batch, out


def phase_path_throughput(label, model, params, gallery, smi):
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend

    b, samples, shortest, backend, _ = PATHS[label]
    gen = torch.Generator(device="cuda").manual_seed(4)
    wav, wav_len = _wavs(b, samples, shortest, gen)
    with attention_backend(backend):
        rates = {p: _utt_per_s(model, params, gallery, wav, wav_len, p == "plain")
                 for p in ("kernel", "plain")}
    say(
        f"phase 7 {label} path encode+retrieve throughput at B={b} x {samples} samples "
        f"(backend {backend}) on {smi}: kernel path {rates['kernel']:.2f} utt/s, plain "
        f"path {rates['plain']:.2f} utt/s ({RATE_NOTE})"
    )
    return rates


def phase_conv_ab(smi):
    """``fused_conv_chain`` against the port's own conv1..6 (cuDNN
    ``conv1d`` in bf16 + tanh GELU, as ``models/hubert.py`` runs them in
    NCW) on the same weights and input: CUDA-event medians, in turns
    (cuDNN, kernel, kernel, cuDNN). The chain is driven once first with the
    launch counts at 0; that is the kernel's path."""
    import torch

    from speechclip_tpu_torch.kernels import conv_frontend as cf
    from speechclip_tpu_torch.models.hubert import _conv1d
    from speechclip_tpu_torch.ops.basic import gelu

    gen = torch.Generator(device="cuda").manual_seed(10)
    x, ws = _conv_inputs(gen)
    x_ncw = x.transpose(1, 2).contiguous()
    w_oik = [w.permute(2, 1, 0).contiguous() for w in ws]

    def cudnn_chain():
        h = x_ncw
        for w in w_oik:
            h = gelu(_conv1d(h, w, stride=2))
        return h

    def kernel_chain():
        return cf.fused_conv_chain(x, ws, CONV_KERNELS)

    counters = _counters()
    _reset(counters)
    out = kernel_chain()
    torch.cuda.synchronize()
    launches = {name: f.launches for name, f in counters.items()}
    ref = cudnn_chain().transpose(1, 2)
    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        fail(f"conv A/B: kernel output {tuple(out.shape)} vs cuDNN {tuple(ref.shape)}")
    times = {"cudnn": [], "kernel": []}
    for name in ("cudnn", "kernel", "kernel", "cudnn"):
        times[name].append(cuda_time_ms(cudnn_chain if name == "cudnn" else kernel_chain))
    say(f"phase 8 conv A/B B={x.shape[0]} T={x.shape[1]} C={x.shape[2]} k={CONV_KERNELS} on {smi}: "
        f"fused_conv_chain {times['kernel']} ms, cuDNN conv1..6 chain {times['cudnn']} ms "
        f"(CUDA-event medians of 20, in turns), launches {launches}, "
        f"cosine of the two outputs {row_cosine_min(out, ref):.6f} (times only: erf GELU on "
        f"f32 sums vs tanh GELU on bf16 convs)")
    if launches["fused_conv_chain"] != 1 or sum(launches.values()) != 1:
        fail(f"conv A/B: launches {launches}")
    return launches


def _cascaded_pre_vq(model, params, state, wav, wav_len, plain):
    """The keywords' cosine scores against the token table before VQ."""
    from speechclip_tpu_torch.models import branches

    audio_feat, audio_len = model.forward_audio(params, wav, wav_len, plain=plain)
    kw = branches.project_keywords_for_visualization(
        params["cascaded_branch"], state["cascaded_branch"], model.config.cascaded_branch,
        audio_feat, audio_len, plain)
    return branches.cosine_scores(kw, params["clip"]["text"]["token_embedding"])


def phase_cascaded(label, model, params, state, gallery, seed, spec=None, phase=9):
    """Drive the cascaded branch once through ``encode_speech`` + ``retrieve``
    (``spec``: (backend, launches), else CASCADED_PATHS[label]) with the
    launch counts at 0 just before and read just after; hold it to the
    all-plain path on the card."""
    import torch

    from speechclip_tpu_torch import retrieve
    from speechclip_tpu_torch.ops.attention import attention_backend

    backend, expect = spec or CASCADED_PATHS[label]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    wav, wav_len = _wavs(64, WAV_SAMPLES, WAV_SAMPLES // 2, gen)
    counters = _counters()
    with attention_backend(backend):
        _reset(counters)
        out = model.encode_speech(params, state, wav, wav_len)
        _, top = retrieve(out["cascaded_audio_feat"], gallery, TOPK)
        torch.cuda.synchronize()
        launches = {name: f.launches for name, f in counters.items()}
        ref = model.encode_speech(params, state, wav, wav_len, plain=True)
        scores = _cascaded_pre_vq(model, params, state, wav, wav_len, False)
        plain_scores = _cascaded_pre_vq(model, params, state, wav, wav_len, True)
    _, plain_top = retrieve(ref["cascaded_audio_feat"], gallery, TOPK)
    torch.cuda.synchronize()
    feats, plain_feats = out["cascaded_audio_feat"], ref["cascaded_audio_feat"]
    ids, plain_ids = out["vq_results"]["targets"][..., 0], ref["vq_results"]["targets"][..., 0]
    id_share = float((ids == plain_ids).float().mean())
    rows = (ids == plain_ids).all(dim=1)
    score_cos = row_cosine_min(scores, plain_scores)
    feat_cos = row_cosine_min(feats[rows], plain_feats[rows]) if bool(rows.any()) else 1.0
    top1, overlap = _top_agreement(top, plain_top)
    b, k = ids.shape
    say(f"phase {phase} {label} path (backend {backend}): encode_speech B={b} x {WAV_SAMPLES} samples, "
        f"K={k}, vocabulary {scores.shape[-1]} -> {tuple(feats.shape)}, launches {launches} "
        f"(expect {expect}); vs plain: pre-VQ scores min row cosine {score_cos:.6f} "
        f"(tol {MIN_COSINE}), keyword ids agreeing {id_share:.4f} of {b * k} (tol "
        f"{MIN_KEYWORD_AGREEMENT}), rows with all {k} ids agreeing {int(rows.sum())}/{b}, their "
        f"feature min cosine {feat_cos:.6f} (tol {MIN_COSINE}); retrieve top-{TOPK} of "
        f"{gallery.shape[0]}: top-1 agreement {top1:.4f}, top-{TOPK} overlap {overlap:.4f}; "
        f"code perplexity {float(out['vq_results']['code_perplexity']):.3f}")
    if tuple(feats.shape) != (b, gallery.shape[1]) or not bool(torch.isfinite(feats).all()):
        fail(f"{label}: features {tuple(feats.shape)}, finite {bool(torch.isfinite(feats).all())}")
    if launches != expect:
        fail(f"{label}: kernel launches {launches}, expected {expect}")
    if score_cos < MIN_COSINE or feat_cos < MIN_COSINE or id_share < MIN_KEYWORD_AGREEMENT:
        fail(f"{label}: the kernel path disagrees with the plain path")
    if tuple(top.shape) != (b, TOPK):
        fail(f"{label}: top-k shape {tuple(top.shape)}")
    return launches


def phase_cascaded_throughput(model, params, state, gallery, smi):
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend

    gen = torch.Generator(device="cuda").manual_seed(11)
    for batch in (256, 128):
        try:
            wav, wav_len = _wavs(batch, WAV_SAMPLES, WAV_SAMPLES // 2, gen)
            rates = {}
            for label, (backend, _) in CASCADED_PATHS.items():
                with attention_backend(backend):
                    for p in ("kernel", "plain"):
                        rates[label, p] = _utt_per_s(model, params, gallery, wav, wav_len,
                                                     p == "plain", state, "cascaded_audio_feat")
            break
        except torch.cuda.OutOfMemoryError:
            say(f"phase 10: batch {batch} does not fit; halving")
            torch.cuda.empty_cache()
    else:
        fail("no cascaded throughput batch fits")
    for label in CASCADED_PATHS:
        say(f"phase 10 {label} encode+retrieve throughput at B={batch} on {smi}: kernel path "
            f"{rates[label, 'kernel']:.2f} utt/s, plain path {rates[label, 'plain']:.2f} utt/s "
            f"({RATE_NOTE})")
    return rates


def _profile_step(label, step, n: int, smi):
    """The wall time of ``step`` (``_rate``), then
    one ``step`` under torch.profiler: the device time of its kernels, the
    largest of them, and its peak memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    wall_ms = 1000.0 * n / _rate(step, n)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    dev = sorted(
        ((e.key, e.self_device_time_total / 1000.0, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    total = sum(ms for _, ms, _ in dev)
    top = "; ".join(f"{name[:70]} {ms:.3f} ms x{k} ({100 * ms / total:.1f} %)"
                    for name, ms, k in dev[:12])
    say(f"profile {label} on {smi}: wall {wall_ms:.3f} ms, device {total:.3f} ms, "
        f"peak {peak:.2f} GiB; top: {top}")


def phase_profile(model, params, gallery, smi, cascaded):
    """Where the time goes: one encode + retrieve step per path
    (``_profile_step``). The main and cascaded paths run at the throughput
    batch of phases 4 and 10. ``cascaded``: (model, params, state) of the
    cascaded branch."""
    import torch

    from speechclip_tpu_torch import retrieve
    from speechclip_tpu_torch.ops.attention import attention_backend

    runs = [(label, b, samples, shortest, backend, model, params, {}, "parallel_audio_feat")
            for label, (b, samples, shortest, backend, _) in PATHS.items()]
    runs += [(label, 256, WAV_SAMPLES, WAV_SAMPLES // 2, backend, *cascaded, "cascaded_audio_feat")
             for label, (backend, _) in CASCADED_PATHS.items()]
    for label, b, samples, shortest, backend, model, params, state, key in runs:
        b = 256 if label == "main" else b
        gen = torch.Generator(device="cuda").manual_seed(8)
        wav, wav_len = _wavs(b, samples, shortest, gen)

        def step(model=model, params=params, state=state, key=key):
            feats = model.encode_speech(params, state, wav, wav_len)[key]
            return retrieve(feats, gallery, TOPK)

        with attention_backend(backend):
            _profile_step(f"{label} B={b} x {samples} samples (backend {backend})", step, b, smi)


def phase_profile_train(smi):
    """Where the train step's time goes (phase 17's step: dropout 0.1, B =
    TRAIN_BATCH, "auto"): one profiled step, the image-feature cache's step,
    and the step split by CUDA events into the frozen HuBERT forward, the
    frozen image tower and the rest (the branches' forward and backward,
    the loss, clip and Adam)."""
    import torch

    model = _train_model(dropout=0.1)
    batch = _train_batch(TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(19))
    state, _, step = _train_state(model)
    holder = [state]

    def train(b):
        def one():
            holder[0], _ = step(holder[0], b)
        return one

    _profile_step(f"train step B={TRAIN_BATCH} (dropout 0.1, backend auto)", train(batch),
                  1, smi)
    cached = {k: v for k, v in batch.items() if k != "image"}
    cached["image_feat_frozen"] = model.encode_image_tower(holder[0].params, batch["image"]).float()
    _profile_step(f"train step B={TRAIN_BATCH} with the image-feature cache", train(cached), 1,
                  smi)
    parts = {
        "step": train(batch),
        "frozen HuBERT forward": lambda: model.forward_audio(holder[0].params, batch["wav"],
                                                             batch["wav_len"]),
        "frozen image tower": lambda: model.encode_image_tower(holder[0].params, batch["image"]),
    }
    ms = {name: 1e3 / _rate(fn, 1) for name, fn in parts.items()}
    rest = ms["step"] - ms["frozen HuBERT forward"] - ms["frozen image tower"]
    say(f"profile train step split on {smi} ({RATE_NOTE}): " + ", ".join(
        f"{name} {v:.3f} ms" for name, v in ms.items())
        + f", the rest (branches forward + backward, loss, clip, Adam) {rest:.3f} ms")


TRAINABLE_PROFILE_BATCH = 128


def phase_profile_trainable(smi):
    """Where the trainable step's time goes: phase 22's full fine-tune at
    HuBERT dropout 0 on the kernel path ("auto", B =
    TRAINABLE_PROFILE_BATCH): one profiled step, then the step split by
    CUDA events into HuBERT's forward (train mode, keeping its graph), the
    plain recomputes of its 13 ``mha_layer_block`` and 13 ``ffn_block``
    calls (each kernel's backward at the HuBERT layer's shape, times 13),
    ``pos_conv``'s backward (its forward and backward less its forward) and
    the rest (the branches, the rest of HuBERT's backward, the loss, clip
    and Adam)."""
    import torch

    from speechclip_tpu_torch.kernels import ffn_block as fb
    from speechclip_tpu_torch.kernels import mha_block as mb
    from speechclip_tpu_torch.models.hubert import pos_conv_apply

    b = TRAINABLE_PROFILE_BATCH
    model = _trainable_model(audio_trainable=True)
    gen = torch.Generator(device="cuda").manual_seed(42)
    batch = _train_batch(b, gen)
    state, _, step = _train_state(model)
    holder = [state]
    del state

    def one():
        holder[0], _ = step(holder[0], batch)

    _profile_step(f"trainable step B={b} (full fine-tune, dropout 0, backend auto)", one, 1, smi)
    params, cfg = holder[0].params, model.audio_cfg
    shape = dict(HUBERT_SHAPE, b=b)
    x, lens, m, f = _layer_inputs(shape, gen)
    req = lambda t: t.detach().clone().requires_grad_(True)
    g = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    mha_in = [req(x)] + [req(m[k]) for k in ("w_in", "b_in", "w_out", "b_out", "ln_g", "ln_b")]
    ffn_in = [req(x)] + [req(f[k]) for k in ("w1", "b1", "w2", "b2", "ln_g", "ln_b")]
    mha_out = mb.mha_layer_block(*mha_in, lens, shape["heads"], "post", 1e-5)
    ffn_out = fb.ffn_block(*ffn_in, "post", 1e-5)
    pos = params["audio_encoder"]["encoder"]["pos_conv"]
    xp = req(x)
    parts = {
        "step": one,
        "HuBERT forward (train mode, with its graph)": lambda: model.forward_audio(
            params, batch["wav"], batch["wav_len"], train=True, generator=holder[0].generator),
        "13 mha_layer_block recomputes": lambda: torch.autograd.grad(
            mha_out, mha_in, g, retain_graph=True),
        "13 ffn_block recomputes": lambda: torch.autograd.grad(
            ffn_out, ffn_in, g, retain_graph=True),
        "pos_conv forward": lambda: pos_conv_apply(pos, cfg, x),
        "pos_conv forward + backward": lambda: torch.autograd.grad(
            pos_conv_apply(pos, cfg, xp), [xp, pos["w"], pos["b"]], g),
    }
    ms = {name: 1e3 / _rate(fn, 1) for name, fn in parts.items()}
    layers = cfg.encoder_layers + 1
    for name in ("13 mha_layer_block recomputes", "13 ffn_block recomputes"):
        ms[name] *= layers
    ms["pos_conv backward"] = ms.pop("pos_conv forward + backward") - ms.pop("pos_conv forward")
    rest = ms["step"] - sum(v for k, v in ms.items() if k != "step")
    say(f"profile trainable step split at B={b} on {smi} ({RATE_NOTE}): " + ", ".join(
        f"{name} {v:.3f} ms" for name, v in ms.items())
        + f", the rest (the rest of HuBERT's backward, the branches, loss, clip, Adam) "
        f"{rest:.3f} ms")


def phase_profile_large(smi):
    """Where the large paths' time goes: the large encode + retrieve step of
    phase 19 at B = 256 (``_profile_step``) and its split by CUDA events
    (``_rate``) into HuBERT-large's front end (the waveform normalization,
    the conv chain with a LayerNorm after every conv, ``pos_conv``), its 24
    layers, the s3prl weighted sum and the branch + retrieval; then phase
    20's train step at B = 256 with the image-feature cache, ``wsum_remat``
    off and on, profiled."""
    import torch

    from speechclip_tpu_torch import bench_variant_config, retrieve
    from speechclip_tpu_torch.models import hubert

    model, params, _ = _model(bench_variant_config("large_par"))
    b = LARGE_THROUGHPUT_BATCH
    gen = torch.Generator(device="cuda").manual_seed(37)
    gallery = torch.nn.functional.normalize(
        torch.randn(GALLERY, model.config.clip_embed_dim, generator=gen, device="cuda"), dim=-1)
    wav, wav_len = _wavs(b, WAV_SAMPLES, WAV_SAMPLES // 2, gen)
    ae, cfg = params["audio_encoder"], model.audio_cfg
    x = wav.to(model.compute_dtype)

    def step():
        return retrieve(model.encode_speech(params, {}, wav, wav_len)["parallel_audio_feat"],
                        gallery, TOPK)

    with torch.no_grad():
        _profile_step(f"large main B={b} x {WAV_SAMPLES} samples (backend auto)", step, b, smi)
        parts = {"front end": lambda: hubert._encoder_prelude(ae, cfg, x, wav_len),
                 "HuBERT-large": lambda: hubert.hubert_apply(ae, cfg, x, wav_len),
                 "forward_audio": lambda: model.forward_audio(params, wav, wav_len),
                 "encode + retrieve": step}
        ms = {name: 1e3 / _rate(fn, 1) for name, fn in parts.items()}
    say(f"profile large main split on {smi} ({RATE_NOTE}): front end {ms['front end']:.3f} ms, "
        f"24 layers {ms['HuBERT-large'] - ms['front end']:.3f}, s3prl weighted sum "
        f"{ms['forward_audio'] - ms['HuBERT-large']:.3f}, branch + retrieval "
        f"{ms['encode + retrieve'] - ms['forward_audio']:.3f}; whole {ms['encode + retrieve']:.3f}")
    del model, params, wav, x
    torch.cuda.empty_cache()
    batch = _train_batch(b, gen)
    for remat in (False, True):
        model = _large_train_model(remat)
        state, _, step = _train_state(model)
        cached = {k: v for k, v in batch.items() if k != "image"}
        cached["image_feat_frozen"] = model.encode_image_tower(state.params,
                                                               batch["image"]).float()
        holder = [state]

        def one(step=step, holder=holder, cached=cached):
            holder[0], _ = step(holder[0], cached)

        del state
        _profile_step(f"large train step B={b} with the image-feature cache, wsum_remat "
                      f"{'on' if remat else 'off'}", one, 1, smi)
        del model, holder, step, one, cached
        torch.cuda.empty_cache()


def phase_profile_gallery(model, params, smi):
    """Where the gallery side's time goes (``_profile_step``): the ViT-B/32
    gallery at phase 11's batch under both backends and its preprocessing
    alone; text at phase 12's batch under both backends (the f32 tower);
    the ViT-L/14 and RN50 towers of phases 14 and 15; then the retrieval
    eval of phase 13 in parts (host clock, each part synchronized)."""
    import torch

    from speechclip_tpu_torch.data.image import device_clip_preprocess
    from speechclip_tpu_torch.ops.attention import attention_backend

    gen = torch.Generator(device="cuda").manual_seed(22)
    images = _uint8_images(GALLERY_IMAGES, 256, gen)
    _profile_step(f"preprocess B={GALLERY_IMAGES} 256 -> 224",
                  functools.partial(device_clip_preprocess, images), GALLERY_IMAGES, smi)
    ids, eot = _token_ids(TEXT_BATCH, model.clip_cfg, gen)
    for backend in ("auto", "pallas"):
        with attention_backend(backend):
            _profile_step(f"gallery ViT-B/32 B={GALLERY_IMAGES} (backend {backend})",
                          functools.partial(model.forward_image, params, images),
                          GALLERY_IMAGES, smi)
            _profile_step(f"text f32 B={TEXT_BATCH} (backend {backend})",
                          functools.partial(model.forward_text, params, ids, eot), TEXT_BATCH, smi)
    for name, (batch, seed) in TOWERS.items():
        _, run = _tower(name, batch, seed, (torch.bfloat16,))
        _profile_step(f"{name} tower B={batch} bf16 (backend auto)",
                      functools.partial(run, torch.bfloat16), batch, smi)
        del run
    parts = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return out

    _eval_run(model, params)[0](timed)
    say(f"profile eval (phase 13's shapes) on {smi}: " + ", ".join(
        f"{name} {1000 * t:.1f} ms" for name, t in parts.items())
        + f" (host clock, each part synchronized; total {1000 * sum(parts.values()):.1f} ms)")


def phase_frontend_split(model, params, smi):
    """The HuBERT front end in parts, at the main path's shapes: conv0 +
    GroupNorm + GELU and conv1..6 on one 64-utterance chunk of 6.4 s (as
    ``models/hubert.py`` runs them), and the grouped positional conv on the
    whole (256, 319, 768) batch; CUDA-event medians, and the kernels each
    part launches (torch.profiler), so that the profile's conv kernels can
    be told apart."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from speechclip_tpu_torch.models import hubert
    from speechclip_tpu_torch.ops.basic import gelu

    cfg, ae = model.audio_cfg, params["audio_encoder"]
    convs = ae["feature_extractor"]
    gen = torch.Generator(device="cuda").manual_seed(13)
    wav, _ = _wavs(64, WAV_SAMPLES, WAV_SAMPLES // 2, gen)
    wav = wav.to(model.compute_dtype)[:, None, :]

    def conv0():
        x = hubert._conv1d(wav, convs[0]["w"], stride=cfg.conv_layers[0][2])
        return gelu(hubert._group_norm_per_channel(x, convs[0]["norm"]))

    x0 = conv0()

    def conv1_6():
        x = x0
        for layer, (_c, _k, stride) in zip(convs[1:], cfg.conv_layers[1:]):
            x = gelu(hubert._conv1d(x, layer["w"], stride=stride))
        return x

    feat = torch.randn(256, 319, cfg.encoder_embed_dim, generator=gen,
                       device="cuda").to(model.compute_dtype)

    def pos_conv():
        return hubert.pos_conv_apply(ae["encoder"]["pos_conv"], cfg, feat)

    for name, fn in (("conv0 + GroupNorm + GELU, B=64", conv0), ("conv1..6 + GELU, B=64", conv1_6),
                     ("pos_conv (k=128, 16 groups), B=256", pos_conv)):
        ms = cuda_time_ms(fn)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted(((e.key, e.self_device_time_total / 1000.0, e.count)
                          for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                         key=lambda r: -r[1])
        top = "; ".join(f"{k[:60]} {t:.3f} ms x{n}" for k, t, n in kernels[:4])
        say(f"front end {name} on {smi}: {ms:.4f} ms (CUDA-event median of 20); kernels: {top}")


def _host_us(fn, calls: int = 200) -> float:
    """Microseconds of host time per call of ``fn`` over ``calls`` calls
    enqueued back to back (the device, slower per call, never holds the
    host back within the CUDA launch queue's depth)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def phase_gemm_ab(smi):
    """The wgmma GEMM against ``torch.matmul`` (cuBLAS) on the same bf16
    operands at the main path's four products, and the kernel at both tile
    widths (BN = 256, the plan at these N, and 128), each checked first:
    CUDA-event medians of 20 runs of 10 back-to-back calls, in turns
    (matmul, BN = 256, BN = 128, then back), so the host's launch path is
    hidden; run before any profiler pass of the process. Beside them, each
    call's host launch path (the kernel's wrapper and ``torch.matmul``)."""
    import torch

    from speechclip_tpu_torch.kernels import mha_block as mb

    gen = torch.Generator(device="cuda").manual_seed(9)
    for label, (m, n, k, epi) in GEMM_SHAPES.items():
        if label == "ragged":
            continue
        a, w, bias, resid = _gemm_operands(gen, m, n, k, epi)
        want = _gemm_reference(a, w, bias, epi, resid)
        fns = {f"kernel BN={bn}": functools.partial(mb.gemm, a, w, bias, epi, resid, block_n=bn)
               for bn in mb.GEMM_BLOCK_NS}
        for name, fn in fns.items():
            if not _gemm_agreement(fn(), want)[2]:
                fail(f"GEMM A/B {label} {name} disagrees with the f32 product")
        fns["torch.matmul"] = functools.partial(torch.matmul, a, w)
        order = ["torch.matmul", "kernel BN=256", "kernel BN=128"]
        times = {name: [] for name in order}
        for name in order + order[::-1]:
            times[name].append(cuda_time_ms(fns[name], calls=10))
        flops = 2 * m * n * k
        host = {name: _host_us(fns[name]) for name in order[:2]}
        say(f"GEMM A/B {label} M={m} N={n} K={k} epilogue {epi} on {smi}: " + "; ".join(
            f"{name} {t[0]:.4f}, {t[1]:.4f} ms ({flops / min(t) / 1e9:.1f} TFLOP/s)"
            for name, t in times.items()) + " (CUDA-event medians of 20 runs of 10 calls, "
            "in turns); host launch path per call (perf_counter over 200 calls): " +
            ", ".join(f"{name} {us:.1f} us" for name, us in host.items()))


def phase_conv_tiles(smi):
    """The conv kernel's two warpgroup tiles (``cf.CONV_TILES``) on each
    layer of the chain at the conv A/B shape, fed the plain chain's input
    to it, each checked first against the plain layer, beside two
    yardsticks on the layer's im2col copy (``torch.matmul``, and the GEMM of
    ``gemm_epilogue.cu`` with its GELU epilogue; timed only): CUDA-event medians of 20
    single calls, in turns, beside the layer's bound; then the SM clock and
    power the chain holds the card at. Run before any profiler pass of the
    process."""
    import torch

    from speechclip_tpu_torch.kernels import conv_frontend as cf
    from speechclip_tpu_torch.kernels import mha_block as mb

    gen = torch.Generator(device="cuda").manual_seed(15)
    layers, plain_out = _conv_layers(*_conv_inputs(gen))
    wants = [h for _, h, _, _ in layers[1:]] + [plain_out]
    for i, ((k, h, w, work), want) in enumerate(zip(layers, wants), 1):
        plan = cf.conv_tile(cf.layer_out_len(h.shape[1], k), w.shape[2])
        order = [plan] + [t for t in range(len(cf.CONV_TILES)) if t != plan]
        fns = {t: functools.partial(cf.conv_layer, h, w, k, t) for t in order}
        for t, fn in fns.items():
            st = cf.conv_chain_agreement(fn(), want)
            if not (st["finite"] and st["mismatch"] <= cf.MAX_LAYER_MISMATCH):
                fail(f"conv tile A/B layer {i} tile {cf.CONV_TILES[t]} disagrees: {st}")
        # yardsticks on the layer's im2col copy (rows (B*T_out, k*C)): cuBLAS's
        # bare product, and gemm_epilogue.cu's cooperative 128 x 256 GEMM with GELU
        a = h.unfold(1, k, 2).transpose(2, 3).reshape(-1, k * h.shape[2]).contiguous()
        w2 = w.reshape(-1, w.shape[2])
        zero = torch.zeros(w.shape[2], device="cuda")
        fns["torch.matmul"] = functools.partial(torch.matmul, a, w2)
        fns["gemm_epilogue"] = functools.partial(mb.gemm, a, w2, zero, mb.EPI_BIAS_GELU)
        order += ["torch.matmul", "gemm_epilogue"]
        times = {t: [] for t in order}
        for t in order + order[::-1]:
            times[t].append(cuda_time_ms(fns[t]))
        del a
        bound_ms, _ = bound(*work)
        name = lambda t: t if isinstance(t, str) else f"{cf.CONV_TILES[t][0]} x {cf.CONV_TILES[t][1]}"
        say(f"conv tile A/B layer {i} (k={k}, T {h.shape[1]}, plan {cf.CONV_TILES[plan]}) on "
            f"{smi}: " + "; ".join(
                f"{name(t)} {ts[0]:.4f}, {ts[1]:.4f} ms ({100 * bound_ms / min(ts):.1f} % of bound)"
                for t, ts in times.items())
            + f" (bound {bound_ms:.4f} ms; CUDA-event medians of 20, in turns; torch.matmul: "
            "the bare product of an im2col copy; gemm_epilogue: the layers' GEMM on it, tanh "
            "GELU)")
    x, ws = layers[0][1], [w for _, _, w, _ in layers]
    clocks, watts = _sustained_clocks(lambda: cf.fused_conv_chain(x, ws, CONV_KERNELS))
    clocks.sort()
    watts.sort()
    say(f"conv chain run back to back for 3 s on {smi}: SM clock {clocks[0]:.0f} / "
        f"{clocks[len(clocks) // 2]:.0f} / {clocks[-1]:.0f} MHz (min / median / max), power "
        f"{watts[len(watts) // 2]:.2f} W median, {len(clocks)} nvidia-smi samples")


def _sustained_clocks(fn, seconds: float = 3.0):
    """SM clock (MHz) and power draw (W) samples, every 250 ms from
    ``nvidia-smi``, while ``fn`` runs back to back for ``seconds``."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "250"], stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    samples = [tuple(float(v) for v in line.split(",")) for line in out.splitlines() if line.strip()]
    return [c for c, _ in samples], [w for _, w in samples]


def _run_counted(fn):
    """``fn()`` with every launch count set to 0 just before it and read
    just after (synchronized): (its result, the counts)."""
    import torch

    counters = _counters()
    _reset(counters)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: f.launches for name, f in counters.items()}


def _expect_launches(label, launches, **nonzero):
    expect = dict.fromkeys(_counters(), 0)
    expect.update(nonzero)
    if launches != expect:
        fail(f"{label}: kernel launches {launches}, expected {expect}")


def _uint8_images(n: int, side: int, gen):
    import torch

    return torch.randint(0, 256, (n, side, side, 3), generator=gen, device="cuda",
                         dtype=torch.uint8)


def phase_gallery(model, params, smi):
    """ViT-B/32 gallery features: GALLERY_IMAGES uint8 images of 256 x 256
    (``load_image_raw``'s decode size) through ``forward_image`` (on-device
    resize + normalize, the tower, L2 norm) under "auto" (no kernel: 50 rows
    are under every gate) and "pallas" (12 ``flash_attention``), each with
    the counts at 0; "pallas" against the all-plain path, "auto" against
    "pallas"; images/s of each."""
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend
    from speechclip_tpu_torch.ops.basic import l2_normalize

    images = _uint8_images(GALLERY_IMAGES, 256, torch.Generator(device="cuda").manual_seed(17))
    n_layers = model.vision_cfg.layers
    feats, launches, rates = {}, {}, {}
    for label, backend, plain in (("auto", "auto", False), ("pallas", "pallas", False),
                                  ("plain", "pallas", True)):
        step = functools.partial(model.forward_image, params, images, plain=plain)
        with attention_backend(backend):
            out, launches[label] = _run_counted(step)
            rates[label] = _rate(step, GALLERY_IMAGES)
        feats[label] = l2_normalize(out.float())
    cos_plain = row_cosine_min(feats["pallas"], feats["plain"])
    cos_auto = row_cosine_min(feats["auto"], feats["pallas"])
    say(f"phase 11 gallery ViT-B/32: forward_image on {GALLERY_IMAGES} uint8 images 256 x 256 x 3 "
        f"-> {tuple(feats['auto'].shape)}; launches 'auto' {launches['auto']}, 'pallas' "
        f"{launches['pallas']} (expect 0 and {n_layers} flash_attention); min row cosine "
        f"'pallas' vs plain {cos_plain:.6f}, 'auto' vs 'pallas' {cos_auto:.6f} (tol "
        f"{MIN_COSINE}); on {smi}: 'auto' {rates['auto']:.2f}, 'pallas' "
        f"{rates['pallas']:.2f}, plain {rates['plain']:.2f} images/s ({RATE_NOTE})")
    if tuple(feats["auto"].shape) != (GALLERY_IMAGES, model.config.clip_embed_dim):
        fail(f"gallery: feature shape {tuple(feats['auto'].shape)}")
    if not all(bool(torch.isfinite(f).all()) for f in feats.values()):
        fail("gallery: non-finite features")
    _expect_launches("gallery auto", launches["auto"])
    _expect_launches("gallery pallas", launches["pallas"], flash_attention=n_layers)
    if cos_plain < MIN_COSINE or cos_auto < MIN_COSINE:
        fail("gallery: the kernel path disagrees with the plain path")


def _token_ids(b: int, cfg, gen):
    """(B, context) CLIP token ids (SOT, random words, EOT at a random
    position, zeros after) and the EOT positions."""
    import torch

    n = cfg.context_length
    eot = torch.randint(4, n, (b,), generator=gen, device="cuda")
    ids = torch.randint(1, cfg.vocab_size - 2, (b, n), generator=gen, device="cuda")
    ids = ids.masked_fill(torch.arange(n, device="cuda")[None, :] > eot[:, None], 0)
    ids[:, 0] = cfg.vocab_size - 2
    return ids.scatter(1, eot[:, None], cfg.vocab_size - 1), eot


def phase_text(model, params, smi):
    """Text retrieval: ``forward_text`` on TEXT_BATCH x 77 token ids, EOT
    positions given. As in the JAX model, the tower runs in its token
    table's dtype, f32 (``cast_params`` keeps the text tower f32): under
    "auto" the stock path (77 causal rows are under every gate), under
    "pallas" 12 causal ``flash_attention`` in its f32 form, held to the
    all-plain path and to "auto" with f32 limits."""
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend

    cfg = model.clip_cfg
    ids, eot = _token_ids(TEXT_BATCH, cfg, torch.Generator(device="cuda").manual_seed(18))
    feats, launches, rates = {}, {}, {}
    for label, backend, plain in (("auto", "auto", False), ("pallas", "pallas", False),
                                  ("plain", "pallas", True)):
        step = functools.partial(model.forward_text, params, ids, eot, plain=plain)
        with attention_backend(backend):
            feats[label], launches[label] = _run_counted(step)
            rates[label] = _rate(step, TEXT_BATCH)
    scale = max(1.0, float(feats["plain"].abs().max()))
    err_plain = float((feats["pallas"] - feats["plain"]).abs().max()) / scale
    err_auto = float((feats["auto"] - feats["pallas"]).abs().max()) / scale
    cos_plain = row_cosine_min(feats["pallas"], feats["plain"])
    cos_auto = row_cosine_min(feats["auto"], feats["pallas"])
    say(f"phase 12 text: forward_text on {TEXT_BATCH} x {cfg.context_length} token ids "
        f"-> {tuple(feats['auto'].shape)} {feats['auto'].dtype}; launches 'auto' "
        f"{launches['auto']}, 'pallas' {launches['pallas']} (expect 0 and {cfg.layers} "
        f"flash_attention, f32); 'pallas' vs plain: max abs {err_plain:.3e} x max(1, max|feat|) "
        f"(tol {F32_TOL}), min row cosine {cos_plain:.7f} (tol {MIN_F32_COSINE}); 'auto' vs "
        f"'pallas': {err_auto:.3e}, {cos_auto:.7f}; on {smi}: 'auto' {rates['auto']:.2f}, "
        f"'pallas' {rates['pallas']:.2f}, plain {rates['plain']:.2f} sequences/s ({RATE_NOTE})")
    if any(f.dtype != torch.float32 or tuple(f.shape) != (TEXT_BATCH, cfg.output_dim)
           or not bool(torch.isfinite(f).all()) for f in feats.values()):
        fail("text: features are not finite f32 of the expected shape")
    _expect_launches("text auto", launches["auto"])
    _expect_launches("text pallas", launches["pallas"], flash_attention=cfg.layers)
    if max(err_plain, err_auto) > F32_TOL or min(cos_plain, cos_auto) < MIN_F32_COSINE:
        fail("text: the kernel path disagrees with the plain path")


def _recall_hits(order, q_ids, c_ids, k: int):
    """Per query, whether one of its first k candidates carries its id."""
    return (c_ids[order[:, :k]] == q_ids[:, None]).any(axis=1)


def _check_eval_direction(label, scores_dev, q_ids, c_ids, recall, s64):
    """One direction of the eval against a float64 recompute: the port's
    recall dict equals its per-query hits (the same scores and stable
    top-k as ``retrieval_metrics``); those equal the float64 ranking's, but
    for queries whose scores at places k and k + 1 are within 1e-6.
    Returns {k: near-tie queries}."""
    import numpy as np

    from speechclip_tpu_torch.ops import retrieval

    k_max = max(EVAL_RECALL_AT)
    port_order = retrieval.top_k(scores_dev, k_max)[1].cpu().numpy()
    order64 = np.argsort(-s64, axis=1, kind="stable")[:, :k_max + 1]
    vals64 = np.take_along_axis(s64, order64, axis=1)
    near = {}
    for k in EVAL_RECALL_AT:
        port_hits = _recall_hits(port_order, q_ids, c_ids, k)
        hits64 = _recall_hits(order64, q_ids, c_ids, k)
        tie = (np.abs(vals64[:, k - 1] - vals64[:, k]) <= 1e-6 if k < s64.shape[1]
               else np.zeros(len(q_ids), bool))
        near[k] = int(tie.sum())
        got = recall[f"recall@{k}"]
        if abs(got - 100.0 * port_hits.mean()) > 1e-3:
            fail(f"eval {label} recall@{k} {got} is not its own hits' {100 * port_hits.mean()}")
        wrong = int((port_hits != hits64)[~tie].sum())
        if wrong:
            fail(f"eval {label} recall@{k}: {wrong} queries differ from the float64 ranking")
        if not tie.any() and abs(got - 100.0 * hits64.mean()) > 1e-3:
            fail(f"eval {label} recall@{k} {got} != float64 {100 * hits64.mean()}")
    return near


def _eval_run(model, params):
    """Phase 13's eval as one function over its own seeded data: (run, n).
    ``run(part)`` drives it and returns (collected, recalls); each of its
    parts (encode_speech, forward_image, collect, retrieval_metrics) runs as
    ``part(name, fn)``, which may time it."""
    import torch

    from speechclip_tpu_torch.ops.basic import l2_normalize
    from speechclip_tpu_torch.training.evaluation import (
        collect_validation_outputs,
        retrieval_metrics,
    )

    gen = torch.Generator(device="cuda").manual_seed(19)
    n = EVAL_IMAGES * EVAL_CAPTIONS
    images = _uint8_images(EVAL_IMAGES, 256, gen)
    wav, wav_len = _wavs(n, WAV_SAMPLES, WAV_SAMPLES // 2, gen)
    ids = torch.randperm(n, generator=gen, device="cuda") // EVAL_CAPTIONS

    def run(part=lambda name, fn: fn()):
        outputs = []
        for i in range(0, n, EVAL_BATCH):
            sl = slice(i, i + EVAL_BATCH)
            audio = part("encode_speech", lambda: model.encode_speech(
                params, {}, wav[sl], wav_len[sl])["parallel_audio_feat"])
            image = part("forward_image", lambda: l2_normalize(
                model.forward_image(params, images[ids[sl]]).float()))
            outputs.append({"id": ids[sl], "audio_feat": audio, "image_feat": image})
        collected = part("collect", lambda: collect_validation_outputs(outputs))
        return collected, part("retrieval_metrics",
                               lambda: retrieval_metrics(collected, EVAL_RECALL_AT))

    return run, n


def phase_eval(model, params, smi):
    """The validation epoch's retrieval eval at Flickr8k's test-split shape:
    EVAL_IMAGES uint8 images (256 x 256) with EVAL_CAPTIONS utterances each
    (up to 6.4 s, random lengths), in shuffled order; ``encode_speech`` and
    ``forward_image`` (each utterance's image, as a validation batch carries
    it) in batches of EVAL_BATCH under "auto", ``collect_validation_outputs``,
    then ``retrieval_metrics`` (first image per id, f32 scores with TF32 off,
    recall@1/5/10 both ways), held to a float64 recompute."""
    import numpy as np
    import torch

    from speechclip_tpu_torch.ops import retrieval

    run, n = _eval_run(model, params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (collected, recalls), launches = _run_counted(run)
    wall = time.perf_counter() - t0
    batches = -(-n // EVAL_BATCH)
    layers = model.audio_cfg.encoder_layers + model.config.parallel_branch.n_layers
    _expect_launches("eval", launches, mha_layer_block=layers * batches,
                     ffn_block=layers * batches)
    # the float64 recompute from the same collected features
    all_ids = collected["id"]
    _, first = np.unique(all_ids, return_index=True)
    first = np.sort(first)
    img_ids, img64 = all_ids[first], collected["image_feat"][first].astype(np.float64)
    s64 = collected["audio_feat"].astype(np.float64) @ img64.T
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    scores = retrieval.scores(dev(collected["audio_feat"]), dev(collected["image_feat"][first]))
    near_ab = _check_eval_direction("audio -> image", scores, all_ids, img_ids, recalls[0], s64)
    near_ba = _check_eval_direction("image -> audio", scores.T, img_ids, all_ids, recalls[1],
                                    s64.T)
    for k in EVAL_RECALL_AT:
        key = f"recall@{k}"
        if abs(recalls[2][key] - (recalls[0][key] + recalls[1][key]) / 2) > 1e-6:
            fail(f"eval mean {key} is not the mean of the two directions")
    say(f"phase 13 retrieval eval (Flickr8k test-split shape): {n} utterances of up to "
        f"{WAV_SAMPLES} samples, {len(first)} images 256 x 256 x 3, batches of {EVAL_BATCH}, "
        f"backend auto; launches {launches} (expect {layers * batches} mha_layer_block and "
        f"ffn_block); audio -> image {recalls[0]}, image -> audio {recalls[1]}, mean "
        f"{recalls[2]}; equal to the float64 recompute, near-tie queries left out (k: count) "
        f"audio -> image {near_ab}, image -> audio {near_ba}; wall {wall:.3f} s on {smi} "
        f"(encode, images, collect, metrics; host clock)")


def _tower(name, batch, seed, dtypes):
    """A named CLIP image tower alone, seeded random init cast to each of
    ``dtypes``, on ``batch`` uint8 images of 256 x 256: (its config,
    run(dtype, plain=False)), ``run`` taking the images through
    ``device_clip_preprocess`` and ``clip.encode_image`` in ``dtype``."""
    import torch

    from speechclip_tpu_torch.config import NAMED_CLIP_CONFIGS
    from speechclip_tpu_torch.data.image import device_clip_preprocess
    from speechclip_tpu_torch.models import clip
    from speechclip_tpu_torch.models.speechclip import cast_params

    vcfg = NAMED_CLIP_CONFIGS[name].vision
    gen = torch.Generator(device="cuda").manual_seed(seed)
    init = {"visual": clip.vision_init(gen, vcfg)}
    raw = _uint8_images(batch, 256, gen)
    params = {dt: cast_params(init, dt) for dt in dtypes}
    del init

    def run(dtype, plain=False):
        images = device_clip_preprocess(raw, vcfg.image_size).to(dtype)
        return clip.encode_image(params[dtype], vcfg, images, plain)

    return vcfg, run


def phase_vit_l14(smi):
    """The ViT-L/14 image tower alone (the large configs'), seeded random
    init, VIT_L14_BATCH uint8 images through ``device_clip_preprocess`` and
    ``clip.encode_image`` in bf16 under "auto": 24 ``mha_layer_block``
    ("none", 257 rows, no lengths) and nothing else; held to the all-plain
    path."""
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend

    vcfg, run = _tower("ViT-L/14", *TOWERS["ViT-L/14"], (torch.bfloat16,))
    tower = functools.partial(run, torch.bfloat16)
    with attention_backend("auto"):
        out, launches = _run_counted(tower)
        want = tower(True)
        rates = {"kernel": _rate(tower, VIT_L14_BATCH),
                 "plain": _rate(functools.partial(tower, True), VIT_L14_BATCH)}
    cos = row_cosine_min(out, want)
    say(f"phase 14 ViT-L/14 tower: {VIT_L14_BATCH} uint8 images 256 x 256 x 3 -> "
        f"{tuple(out.shape)}, backend auto, launches {launches} (expect {vcfg.layers} "
        f"mha_layer_block), min row cosine vs plain {cos:.6f} (tol {MIN_COSINE}); on {smi}: "
        f"kernel path {rates['kernel']:.2f}, plain path {rates['plain']:.2f} images/s "
        f"({RATE_NOTE})")
    if tuple(out.shape) != (VIT_L14_BATCH, vcfg.output_dim) or not bool(torch.isfinite(out).all()):
        fail(f"ViT-L/14: features {tuple(out.shape)}")
    _expect_launches("ViT-L/14", launches, mha_layer_block=vcfg.layers)
    if cos < MIN_COSINE:
        fail("ViT-L/14: the kernel path disagrees with the plain path")


def phase_resnet(smi):
    """The ModifiedResNet RN50 tower (no kernel), seeded random init, on
    RN50_BATCH uint8 images of 256 x 256 (preprocessed to 224): bf16
    features against f32 features (TF32 off) on the card; images/s of
    both."""
    import torch

    vcfg, run = _tower("RN50", *TOWERS["RN50"], (torch.bfloat16, torch.float32))
    bf16 = functools.partial(run, torch.bfloat16)
    f32 = functools.partial(run, torch.float32)
    out, launches = _run_counted(bf16)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        want = f32()
        rate32 = _rate(f32, RN50_BATCH)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    rate16 = _rate(bf16, RN50_BATCH)
    cos = row_cosine_min(out, want)
    say(f"phase 15 ModifiedResNet RN50: {RN50_BATCH} uint8 images 256 x 256 x 3 -> "
        f"{vcfg.image_size} -> {tuple(out.shape)}, launches {launches} (expect none), bf16 vs "
        f"f32 (TF32 off) min row cosine {cos:.6f} (tol {MIN_COSINE}); on {smi}: bf16 "
        f"{rate16:.2f}, f32 {rate32:.2f} images/s, preprocessing included ({RATE_NOTE})")
    if tuple(out.shape) != (RN50_BATCH, vcfg.output_dim) or not bool(torch.isfinite(out).all()):
        fail(f"RN50: features {tuple(out.shape)}")
    _expect_launches("RN50", launches)
    if cos < MIN_COSINE:
        fail("RN50: bf16 features disagree with f32")


def _train_model(batch_chunk: int = 64, dropout: float = 0.0):
    """The flagship (both branches, frozen HuBERT and CLIP towers) on the
    card with both branch transformers' dropout at ``dropout``."""
    from speechclip_tpu_torch import SpeechCLIPModel, flagship_config

    cfg = flagship_config()
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, conv_batch_chunk=batch_chunk),
        parallel_branch=dataclasses.replace(cfg.parallel_branch, dropout=dropout),
        cascaded_branch=dataclasses.replace(cfg.cascaded_branch, dropout=dropout))
    return SpeechCLIPModel(cfg)


def _train_batch(b: int, gen):
    """bench.py's train batch: 6.4 s buffers with lengths U[3.2 s, 6.4 s],
    224 x 224 f32 images, ids arange(B) % (B // 5)."""
    import torch

    wav, wav_len = _wavs(b, WAV_SAMPLES, WAV_SAMPLES // 2, gen)
    image = torch.randn(b, 224, 224, 3, generator=gen, device="cuda")
    return {"wav": wav, "wav_len": wav_len, "image": image,
            "id": torch.arange(b, device="cuda") % (b // 5)}


def _train_state(model, plain=False, seed=0):
    """A train state from the model's seeded init (the same params every
    call), its optimizer and scheduler, and the train step."""
    from speechclip_tpu_torch.training.optim import build_optimizer
    from speechclip_tpu_torch.training.train_step import create_train_state, make_train_step

    state = create_train_state(model, seed=seed)
    optimizer, scheduler = build_optimizer(model.config, state.params,
                                           model.trainable_mask(state.params))
    step = make_train_step(model, optimizer, scheduler, model.config.accumulate_grad_batches,
                           plain=plain)
    return state, optimizer, step


def _train_grads(model, state, optimizer, batch, plain):
    """One train-mode forward and backward at ``state`` without an update:
    (losses, L2-normalized features, keyword ids, gradients of the trainable
    leaves, the new kw-BN state)."""
    import torch

    leaves = optimizer.param_groups[0]["params"]
    feats, _, others, new_state = model.forward(
        state.params, state.model_state, batch, generator=state.generator, train=True,
        num_updates=torch.tensor(0, device="cuda"), plain=plain)
    losses = model.compute_loss(state.params, feats)
    grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    ids = others["vq_results"]["targets"][..., 0]
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: v.detach() for k, v in feats.items() if k.endswith("_feat")}, ids, grads,
            new_state["cascaded_branch"]["bn"])


def _train_pre_vq(model, state, batch):
    """The cascaded branch's train-mode keywords before VQ, (B * K,
    text_dim), at ``state`` with no gradient and one generator seed (the
    same dropout draws, if any): on the kernel path's HuBERT output, the
    branch on the kernel path (``kernel``), on the plain path (``plain
    branch``) and on the plain path in f32 (``f32 branch``: the trainable
    leaves are f32 master weights, so it rounds only in f32); and the all-plain
    path (``plain``). At random init the train-mode kw-BN divides by batch
    statistics far smaller than the keywords' common part, so rounding
    shows magnified here."""
    import torch

    from speechclip_tpu_torch.models import branches

    out = {}
    with torch.no_grad():
        for hubert_plain, runs in ((False, {"kernel": (False, False), "plain branch": (True, False),
                                            "f32 branch": (True, True)}),
                                   (True, {"plain": (True, False)})):
            feat, lens = model.forward_audio(state.params, batch["wav"], batch["wav_len"],
                                             plain=hubert_plain)
            for name, (plain, f32) in runs.items():
                keywords, _ = branches._pre_vq_keywords(
                    state.params["cascaded_branch"], state.model_state["cascaded_branch"],
                    model.config.cascaded_branch, feat.float() if f32 else feat, lens, plain,
                    True, torch.Generator(device="cuda").manual_seed(0))
                out[name] = keywords.flatten(0, 1)
    return out


def _check_train_agreement(label, got, natural, imposed, pre_vq):
    """The kernel path's train-mode forward and backward against the
    all-plain path's (items 1 and 4 of the training phase): the losses
    against the plain path's own (``natural``); the features, the
    gradients, ``grad_norm`` and the kw-BN statistics against the plain
    path run with the kernel path's keyword ids imposed on its VQ
    (``imposed``); the continuous keywords before VQ (``pre_vq``), on one
    HuBERT output, against the plain branch (mean row cosine) and against
    the f32 branch, as close as the plain bf16 branch is to it (min row
    cosine, within TRAIN_PRE_VQ_SLACK). The VQ's argmax over
    49408 subwords is the step's one discontinuity: at random init in train
    mode the frozen forward's bf16 rounding alone flips a quarter of the ids
    (``scripts/torch_train_probe.py``), and a flipped id changes a row's
    text-tower input outright; the natural id agreement and the pre-VQ
    keywords' cosine against the all-plain path are printed, not held."""
    import torch

    from speechclip_tpu_torch.training.optim import global_norm

    losses, feats, ids, grads, bn = got
    p_losses, _, p_ids, _, _ = natural
    i_losses, p_feats, _, p_grads, p_bn = imposed
    loss_err = max(abs(losses[k] - p_losses[k]) / abs(p_losses[k]) for k in losses)
    cos_feat = {k: row_cosine_min(feats[k], p_feats[k]) for k in feats}
    norms = torch.stack([g.float().norm() for g in p_grads])
    live = norms > TRAIN_LIVE_GRAD * norms.max()
    cos = [float(torch.nn.functional.cosine_similarity(a.float().flatten(), b.float().flatten(),
                                                       dim=0))
           for a, b, keep in zip(grads, p_grads, live) if keep]
    norm, p_norm = float(global_norm(grads)), float(global_norm(p_grads))
    bn_err = max(float((bn[k] - p_bn[k]).abs().max() / p_bn[k].abs().max()) for k in bn)
    kw_cos = torch.nn.functional.cosine_similarity(
        pre_vq["kernel"].float(), pre_vq["plain branch"].float(), dim=-1)
    kw_mean = float(kw_cos.mean())
    kw_exact = {name: row_cosine_min(pre_vq[name], pre_vq["f32 branch"])
                for name in ("kernel", "plain branch")}
    kw_natural = row_cosine_min(pre_vq["kernel"], pre_vq["plain"])
    say(f"  {label} vs the plain path: losses {losses} vs {p_losses} (worst relative "
        f"{loss_err:.2e}, tol {TRAIN_LOSS_RTOL}); keyword ids agree "
        f"{float((ids == p_ids).float().mean()):.4f} (not held: the argmax flips under "
        f"rounding alone); the keywords before VQ, on the kernel path's HuBERT output: mean "
        f"row cosine {kw_mean:.6f} against the plain branch (tol {MIN_COSINE}; the worst row "
        f"{float(kw_cos.min()):.6f}, not held), min row cosine against the f32 branch {kw_exact['kernel']:.6f}, the plain bf16 branch's "
        f"{kw_exact['plain branch']:.6f} (tol: within {TRAIN_PRE_VQ_SLACK} of it); against the "
        f"all-plain path min row cosine {kw_natural:.6f} (not held: HuBERT's rounding, "
        f"magnified by the batch-statistic kw-BN). Against the plain path with these ids "
        f"imposed (losses {i_losses}): "
        f"features min row cosine {cos_feat} (tol {MIN_COSINE}); gradients of {len(grads)} "
        f"trainable leaves: min cosine {min(cos):.6f} over the {len(cos)} whose norm passes "
        f"{TRAIN_LIVE_GRAD} of the largest (tol {TRAIN_MIN_GRAD_COSINE}); grad_norm {norm:.6f} "
        f"vs {p_norm:.6f} (tol {TRAIN_GRAD_NORM_RTOL} relative); kw-BN running stats worst "
        f"{bn_err:.2e} of their largest (tol {TRAIN_BN_RTOL})")
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    if not (finite and loss_err <= TRAIN_LOSS_RTOL and min(cos_feat.values()) >= MIN_COSINE
            and kw_mean >= MIN_COSINE
            and kw_exact["kernel"] >= kw_exact["plain branch"] - TRAIN_PRE_VQ_SLACK
            and min(cos) >= TRAIN_MIN_GRAD_COSINE
            and abs(norm - p_norm) <= TRAIN_GRAD_NORM_RTOL * p_norm and bn_err <= TRAIN_BN_RTOL):
        fail(f"training {label}: the kernel path disagrees with the plain path")


@contextlib.contextmanager
def imposed_keyword_ids(ids):
    """The cascaded branch's VQ with the hard one-hot of ``ids`` (B, K) in
    place of its own argmax, the straight-through gradient (the tempered
    softmax's) kept: ``subword_prob - subword_prob.detach()`` is zero with
    that gradient. The argmax is the step's one discontinuity: held to
    another path's choice, the rest of the step is continuous."""
    import torch

    from speechclip_tpu_torch.models import branches

    inner = branches.vq_apply

    def imposed(*args, **kwargs):
        out = inner(*args, **kwargs)
        prob = out["subword_prob"]
        hard = torch.nn.functional.one_hot(ids, prob.shape[-1]).to(prob.dtype)
        return dict(out, subword_prob=hard + (prob - prob.detach()), targets=ids[..., None])

    branches.vq_apply = imposed
    try:
        yield
    finally:
        branches.vq_apply = inner


def _counted_step(step, state, batch):
    """One train step with every launch and recompute count set to 0 just
    before it and read just after: (state, metrics, launches, recomputes)."""
    import torch

    counters = _counters()
    _reset(counters)
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    return (state, metrics, {name: f.launches for name, f in counters.items()},
            _recomputes(counters))


def _expect_recomputes(label, recomputes, **nonzero):
    expect = {name: nonzero.get(name, 0) for name in recomputes}
    if recomputes != expect:
        fail(f"{label}: backward recomputes {recomputes}, expected {expect}")


def phase_train_agreement(label, backend, batch_size, seed, expect, expect_recomputes):
    """Training items 1 and 4: at dropout 0 one train-mode forward and
    backward on the kernel path and on the all-plain path from the same
    params and state (and the plain path again with the kernel path's
    keyword ids imposed; the keywords before VQ on both branch paths),
    held to each other (``_check_train_agreement``);
    then one step through ``make_train_step`` on each, the kernel path's
    counted."""
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend

    model = _train_model()
    batch = _train_batch(batch_size, torch.Generator(device="cuda").manual_seed(seed))
    with attention_backend(backend):
        state, optimizer, step = _train_state(model)
        got = _train_grads(model, state, optimizer, batch, plain=False)
        p_state, p_optimizer, p_step = _train_state(model, plain=True)
        natural = _train_grads(model, p_state, p_optimizer, batch, plain=True)
        with imposed_keyword_ids(got[2]):
            imposed = _train_grads(model, p_state, p_optimizer, batch, plain=True)
        pre_vq = _train_pre_vq(model, state, batch)
        say(f"phase 16 training {label} (backend {backend}, dropout 0): flagship_config(), "
            f"B={batch_size} x {WAV_SAMPLES} samples, 224 x 224 images")
        _check_train_agreement(label, got, natural, imposed, pre_vq)
        del got, natural, imposed, pre_vq
        state, metrics, launches, recomputes = _counted_step(step, state, batch)
        p_state, p_metrics, p_launches, _ = _counted_step(p_step, p_state, batch)
    loss, p_loss = float(metrics["train_loss"]), float(p_metrics["train_loss"])
    say(f"  {label} step through make_train_step: train_loss {loss:.6f}, plain {p_loss:.6f}; "
        f"launches {launches} (expect {expect}), backward recomputes {recomputes} (expect "
        f"{expect_recomputes}), plain path launches {p_launches}")
    _expect_launches(f"training {label}", launches, **expect)
    _expect_recomputes(f"training {label}", recomputes, **expect_recomputes)
    _expect_launches(f"training {label} plain", p_launches)
    if not abs(loss - p_loss) <= TRAIN_LOSS_RTOL * abs(p_loss):
        fail(f"training {label}: train_loss {loss} vs plain {p_loss}")
    return launches, recomputes


def _step_ms(step, steps: int = TRAIN_TIMED_STEPS, warmup: int = TRAIN_WARMUP_STEPS):
    """ms of each of ``steps`` back-to-back calls of ``step`` after
    ``warmup`` calls: CUDA events recorded between the calls and read after
    the last, so no host wait comes between them."""
    import torch

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    events[0].record()
    for event in events[1:]:
        step()
        event.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def phase_train_timed(smi):
    """Training items 2 and 3: the flagship's dropout 0.1 under "auto", B =
    TRAIN_BATCH: ms per step (``_step_ms``: the median and range of
    TRAIN_TIMED_STEPS steps after TRAIN_WARMUP_STEPS) on the kernel path,
    with the image-feature cache (the frozen tower's output computed once),
    and on the plain path from its own train state; the kernel path's peak
    memory; every step's loss finite."""
    import torch

    model = _train_model(dropout=0.1)
    batch = _train_batch(TRAIN_BATCH, torch.Generator(device="cuda").manual_seed(19))
    state, _, step = _train_state(model)
    _, _, launches, recomputes = _counted_step(step, state, batch)
    _expect_launches("training timed", launches, mha_layer_block=12, ffn_block=12)
    _expect_recomputes("training timed", recomputes)
    cached = {k: v for k, v in batch.items() if k != "image"}
    cached["image_feat_frozen"] = model.encode_image_tower(state.params, batch["image"]).float()
    del state, step
    losses = {}

    def timed(name, plain, b):
        state, _, step = _train_state(model, plain=plain)
        holder, losses[name] = [state], []

        def one():
            holder[0], metrics = step(holder[0], b)
            losses[name].append(metrics["train_loss"])

        return _step_ms(one)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel path": timed("kernel path", False, batch)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    times["image cache"] = timed("image cache", False, cached)
    times["plain path"] = timed("plain path", True, batch)
    ms = {name: statistics.median(t) for name, t in times.items()}
    spread = {name: [min(t), max(t)] for name, t in times.items()}
    finite = all(bool(torch.isfinite(torch.stack(v)).all()) for v in losses.values())
    say(f"phase 17 training timed (backend auto, dropout 0.1): flagship_config() train step at "
        f"B={TRAIN_BATCH} x {WAV_SAMPLES} samples, 224 x 224 images, on {smi}, ms per step "
        f"(median [min, max] of {TRAIN_TIMED_STEPS} back-to-back steps by CUDA events, after "
        f"{TRAIN_WARMUP_STEPS} warm-up steps, each path from its own train state): "
        + ", ".join(f"{name} {ms[name]:.3f} [{spread[name][0]:.3f}, {spread[name][1]:.3f}]"
                    for name in times)
        + f"; every step {[round(v, 3) for t in times.values() for v in t]}; peak {peak:.3f} "
        f"GiB (kernel path); launches a step {launches}, recomputes {recomputes}; the loss of "
        f"each step {({k: [round(float(x), 4) for x in v] for k, v in losses.items()})}, all "
        f"finite {finite}")
    if not finite:
        fail("training timed: a non-finite loss")
    return dict(ms=ms["kernel path"], cache_ms=ms["image cache"], plain_ms=ms["plain path"],
                ms_range=spread["kernel path"], cache_ms_range=spread["image cache"],
                plain_ms_range=spread["plain path"], peak_gib=peak)


TRAINER_IMAGES = {"train": 154, "dev": 50}  # 5 captions each: 770 and 250 pairs
TRAINER_CAPTIONS = 5
TRAINER_SECONDS = {"train": (6.5, 10.0), "dev": (3.0, 17.0)}
TRAINER_SR = 16000
TRAINER_IMAGE_SIDE = 224
TRAINER_OVERRIDES = ["trainer.max_steps=6", "trainer.save_at_steps=[3]",
                     "data.dev_batch_size=16", "trainer.log_every_n_steps=1"]
TRAINER_SEED = 7122
# the cascaded runs: the tokenizer's text and the keyword diagnostics at every validation
DIAGNOSTICS_OVERRIDES = ["data.dataset.tokenizeText=true", "log_setting.log_detokenize_results=true",
                         "log_setting.log_detokenize_results_every_n_epoch=1"]
TRAINER_SAVE_STEP = 3
TRAINER_CONFIGS = {"spchclp_p": "configs/base/spchclp_p.yaml",
                   "spchclp_c": "configs/base/spchclp_c.yaml"}
# phase 21: the large Flickr configs, the cascaded one with wsum_remat on
LARGE_TRAINER_CONFIGS = {"spchclp_p": "configs/large_flickr/spchclp_p.yaml",
                         "spchclp_c": "configs/large_flickr/spchclp_c.yaml"}


BPE_MERGES = 48894  # CLIP's: 512 byte symbols + 48 894 merges + SOT + EOT = 49 408 ids


def write_synthetic_merges(path: str, seed: int = 0) -> str:
    """A gzipped BPE merges file with CLIP's id layout, written to ``path``:
    a header line, then BPE_MERGES distinct merges of two byte symbols (the
    second word-final or not), in a seeded order. A tokenizer over it has
    49 408 ids with SOT 49406 and EOT 49407, and every id decodes (each
    merge's string is distinct). CLIP's own file is not in the repository.
    -> ``path``."""
    import gzip

    import numpy as np

    from speechclip_tpu_torch.models.tokenizer import bytes_to_unicode

    symbols = list(bytes_to_unicode().values())
    pairs = [(a, b + end) for end in ("", "</w>") for a in symbols for b in symbols]
    order = np.random.default_rng(seed).permutation(len(pairs))[:BPE_MERGES]
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("#version: synthetic\n")
        f.write("\n".join(" ".join(pairs[i]) for i in order))
    return path


def _seeded_image(name: str):
    """The uint8 (side, side, 3) image a corpus entry stands for, seeded by
    its file name."""
    import zlib

    import numpy as np

    rng = np.random.default_rng(zlib.crc32(name.encode()))
    return rng.integers(0, 256, (TRAINER_IMAGE_SIDE, TRAINER_IMAGE_SIDE, 3), dtype=np.uint8)


def _image_decoder():
    """None where PIL writes and reads a JPEG here, else why not."""
    try:
        import io

        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(_seeded_image("probe")).save(buf, format="JPEG")
        buf.seek(0)
        Image.open(buf).convert("RGB")
        return None
    except Exception as e:  # ImportError, or a PIL without a JPEG codec
        return f"no JPEG codec: {type(e).__name__}: {e}"


def _write_trainer_corpus(root: str, write_jpegs: bool, words):
    """A seeded Flickr8k-shaped corpus in FlickrDataset's layout: per split
    its images with TRAINER_CAPTIONS real 16 kHz PCM16 WAVs each, their
    durations uniform in TRAINER_SECONDS (one dev caption exactly 17 s);
    ``Flickr8k.token.txt`` with captions of 4-14 of ``words`` (drawn from
    their own seed, so the audio does not depend on them); the split lists
    (test = dev); the JPEGs where PIL is there. -> ({split: [durations]},
    {image name: [its captions]})."""
    import os
    import wave

    import numpy as np

    rng = np.random.default_rng(TRAINER_SEED)
    texts = iter(_seeded_captions(words, TRAINER_CAPTIONS * sum(TRAINER_IMAGES.values()),
                                  TRAINER_SEED + 1))
    by_image = {}
    wav_dir = os.path.join(root, "flickr_audio", "wavs")
    os.makedirs(wav_dir)
    os.makedirs(os.path.join(root, "Images"))
    captions, durations = [], {}
    for split, n_images in TRAINER_IMAGES.items():
        names = [f"{split}{i:04d}" for i in range(n_images)]
        lo, hi = TRAINER_SECONDS[split]
        secs = rng.uniform(lo, hi, (n_images, TRAINER_CAPTIONS))
        if split == "dev":
            secs[0, 0] = hi
        durations[split] = secs.ravel().tolist()
        for name, row in zip(names, secs):
            if write_jpegs:
                from PIL import Image

                Image.fromarray(_seeded_image(f"{name}.jpg")).save(
                    os.path.join(root, "Images", f"{name}.jpg"), quality=95)
            for n, sec in enumerate(row):
                pcm = np.clip(rng.standard_normal(int(sec * TRAINER_SR)) * 3000.0, -32768, 32767)
                with wave.open(os.path.join(wav_dir, f"{name}_{n}.wav"), "wb") as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(TRAINER_SR)
                    w.writeframes(pcm.astype("<i2").tobytes())
                text = next(texts)
                by_image.setdefault(name, []).append(text)
                captions.append(f"{name}.jpg#{n}\t{text} .")
        with open(os.path.join(root, f"Flickr_8k.{split}Images.txt"), "w") as f:
            f.write("\n".join(f"{name}.jpg" for name in names))
    with open(os.path.join(root, "Flickr_8k.testImages.txt"), "w") as f:
        f.write("\n".join(f"dev{i:04d}.jpg" for i in range(TRAINER_IMAGES["dev"])))
    with open(os.path.join(root, "Flickr8k.token.txt"), "w") as f:
        f.write("\n".join(captions))
    return durations, by_image


def _caption_words(config_path: str):
    """{word: original id}: the one-id words of the token table that the
    config at ``config_path`` cuts (``_table_words`` over all its rows),
    for the trainer corpus's captions: each caption's gold token ids are
    then its words' ids, known without the program's tokenizer, and every
    one is a row of the table the keywords are ranked against."""
    from speechclip_tpu_torch.config import load_config
    from speechclip_tpu_torch.models.clip import load_reduced_vocab
    from speechclip_tpu_torch.models.speechclip import resolve_asset_path
    from speechclip_tpu_torch.models.tokenizer import CLIPTokenizer

    table = load_config(config_path).get_path("clip.reduce_subword_embbedding")
    return _table_words(CLIPTokenizer(), load_reduced_vocab(resolve_asset_path(table)), None)


def _seeded_image_dataset():
    """FlickrDataset whose image read returns the seeded image its entry
    stands for, normalized as ``load_image`` normalizes a 224 x 224 image
    (used where no JPEG can be written or read: the host decode is
    substituted, nothing on the device changes)."""
    import os

    from speechclip_tpu_torch.data.datasets import FlickrDataset
    from speechclip_tpu_torch.data.image import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

    class SeededImageFlickr(FlickrDataset):
        def get_item(self, index, skip_wav=False, skip_image=False):
            out = super().get_item(index, skip_wav=skip_wav, skip_image=True)
            entry = self.data[index]
            if "image" in entry and not skip_image:
                if self.image_mode != "clip":
                    fail(f"image substitution covers image_mode clip, not {self.image_mode}")
                img = _seeded_image(os.path.basename(entry["image"])).astype("float32") / 255.0
                out["image"] = (img - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD
            return out

    return SeededImageFlickr


def _encoder_layer_launches(b, t, d, heads, f):
    """The kernel launches of one encoder layer of (b, t, d) in bf16, from
    the gates: under "auto" the fused half-layers where ``block_eligible``
    (``ffn_block`` where ``ffn_eligible`` too), else the unfused layer's
    attention route (under "pallas" ``flash_attention``)."""
    from speechclip_tpu_torch.kernels.ffn_block import ffn_eligible
    from speechclip_tpu_torch.kernels.mha_block import block_eligible
    from speechclip_tpu_torch.ops.attention import attention_route, get_attention_backend

    if get_attention_backend() == "auto" and block_eligible(b, t, d, heads, 2):
        return {"mha_layer_block": 1, "ffn_block": int(ffn_eligible(b, t, d, f, 2))}
    route = attention_route(b, t, t, d, heads, 2)
    return {route: 1} if route in ("attention_vmem", "flash_attention") else {}


def _tower_launches(model, b):
    """The kernel launches of one frozen ViT image tower forward on b
    images in bf16 under "auto", from the gates (a ModifiedResNet has
    none): ViT-L/14's 257 rows take ``mha_layer_block``, ViT-B/32's 50
    ``sdpa_plain``."""
    from speechclip_tpu_torch.config import CLIPVisionConfig
    from speechclip_tpu_torch.ops.attention import attention_route

    v = model.vision_cfg
    if not isinstance(v, CLIPVisionConfig):
        return {}
    t = (v.image_size // v.patch_size) ** 2 + 1
    name = {"mha_block": "mha_layer_block"}.get(attention_route(b, t, t, v.width, v.heads, 2))
    return {name: v.layers} if name else {}


def _add(total, part, times=1):
    for name, n in part.items():
        total[name] = total.get(name, 0) + n * times
    return total


def _expected_launches(model, b, samples, train):
    """A train step's (dropout > 0 keeps the branch layer unfused, and its
    attention on ``sdpa_plain``; ``wsum_remat`` doubles HuBERT's layers) or
    an eval batch's launches at B = b and a
    buffer of ``samples``: HuBERT's layers, the parallel branch's layers
    (T + 1 rows), the cascaded branch's head (K + T rows, one head) and the
    text tower's causal K + 2 rows: where the gates send them."""
    from speechclip_tpu_torch.models.hubert import conv_output_length
    from speechclip_tpu_torch.ops.attention import attention_route

    cfg, a = model.config, model.audio_cfg
    t = conv_output_length(a, samples)
    # a train step under wsum_remat runs the frozen encoder twice: the
    # forward and the backward's recompute
    passes = 2 if train and model.wsum_remat_engaged else 1
    out = _add({}, _encoder_layer_launches(b, t, a.encoder_embed_dim, a.encoder_heads,
                                           a.encoder_ffn_dim), a.encoder_layers * passes)
    pb = cfg.parallel_branch
    if model.use_parallel and not (train and pb.dropout > 0):
        _add(out, _encoder_layer_launches(b, t + 1, pb.d_model, pb.nhead, pb.dim_feedforward),
             pb.n_layers)
    if model.use_cascaded:
        cb, k = cfg.cascaded_branch, cfg.cascaded_branch.keyword_number
        for rows, d, heads, causal, layers in ((k + t, cb.d_model, cb.nhead, False, cb.n_layers),
                                               (k + 2, model.clip_cfg.width, model.clip_cfg.heads,
                                                True, model.clip_cfg.layers)):
            if train and cb.dropout > 0 and not causal:
                continue
            route = attention_route(b, rows, rows, d, heads, 2, causal=causal)
            if route in ("attention_vmem", "flash_attention", "mha_block"):
                _add(out, {"mha_layer_block" if route == "mha_block" else route: 1}, layers)
    return {name: n for name, n in out.items() if n}


@contextlib.contextmanager
def _instrumented_trainer(rec):
    """Record, for every trainer built while it is open, each train step's,
    eval batch's and image-feature cache build's launches (count deltas:
    nothing is reset), each
    validation's collected features and recalls, and any call of a plain
    kernel version on a CUDA tensor (the kernels' wrappers never fall back;
    the train path keeps its recomputes at 0)."""
    import speechclip_tpu_torch.training.trainer as trainer_mod

    counters = _counters()
    snap = lambda: {n: f.launches for n, f in counters.items()}
    delta = lambda a, b: {n: a[n] - b[n] for n in a if a[n] != b[n]}
    patches = []

    def patch(module, name, new):
        patches.append((module, name, getattr(module, name)))
        setattr(module, name, new)

    make_train, make_eval, metrics = (trainer_mod.make_train_step, trainer_mod.make_eval_step,
                                      trainer_mod.retrieval_metrics)

    def counted_train(*args, **kwargs):
        step = make_train(*args, **kwargs)

        def run(state, batch):
            before = snap()
            out = step(state, batch)
            rec["steps"].append(delta(snap(), before))
            return out
        return run

    def counted_eval(*args, **kwargs):
        step = make_eval(*args, **kwargs)

        def run(state, batch):
            before = snap()
            out = step(state, batch)
            rec["eval"].append((int(batch["wav"].shape[1]), int(batch["wav"].shape[0]),
                                delta(snap(), before)))
            return out
        return run

    build_cache = trainer_mod.Trainer.build_image_feature_cache

    def counted_cache(self, dataset, params):
        before = snap()
        out = build_cache(self, dataset, params)
        rec["cache"].append((len(out[0]), delta(snap(), before)))
        return out

    def recorded_metrics(collected, recall_at, device="cuda"):
        out = metrics(collected, recall_at, device)
        rec["validations"].append((collected, out))
        return out

    diagnostics = trainer_mod.run_keyword_diagnostics

    def recorded_diagnostics(model, collected, emb, tokenizer, output_dir, epoch, kw_cfg=None):
        out = diagnostics(model, collected, emb, tokenizer, output_dir, epoch, kw_cfg)
        rec["diagnostics"].append(dict(collected=collected, emb=emb, tokenizer=tokenizer,
                                       dir=output_dir, epoch=epoch, kw_cfg=kw_cfg, out=out))
        return out

    patch(trainer_mod, "make_train_step", counted_train)
    patch(trainer_mod, "make_eval_step", counted_eval)
    patch(trainer_mod, "retrieval_metrics", recorded_metrics)
    patch(trainer_mod, "run_keyword_diagnostics", recorded_diagnostics)
    patch(trainer_mod.Trainer, "build_image_feature_cache", counted_cache)
    try:
        with _plain_guard(rec):
            yield
    finally:
        for module, name, old in reversed(patches):
            setattr(module, name, old)


@contextlib.contextmanager
def _plain_guard(rec):
    """While open, record in ``rec["plain_on_cuda"]`` every call of a
    kernel's plain version on a CUDA tensor (the wrappers never fall back)."""
    import torch

    from speechclip_tpu_torch.kernels import (attention_vmem, conv_frontend, flash_attention,
                                              fused_layer)
    from speechclip_tpu_torch.ops import attention as attention_mod

    def guard(name, fn):
        def plain(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                rec["plain_on_cuda"].append(name)
            return fn(*args, **kwargs)
        return plain

    patches = []
    for module, name in ((fused_layer, "mha_layer_block_plain"), (fused_layer, "ffn_block_plain"),
                         (attention_mod, "mha_layer_block_plain"),
                         (attention_vmem, "attention_vmem_plain"),
                         (flash_attention, "flash_attention_plain"),
                         (conv_frontend, "fused_conv_chain_plain")):
        patches.append((module, name, getattr(module, name)))
        setattr(module, name, guard(name, getattr(module, name)))
    try:
        yield
    finally:
        for module, name, old in reversed(patches):
            setattr(module, name, old)


@contextlib.contextmanager
def _dataset_class(cls):
    from speechclip_tpu_torch.data import datasets

    old = datasets.DATASETS["flickr"]
    datasets.DATASETS["flickr"] = cls or old
    try:
        yield
    finally:
        datasets.DATASETS["flickr"] = old


def _read_metrics(workdir):
    import json
    import os

    train, val = {}, {}
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            (train if "train_loss" in r else val)[r["step"]] = r
    return train, val


def _check_trainer_run(label, trainer, rec, launches, first_step, corpus):
    """Phase 18's checks of one fit to step 6 from ``first_step`` + 1:
    launches per train step and per eval batch against the gates' counts
    (``attention_vmem`` > 0 on the 17 s bucket), the counted total, the
    recalls against a float64 recompute, finite losses, the files, the
    keyword diagnostics against ``corpus`` (``_check_diagnostics``), and no
    plain kernel on a CUDA tensor. -> the run's summary."""
    import os
    import statistics

    import numpy as np
    import torch

    from speechclip_tpu_torch.config import load_config
    from speechclip_tpu_torch.ops import retrieval

    model, stats = trainer.model, trainer.loop_stats
    train_len = int(trainer.config.audio_encoder.max_audio_len)
    batch = int(trainer.config.data.batch_size)
    want_step = _expected_launches(model, batch, train_len, train=True)
    steps = list(range(first_step + 1, 7))
    if len(rec["steps"]) != len(steps) or any(s != want_step for s in rec["steps"]):
        fail(f"trainer {label}: per-step launches {rec['steps']}, expected {want_step} each")
    by_bucket = {}
    total = _add({}, want_step, len(steps))
    for samples, rows, got in rec["eval"]:
        want = _expected_launches(model, rows, samples, train=False)
        if got != want:
            fail(f"trainer {label}: eval batch of {rows} x {samples} samples launched {got}, "
                 f"the gates give {want}")
        entry = by_bucket.setdefault(samples, {"batches": 0, "launches": {}})
        entry["batches"] += 1
        _add(entry["launches"], got)
        _add(total, got)
    for n_images, got in rec["cache"]:  # the frozen tower in chunks of 64 images
        want = _add({}, _tower_launches(model, 64), -(-n_images // 64))
        if got != want:
            fail(f"trainer {label}: the image-feature cache of {n_images} images launched {got}, "
                 f"the gates give {want}")
        _add(total, got)
    total = {n: total.get(n, 0) for n in launches}
    if launches != total:
        fail(f"trainer {label}: launches {launches} over the run, the steps and eval batches "
             f"sum to {total}")
    longest = max(by_bucket)
    if not by_bucket[longest]["launches"].get("attention_vmem"):
        fail(f"trainer {label}: no attention_vmem on the {longest}-sample bucket")
    if rec["plain_on_cuda"]:
        fail(f"trainer {label}: plain kernel versions ran on CUDA tensors: {rec['plain_on_cuda']}")
    recomputes = _recomputes(_counters())
    if any(recomputes.values()):
        fail(f"trainer {label}: backward recomputes {recomputes} on a frozen-tower train path")
    # recall against a float64 recompute from the collected features
    for collected, (r_ab, r_ba, r_mean) in rec["validations"]:
        ids = collected["id"]
        _, first = np.unique(ids, return_index=True)
        first = np.sort(first)
        img_ids = ids[first]
        s64 = collected["audio_feat"].astype(np.float64) @ collected["image_feat"][first].astype(
            np.float64).T
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
        scores = retrieval.scores(dev(collected["audio_feat"]), dev(collected["image_feat"][first]))
        _check_eval_direction(f"trainer {label} audio -> image", scores, ids, img_ids, r_ab, s64)
        _check_eval_direction(f"trainer {label} image -> audio", scores.T, img_ids, ids, r_ba,
                              s64.T)
    train, val = _read_metrics(trainer.workdir)
    if sorted(train)[-len(steps):] != steps or not all(
            np.isfinite(train[s]["train_loss"]) for s in steps):
        fail(f"trainer {label}: metrics.jsonl train lines {sorted(train)}")
    val_steps = sorted(s for s in val if s > first_step)
    if not val_steps or not all(np.isfinite(val[s]["val_loss"]) and "val_recall_mean_10" in val[s]
                                for s in val_steps):
        fail(f"trainer {label}: metrics.jsonl validation lines {val}")
    ckpts = os.path.join(trainer.workdir, "ckpts")
    for part in ("last", f"step_{TRAINER_SAVE_STEP}", "val_loss", "val_recall_mean_10",
                 "config.yaml"):
        if not os.path.exists(os.path.join(ckpts, part)):
            fail(f"trainer {label}: ckpts/{part} missing")
    for monitor in ("val_loss", "val_recall_mean_10"):
        if not os.listdir(os.path.join(ckpts, monitor)):
            fail(f"trainer {label}: ckpts/{monitor} is empty")
    if load_config(os.path.join(ckpts, "config.yaml")) != trainer.config:
        fail(f"trainer {label}: ckpts/config.yaml does not read back to the run's tree")
    diagnostics = _check_diagnostics(label, trainer, rec, val, val_steps, corpus)
    ms = [1000.0 / train[s]["steps_per_sec"] for s in steps if s > 1]
    return {
        "steps": steps,
        "launches": launches,
        "launches_per_step": want_step,
        "eval_by_bucket": {str(k): v for k, v in sorted(by_bucket.items())},
        "train_loss": [train[s]["train_loss"] for s in steps],
        "val": {s: {k: val[s][k] for k in ("val_loss", "val_recall_mean_1",
                                            "val_recall_mean_10")} for s in val_steps},
        "ms_per_step": statistics.median(ms) if ms else None,
        "ms_per_step_each": ms,
        "host_share": stats["data_wait_s"] / stats["train_wall_s"],
        "epoch_first_wait_s": [w[0] for w in stats["data_waits"] if w],
        "other_wait_s": statistics.median([x for w in stats["data_waits"] for x in w[1:]] or [0]),
        "data_wait_s": stats["data_wait_s"],
        "train_wall_s": stats["train_wall_s"],
        "image_cache_s": stats["image_cache_s"],
        "validation_s": [v for _, v in stats["validations"]],
        "saves": [{"step": s, "seconds": t, "bytes": n} for s, t, n in stats["saves"]],
        "diagnostics": diagnostics,
    }


def _diagnostics_note(d):
    if d is None:
        return "off (no cascaded branch)"
    return (f"host s {[round(t, 3) for t in d['host_s']]} (epochs {d['epochs']}, top-{d['k']}), "
            f"kw_i {d['hit_rates']} equal to the float64 recompute, {d['compared']} dumped "
            f"neighbour lists equal to its top-{d['k']} ({d['ambiguous']} near-tie rows); "
            f"planted keywords: kw_i {d['planted']['hit_rates']} (at least "
            f"{d['planted']['floor']}) equal to the recompute")


def _corpus_gold_sets(label, corpus, collected):
    """Each validation row's gold token ids from the corpus the smoke wrote,
    not from the program's tokenizer: the row's pair id names its image
    (``Flickr8k_idPairs.json``), its gold text must be one of that image's
    captions, and a caption's ids are its words' ids. -> [set of ids]."""
    import json
    import os

    with open(os.path.join(corpus["root"], "Flickr8k_idPairs.json")) as f:
        names = json.load(f)["id2Filename"]
    gold_sets = []
    for pair, text in zip(collected["id"], collected["gold_text"]):
        words = " ".join(text.split())
        if words not in corpus["captions"][names[str(int(pair))]]:
            fail(f"trainer {label}: gold text {text!r} is none of image "
                 f"{names[str(int(pair))]}'s captions")
        gold_sets.append({corpus["word_ids"][w] for w in words.split()})
    return gold_sets


def _recompute_diagnostics(label, model, d, gold_sets, k):
    """One validation's diagnostics ``d`` (the recorded call: its collected
    rows, table, output directory, epoch and result) against a float64
    recompute that shares no code with ``detokenize_keywords``: cosine top-k
    of the keywords against the table, mapped to original ids, against
    ``gold_sets``; ``kw_hit_ep*.json``'s hit lists; ``keywords_ep*.json``'s
    neighbour lists (subwords in order, scores within 1e-4) and gold text. A
    keyword row with two of its top k + 1 float64 scores within 1e-5 may
    rank either way in f32: its list is not compared, and each such row may
    move a hit count by one. -> (hits per keyword, ambiguous rows, compared
    lists)."""
    import json
    import os

    import numpy as np

    lut = model.reduced_vocab.selected_ids if model.reduced_vocab is not None else None
    kw = d["collected"]["keywords"].astype(np.float64)
    gold = d["collected"]["gold_text"]
    n, kw_num, _ = kw.shape
    emb = d["emb"].detach().cpu().double().numpy()
    emb /= np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)
    kw /= np.maximum(np.linalg.norm(kw, axis=-1, keepdims=True), 1e-8)
    with open(os.path.join(d["dir"], f"kw_hit_ep{d['epoch']}.json")) as f:
        hit_lists = json.load(f)
    with open(os.path.join(d["dir"], f"keywords_ep{d['epoch']}.json")) as f:
        records = json.load(f)
    if len(records) != n:
        fail(f"trainer {label}: keywords_ep{d['epoch']}.json holds {len(records)} of {n} rows")
    hits = np.zeros(kw_num, np.int64)
    decoder, wrong, compared, ambiguous = d["tokenizer"].decoder, 0, 0, 0
    for start in range(0, n, 32):
        s = kw[start:start + 32] @ emb.T  # (b, K, V)
        top = np.argsort(-s, axis=-1, kind="stable")[..., :k + 1]
        vals = np.take_along_axis(s, top, axis=-1)
        near = (np.diff(-vals, axis=-1) < 1e-5).any(axis=-1)  # (b, K): a near tie in the top k + 1
        ambiguous += int(near.sum())
        for x in range(s.shape[0]):
            rec_x = records[start + x]
            for ki in range(kw_num):
                ids = top[x, ki, :k] if lut is None else lut[top[x, ki, :k]]
                hits[ki] += bool(set(int(i) for i in ids) & gold_sets[start + x])
                # the dump's neighbours: the same subwords in the same order, their scores
                rows = rec_x["neighbors"][f"keyword_{ki}"]
                compared += int(not near[x, ki])
                if not near[x, ki] and ([t for t, _ in rows] != [decoder[int(i)] for i in ids]
                                        or max(abs(v - w) for (_, v), w in
                                               zip(rows, vals[x, ki, :k])) > 1e-4):
                    wrong += 1
            if rec_x["gold"] != gold[start + x]:
                wrong += 1
    rate = hits / max(n, 1) * 100.0
    got = np.array([d["out"][f"kw_{i}"] for i in range(kw_num)])
    slack = ambiguous * 100.0 / max(n, 1)
    if wrong or np.abs(got - rate).max() > slack or (
            not ambiguous and [len(h) for h in hit_lists] != hits.tolist()):
        fail(f"trainer {label}: epoch {d['epoch']} hit rates {got.tolist()}, the float64 "
             f"recompute {rate.tolist()} ({ambiguous} ambiguous rows); {wrong} dumped "
             f"neighbour lists differ from it")
    return hits, ambiguous, compared


def _planted_keywords(collected, emb, gold_sets, vocab):
    """A copy of ``collected`` whose keyword i of row x, for x % (i + 2) ==
    0, is the table row of one of row x's gold tokens (the (x + i)-th of its
    sorted ids): its nearest row is that token, so every such row is a hit
    and kw_i reads at least 100 / (i + 2) %. -> (the copy, planted rows per
    keyword)."""
    import numpy as np

    kw = np.array(collected["keywords"], copy=True)
    table = emb.detach().float().cpu().numpy()
    planted = np.zeros(kw.shape[1], np.int64)
    for x, gold in enumerate(gold_sets):
        ids = sorted(gold)
        for i in range(kw.shape[1]):
            if x % (i + 2) == 0:
                orig = ids[(x + i) % len(ids)]
                kw[x, i] = table[orig if vocab is None else vocab.original_to_reduced[orig]]
                planted[i] += 1
    return {**collected, "keywords": kw}, planted


def _check_diagnostics(label, trainer, rec, val, val_steps, corpus):
    """The keyword diagnostics of a cascaded run with the tokenizer, one per
    validation: their JSON files, ``kw_hit_rate/kw_i`` in the validation
    lines, and each call against ``_recompute_diagnostics`` with the gold
    token sets read from ``corpus`` (``_corpus_gold_sets``). The run's own
    keywords seldom land on a caption's tokens, so its rates may all read 0;
    the last validation's rows are also passed to ``run_keyword_diagnostics``
    with planted keywords (``_planted_keywords``) and held to the recompute
    and to the planted floor. -> {"host_s": [...], "hit_rates": [...],
    "ambiguous": n, "planted": {...}}."""
    import os

    import numpy as np

    from speechclip_tpu_torch.training.evaluation import run_keyword_diagnostics

    model = trainer.model
    every_n = int(trainer.config.get_path("log_setting.log_detokenize_results_every_n_epoch", 1))
    on = (trainer.config.get_path("log_setting.log_detokenize_results", True)
          and model.use_cascaded and trainer.tokenizer is not None)
    want_n = sum(1 for _ in rec["validations"]) if on and every_n == 1 else None
    diag = rec["diagnostics"]
    if not on:
        if diag:
            fail(f"trainer {label}: keyword diagnostics ran without the cascaded branch or tokenizer")
        return None
    if want_n is not None and len(diag) != want_n:
        fail(f"trainer {label}: {len(diag)} keyword diagnostics for {want_n} validations")
    kw_cfg = trainer.config.get_path("model_settings.cascaded_branch.keyword") or {}
    k = int(kw_cfg.get("detokenized_K_neighbors", 10))
    if kw_cfg.get("retrieve_method", "cosine") != "cosine":
        fail(f"trainer {label}: the recompute covers cosine retrieval only")
    rates, total_ambiguous, total_compared = [], 0, 0
    for d in diag:
        gold_sets = _corpus_gold_sets(label, corpus, d["collected"])
        _, ambiguous, compared = _recompute_diagnostics(label, model, d, gold_sets, k)
        rates.append([d["out"][f"kw_{i}"] for i in range(model.keyword_num)])
        total_ambiguous += ambiguous
        total_compared += compared
    logged = [[val[s].get(f"kw_hit_rate/kw_{i}") for i in range(model.keyword_num)]
              for s in val_steps]
    if logged[-len(rates):] != rates[-len(logged):]:
        fail(f"trainer {label}: metrics.jsonl kw_hit_rate {logged}, the diagnostics {rates}")

    d = diag[-1]
    collected, planted = _planted_keywords(d["collected"], d["emb"], gold_sets,
                                           model.reduced_vocab)
    p_dir = f"{d['dir']}_planted"
    out = run_keyword_diagnostics(model, collected, d["emb"], d["tokenizer"], p_dir,
                                  d["epoch"], d["kw_cfg"])
    hits, _, _ = _recompute_diagnostics(
        f"{label} planted", model, {**d, "collected": collected, "dir": p_dir, "out": out},
        gold_sets, k)
    n = len(gold_sets)
    floor = planted * 100.0 / n
    p_rates = [out[f"kw_{i}"] for i in range(model.keyword_num)]
    if (hits < planted).any() or min(p_rates) <= 0:
        fail(f"trainer {label}: planted keywords hit {hits.tolist()} of {n} rows where "
             f"{planted.tolist()} were planted on a gold token; kw_i {p_rates}")
    return {"host_s": [t for _, t in trainer.loop_stats.get("diagnostics", [])],
            "hit_rates": rates, "ambiguous": total_ambiguous, "compared": total_compared, "k": k,
            "epochs": [d["epoch"] for d in diag],
            "planted": {"hit_rates": p_rates, "floor": [round(float(f), 3) for f in floor]}}


def _new_record():
    return {"steps": [], "eval": [], "cache": [], "validations": [], "plain_on_cuda": [],
            "diagnostics": []}


def _counted_fit(run, rec):
    """``run()`` (which builds a trainer and fits: -> (trainer, final
    state)) with every count at 0 just before and read just after, the
    trainer instrumented (``_instrumented_trainer``)."""
    import torch

    counters = _counters()
    _reset(counters)
    with _instrumented_trainer(rec):
        trainer, state = run()
    torch.cuda.synchronize()
    return trainer, state, {name: f.launches for name, f in counters.items()}


def _cli_fit(argv):
    from speechclip_tpu_torch import run_task

    runner = run_task.main(argv)
    return runner.trainer, runner.result


def _api_fit(tree, **fit_kwargs):
    """A Trainer with the CLI's tokenizer (``_build_tokenizer``), fitted."""
    from speechclip_tpu_torch.tasks.train_kwclip import _build_tokenizer
    from speechclip_tpu_torch.training.trainer import Trainer

    trainer = Trainer(tree, tokenizer=_build_tokenizer())
    return trainer, trainer.fit(**fit_kwargs)


def _step_one_check(label, tree, workdir, first):
    """The trainer adds no math: a fresh Trainer's initial state (the same
    seed), the first batch of its train loader with the cached image
    features, one ``make_train_step``: train_loss and grad_norm against the
    fit's step-1 line."""
    import dataclasses

    import torch

    from speechclip_tpu_torch.training.train_step import make_train_step, to_device
    from speechclip_tpu_torch.training.trainer import Trainer, _inject_cached_image_feats

    trainer = Trainer(tree, workdir=workdir)
    state = trainer.create_state()
    state = dataclasses.replace(state, params=trainer.model.load_pretrained(state.params))
    train_loader, _ = trainer.build_loaders()
    batch = next(iter(train_loader))
    if trainer._cache_image_features():
        cache, id2row = trainer.build_image_feature_cache(train_loader.dataset, state.params)
        batch = _inject_cached_image_feats(batch, cache, id2row)
    step = make_train_step(trainer.model, trainer.optimizer, trainer.scheduler,
                           trainer.model.config.accumulate_grad_batches)
    _, metrics = step(state, to_device(batch, trainer.model.device))
    got = {k: float(metrics[k]) for k in ("train_loss", "grad_norm")}
    diff = {k: got[k] - first[k] for k in got}
    say(f"  {label} step 1 through make_train_step on the trainer's first batch: {got}, the "
        f"fit's step 1 {({k: first[k] for k in got})}, difference {diff} (expect 0: the same "
        f"kernels on the same inputs)")
    if any(diff.values()):
        fail(f"trainer {label}: the fit's step 1 differs from make_train_step's: {diff}")
    del trainer, state, step
    torch.cuda.empty_cache()
    return diff


def _restore_check(label, tree, workdir, final_state):
    """Restore ckpts/step_3 into a fresh Trainer: the params (the frozen
    towers of a slim checkpoint through ``load_pretrained``: the seeded
    init, as the run's), the kw-BN statistics, the optimizer's state, the
    step and the generator's state equal what was saved, bitwise."""
    import os

    import torch

    from speechclip_tpu_torch.training.checkpoint import STATE_FILE
    from speechclip_tpu_torch.training.optim import tree_leaves
    from speechclip_tpu_torch.training.trainer import Trainer

    path = os.path.join(workdir, "ckpts", f"step_{TRAINER_SAVE_STEP}")
    trainer = Trainer(tree, workdir=workdir)
    state = trainer.restore(path, trainer.create_state())
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    slim = trainer.ckpt.is_slim(path)

    def same(a, b):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())

    triples = list(_paired_leaves(state.params, saved["params"], final_state.params))
    ok = len(triples) == len(list(tree_leaves(state.params)))
    frozen = 0
    for leaf, want, end in triples:
        if want is None:  # slim: a frozen tower, from load_pretrained
            frozen += 1
            ok &= same(leaf, end)
        else:
            ok &= same(leaf, want)
    ok &= all(same(a, b) for a, b in zip(tree_leaves(state.model_state),
                                         tree_leaves(saved["model_state"])))
    opt = trainer.optimizer.state_dict()["state"]
    ok &= opt.keys() == saved["optimizer"]["state"].keys() and all(
        same(opt[k][n], v) for k in opt for n, v in saved["optimizer"]["state"][k].items())
    ok &= state.step == saved["step"] == TRAINER_SAVE_STEP
    ok &= torch.equal(state.generator.get_state(), saved["generator"])
    say(f"  {label} restore of step_{TRAINER_SAVE_STEP} ({'slim: ' + str(frozen) + ' frozen leaves from load_pretrained' if slim else 'full'}): "
        f"{len(triples)} param leaves, kw-BN state, {len(opt)} optimizer states, step "
        f"{state.step}, generator state: bitwise equal {bool(ok)}")
    if not ok:
        fail(f"trainer {label}: the restored state differs from step_{TRAINER_SAVE_STEP}")
    if slim != (frozen > 0):
        fail(f"trainer {label}: slim {slim} but {frozen} leaves came from load_pretrained")
    del trainer, state
    torch.cuda.empty_cache()


def _paired_leaves(tree, *others):
    """(leaf, the other trees' leaves at its place) for every leaf of
    ``tree`` that is not None; a slim checkpoint's frozen leaves are None."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _paired_leaves(tree[k], *(o[k] for o in others))
    elif isinstance(tree, (list, tuple)):
        for items in zip(tree, *others):
            yield from _paired_leaves(*items)
    elif tree is not None:
        yield (tree, *others)


def _nccl_world1(argv, run_dir, final_state, tmp):
    """Phase 27 (a), run within phase 18: the CLI's argv again in a world-1
    ``torchrun`` environment (RANK 0, WORLD_SIZE 1, a free localhost port),
    so the task joins an NCCL group and every collective of the
    data-parallel path runs at world 1. Its losses, metrics and final
    params and statistics against phase 18's run of the same argv (``run_dir``,
    ``final_state``), bitwise."""
    import socket

    import torch
    import torch.distributed as dist

    from speechclip_tpu_torch.training.optim import tree_leaves

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    save = os.path.join(tmp, "p_nccl")
    argv = list(argv)
    argv[argv.index("--save_path") + 1] = save
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        trainer, state = _cli_fit(argv)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    mesh = trainer.mesh
    if dist.is_initialized():
        fail("phase 27 (a): the CLI left its process group initialized")
    if not (mesh.distributed and mesh.backend == "nccl" and mesh.world_size == 1):
        fail(f"phase 27 (a): the CLI ran on {mesh}, not a world-1 NCCL group")
    skip = ("time", "steps_per_sec")
    records = lambda d: [{k: v for k, v in r.items() if k not in skip}
                         for part in _read_metrics(d) for _, r in sorted(part.items())]
    want, got = records(run_dir), records(save)
    pairs = list(zip(tree_leaves(state.params), tree_leaves(final_state.params))) + list(
        zip(tree_leaves(state.model_state), tree_leaves(final_state.model_state)))
    same = [bool(torch.equal(a, b)) for a, b in pairs]
    max_diff = max(float((a.detach().float() - b.float()).abs().max()) for a, b in pairs)
    out = {"nccl": ".".join(map(str, torch.cuda.nccl.version())), "backend": mesh.backend,
           "world": mesh.world_size, "metrics_equal": got == want, "records": len(got),
           "leaves_equal": sum(same), "leaves": len(same), "max_abs_diff": max_diff,
           "wall_s": wall}
    say(f"phase 27 (a) world 1 under NCCL {out['nccl']} (process group initialized: backend "
        f"{mesh.backend}, world {mesh.world_size}) through the CLI on phase 18's corpus, seed and "
        f"steps: {len(got)} metric records equal to phase 18's {got == want}; params and kw-BN "
        f"statistics bitwise equal {sum(same)} of {len(same)} leaves (max abs diff {max_diff}); "
        f"wall {wall:.1f} s")
    if got != want or not all(same):
        fail("phase 27 (a): world 1 under NCCL differs from phase 18's run")
    del trainer, state
    return out


def phase_trainer(smi, beside, phase=18, configs=TRAINER_CONFIGS, c_overrides=(),
                  resume_c=False):
    """Phase 18 (and 21 for the large configs), the trainer: a seeded
    Flickr8k-shaped corpus on disk; the parallel config ``configs["spchclp_p"]``
    through the port's CLI (``run_task.main``, in this process) and the
    cascaded one ``configs["spchclp_c"]`` (slim checkpoints, plus
    ``c_overrides``) through the ``Trainer`` API, each at full width, B =
    256, precision 16, the image-feature cache, with TRAINER_OVERRIDES: 6
    steps (2 epochs of 3), 2 validations, checkpoints; the checks of
    ``_check_trainer_run``, step 1 against ``make_train_step``, the restore
    of step_3 and a resumed fit to step 6 (the cascaded run's too with
    ``resume_c``); the times, each run's ms/step beside ``beside[key]``."""
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from speechclip_tpu_torch.config import load_config
    from speechclip_tpu_torch.data import native

    def clear():
        gc.collect()
        torch.cuda.empty_cache()

    def resume(label, tree, run_dir, summary):
        rec = _new_record()
        step_path = os.path.join(run_dir, "ckpts", f"step_{TRAINER_SAVE_STEP}")
        resumed, state, r_launches = _counted_fit(lambda: _api_fit(tree, resume=step_path), rec)
        if state.step != 6:
            fail(f"trainer {label}: the resumed fit ended at step {state.step}")
        summary["resume"] = _check_trainer_run(f"{label} resume", resumed, rec, r_launches,
                                               TRAINER_SAVE_STEP, corpus_gold)
        del resumed, state, rec
        clear()

    name = {key: f"{'' if phase == 18 else 'large '}{key}" for key in configs}
    lp, lc = name["spchclp_p"], name["spchclp_c"]
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        why = _image_decoder()
        corpus = os.path.join(tmp, "flickr")
        t0 = time.perf_counter()
        words = _caption_words(configs["spchclp_c"])
        durations, captions = _write_trainer_corpus(corpus, write_jpegs=why is None, words=words)
        corpus_gold = {"root": corpus, "captions": captions, "word_ids": words}
        decode = "PIL" if why is None else f"substituted ({why})"
        say(f"phase {phase} trainer: corpus of {len(durations['train'])} train pairs "
            f"({min(durations['train']):.2f}-{max(durations['train']):.2f} s) and "
            f"{len(durations['dev'])} dev pairs ({min(durations['dev']):.2f}-"
            f"{max(durations['dev']):.2f} s), captions of {len(words)} one-id table words, "
            f"written in {time.perf_counter() - t0:.1f} s; image "
            f"decode: {decode}; WAV decode: {'native' if native.available() else 'python'}")
        out = {"image_decode": decode, "native_wav": native.available()}
        cls = None if why is None else _seeded_image_dataset()
        with _dataset_class(cls):
            # the parallel config through the CLI
            run_p = os.path.join(tmp, "p_run")
            argv = ["TrainKWClip_GeneralTransformer", "--config", configs["spchclp_p"],
                    "--train", "--dataset_root", corpus, "--save_path", run_p,
                    "--seed", str(TRAINER_SEED), "--override", *TRAINER_OVERRIDES]
            rec = _new_record()
            trainer, final_state, launches = _counted_fit(lambda: _cli_fit(argv), rec)
            tree = trainer.config
            summary = _check_trainer_run(lp, trainer, rec, launches, 0, corpus_gold)
            first = _read_metrics(run_p)[0][1]
            del trainer, rec
            clear()
            summary["step1_diff"] = _step_one_check(lp, tree, os.path.join(tmp, "p_step1"), first)
            _restore_check(lp, tree, run_p, final_state)
            if phase == 18:  # before the resumed fit appends to run_p's metrics
                out["nccl_world1"] = _nccl_world1(argv, run_p, final_state, tmp)
            del final_state
            clear()
            resume(lp, tree, run_p, summary)  # from step_3 in a fresh trainer, to step 6
            out["spchclp_p"] = summary

            # the cascaded config through the Trainer API, slim checkpoints
            run_c = os.path.join(tmp, "c_run")
            tree_c = load_config(configs["spchclp_c"], overrides=TRAINER_OVERRIDES + [
                "trainer.checkpoint_frozen=false", *DIAGNOSTICS_OVERRIDES, *c_overrides])
            tree_c.set_path("data.dataset.dataset_root", corpus)
            tree_c.set_path("trainer.default_root_dir", run_c)
            tree_c["seed"] = TRAINER_SEED
            rec = _new_record()
            trainer_c, state_c, launches_c = _counted_fit(lambda: _api_fit(tree_c), rec)
            summary_c = _check_trainer_run(lc, trainer_c, rec, launches_c, 0, corpus_gold)
            if not trainer_c.ckpt.is_slim(os.path.join(run_c, "ckpts", "last")):
                fail(f"trainer {lc}: checkpoint_frozen false wrote a full checkpoint")
            first_c = _read_metrics(run_c)[0][1]
            del trainer_c, rec
            clear()
            summary_c["step1_diff"] = _step_one_check(lc, tree_c, os.path.join(tmp, "c_step1"),
                                                      first_c)
            _restore_check(lc, tree_c, run_c, state_c)
            del state_c
            clear()
            if resume_c:
                resume(lc, tree_c, run_c, summary_c)
            out["spchclp_c"] = summary_c
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    for key in ("spchclp_p", "spchclp_c"):
        r = out[key]
        say(f"phase {phase} {name[key]} ({configs[key]}) on {smi}: launches {r['launches']} "
            f"({r['launches_per_step']} a train step); eval by bucket (samples: batches, "
            f"launches) {r['eval_by_bucket']}; "
            f"train_loss {[round(v, 4) for v in r['train_loss']]}; validations {r['val']}; "
            f"trainer ms/step (1000 / steps_per_sec, median of steps 2-6) {r['ms_per_step']:.3f} "
            f"{[round(v, 3) for v in r['ms_per_step_each']]} beside {beside[key]}; host share "
            f"(loader wait + H2D over the train loop's wall) "
            f"{r['host_share']:.4f} ({r['data_wait_s']:.3f} of {r['train_wall_s']:.3f} s; each "
            f"epoch's first batch {[round(v, 3) for v in r['epoch_first_wait_s']]} s, the others' "
            f"median {r['other_wait_s']:.3f} s); "
            f"image-cache build {r['image_cache_s']:.3f} s; keyword diagnostics "
            f"{_diagnostics_note(r['diagnostics'])}; validations "
            f"{[round(v, 3) for v in r['validation_s']]} s; checkpoint saves "
            f"{[(s['step'], round(s['seconds'], 3), s['bytes']) for s in r['saves']]} "
            f"(step, s, bytes)")
    say(f"phase {phase} trainer: wall {out['wall_s']:.1f} s")
    return out


def phase_large_encode(smi):
    """Phase 19, the large encode + retrieve path
    (``bench_variant_config("large_par")``: HuBERT-large, the s3prl
    per-state LayerNorm, the 1024-wide parallel branch, 768-wide features)
    at B = 64 and B = 256 against the all-plain path (``phase_path``: 25
    ``mha_layer_block`` a forward); the same forward with ``wsum_remat`` on
    (``hubert_frozen_weighted_sum``, the same params), held to the forward
    with it off within the bf16 limits, with its own launches; utt/s at B =
    256 of the kernel path, the plain path and the kernel path with
    ``wsum_remat``; then the large cascaded branch
    (``bench_variant_config("large_casc")``) under "auto" and "pallas" at B
    = 64 (``phase_cascaded``). -> (launches by path, rates)."""
    import torch

    from speechclip_tpu_torch import SpeechCLIPModel, bench_variant_config
    from speechclip_tpu_torch.ops.attention import attention_backend

    model, params, _ = _model(bench_variant_config("large_par"))
    gen = torch.Generator(device="cuda").manual_seed(29)
    gallery = torch.nn.functional.normalize(
        torch.randn(GALLERY, model.config.clip_embed_dim, generator=gen, device="cuda"), dim=-1)
    launches = {}
    b, samples, shortest, backend, expect = LARGE_PATHS["large main"]
    launches["large main"] = phase_path(19, "large main", model, params, gallery, 30,
                                        LARGE_PATHS["large main"])
    launches["large main B=256"] = phase_path(
        19, "large main B=256", model, params, gallery, 31,
        (LARGE_THROUGHPUT_BATCH, samples, shortest, backend, expect))

    remat = SpeechCLIPModel(dataclasses.replace(model.config, wsum_remat=True))
    wav, wav_len = _wavs(b, samples, shortest, torch.Generator(device="cuda").manual_seed(32))
    counters = _counters()
    with attention_backend(backend):
        ref_feat, ref_len = model.forward_audio(params, wav, wav_len)
        ref = model.encode_speech(params, {}, wav, wav_len)["parallel_audio_feat"]
        feat, feat_len = remat.forward_audio(params, wav, wav_len)
        _reset(counters)
        out = remat.encode_speech(params, {}, wav, wav_len)["parallel_audio_feat"]
        torch.cuda.synchronize()
        r_launches = {name: f.launches for name, f in counters.items()}
    err = float((feat.float() - ref_feat.float()).abs().max())
    cos_ws, cos = row_cosine_min(feat, ref_feat), row_cosine_min(out, ref)
    say(f"phase 19 large wsum_remat (hubert_frozen_weighted_sum, the same params): B={b} x "
        f"{samples} samples, launches {r_launches} (expect {expect}); the weighted-sum feature "
        f"{tuple(feat.shape)} {feat.dtype} vs wsum_remat off: max abs {err:.6f} (tol "
        f"{BF16_ATOL}), min row cosine {cos_ws:.6f} (tol {MIN_COSINE}); lengths equal "
        f"{torch.equal(feat_len, ref_len)}; features min row cosine {cos:.6f} (tol {MIN_COSINE})")
    if not (bool(torch.isfinite(out).all()) and err <= BF16_ATOL and min(cos_ws, cos) >= MIN_COSINE
            and torch.equal(feat_len, ref_len) and feat.dtype == ref_feat.dtype):
        fail("large wsum_remat: the forward disagrees with the forward without it")
    if r_launches != expect:
        fail(f"large wsum_remat: kernel launches {r_launches}, expected {expect}")
    launches["large wsum_remat"] = r_launches
    del wav, wav_len, ref_feat, ref, feat, out

    wav, wav_len = _wavs(LARGE_THROUGHPUT_BATCH, samples, shortest,
                         torch.Generator(device="cuda").manual_seed(33))
    with attention_backend(backend):
        rates = {"kernel": _utt_per_s(model, params, gallery, wav, wav_len, False),
                 "plain": _utt_per_s(model, params, gallery, wav, wav_len, True),
                 "kernel wsum_remat": _utt_per_s(remat, params, gallery, wav, wav_len, False)}
    say(f"phase 19 large encode+retrieve throughput at B={LARGE_THROUGHPUT_BATCH} x {samples} "
        f"samples (bench.py's hubert_large_utt_per_sec shape) on {smi}: "
        + ", ".join(f"{k} path {v:.2f} utt/s" for k, v in rates.items()) + f" ({RATE_NOTE})")
    del model, params, remat, wav, wav_len
    torch.cuda.empty_cache()

    model, params, state = _model(bench_variant_config("large_casc"))
    for i, (label, spec) in enumerate(LARGE_CASCADED_PATHS.items()):
        launches[label] = phase_cascaded(label, model, params, state, gallery, 34 + i, spec,
                                         phase=19)
    del model, params, state
    torch.cuda.empty_cache()
    return launches, rates


def _large_train_model(wsum_remat: bool, batch_chunk: int = 64):
    """``bench_variant_config("large_par")`` (the flagship dropout 0.1) on the
    card, ``wsum_remat`` as given."""
    from speechclip_tpu_torch import SpeechCLIPModel, bench_variant_config

    cfg = bench_variant_config("large_par")
    return SpeechCLIPModel(dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, conv_batch_chunk=batch_chunk),
        wsum_remat=wsum_remat))


def _wsum_grads(model, state, optimizer, batch):
    """One train-mode forward and backward at ``state`` (dropout drawn from a
    generator seeded 0): (loss, the weighted-sum logits' gradient,
    grad_norm over the trainable leaves)."""
    import torch

    from speechclip_tpu_torch.training.optim import global_norm

    leaves = optimizer.param_groups[0]["params"]
    feats, _, _, _ = model.forward(
        state.params, state.model_state, batch,
        generator=torch.Generator(device="cuda").manual_seed(0), train=True,
        num_updates=torch.tensor(0, device="cuda"))
    loss = model.compute_loss(state.params, feats)["loss"]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    ws = state.params["weighted_sum"]["weights"]
    i = next(i for i, p in enumerate(leaves) if p is ws)
    return float(loss.detach()), grads[i].detach().float(), float(global_norm(grads))


def wsum_on_off(models, batch):
    """One train-mode forward and backward of ``models[False]`` and
    ``models[True]`` (``wsum_remat`` off and on) from the same seeded train
    state and dropout, held to each other: the loss (``WSUM_LOSS_RTOL``),
    the weighted-sum logits' gradient (cosine ``WSUM_MIN_GRAD_COSINE``) and
    ``grad_norm`` (``WSUM_GRAD_NORM_RTOL``). -> {remat: (loss, the logits'
    gradient, grad_norm)}."""
    import torch

    agree = {}
    for remat in (False, True):
        state, optimizer, _ = _train_state(models[remat])
        agree[remat] = _wsum_grads(models[remat], state, optimizer, batch)
        del state, optimizer
        torch.cuda.empty_cache()
    (loss, g, norm), (r_loss, r_g, r_norm) = agree[False], agree[True]
    g_cos = float(torch.nn.functional.cosine_similarity(g, r_g, dim=0))
    loss_err = abs(r_loss - loss) / abs(loss)
    norm_err = abs(r_norm - norm) / norm
    say(f"phase 20 large train step, wsum_remat on vs off at B={batch['wav'].shape[0]} (one "
        f"forward and backward from the same train state, dropout from one seed): loss "
        f"{r_loss:.6f} vs {loss:.6f} (relative {loss_err:.2e}, tol {WSUM_LOSS_RTOL}); the "
        f"weighted-sum logits' gradient cosine {g_cos:.6f} (tol {WSUM_MIN_GRAD_COSINE}), max "
        f"abs {float((g - r_g).abs().max()):.3e} of {float(g.abs().max()):.3e}; grad_norm "
        f"{r_norm:.6f} vs {norm:.6f} (relative {norm_err:.2e}, tol {WSUM_GRAD_NORM_RTOL})")
    if not (math.isfinite(r_loss) and loss_err <= WSUM_LOSS_RTOL
            and g_cos >= WSUM_MIN_GRAD_COSINE and norm_err <= WSUM_GRAD_NORM_RTOL):
        fail("large train step: wsum_remat on disagrees with it off")
    return agree


def phase_large_train(smi):
    """Phase 20, the large train step (``bench_variant_config("large_par")``,
    dropout 0.1, backend "auto") at B = 128 and 256: at B = 128 one
    forward and backward with ``wsum_remat`` off and on from the same train
    state, held to each other (``wsum_on_off``); then, each from its own train
    state, ms per step (``_step_ms``) and peak GiB, off and on, with the
    image-feature cache at both batches and with the images (the ViT-L/14
    tower each step) at B = 128 (bench.py's train_step_ms_large_par_b128);
    each path's first step counted: 24 ``mha_layer_block`` for HuBERT-large
    (48 with the recompute), 24 more for the tower; the branch's layer is
    unfused at dropout 0.1. -> {label: {ms, range, peak_gib, launches}}."""
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend

    out = {}
    models = {remat: _large_train_model(remat) for remat in (False, True)}
    layers = models[False].audio_cfg.encoder_layers
    tower_layers = models[False].vision_cfg.layers
    gen = torch.Generator(device="cuda").manual_seed(36)
    with attention_backend("auto"):
        for b in LARGE_TRAIN_BATCHES:
            batch = _train_batch(b, gen)
            state, _, _ = _train_state(models[False])
            cached = {k: v for k, v in batch.items() if k != "image"}
            cached["image_feat_frozen"] = models[False].encode_image_tower(
                state.params, batch["image"]).float()
            del state
            torch.cuda.empty_cache()
            if b == LARGE_TRAIN_BATCHES[0]:
                agree = wsum_on_off(models, batch)
            runs = [(False, cached)] + ([(True, batch)] if b == LARGE_TRAIN_BATCHES[0] else [])
            for images, data in runs:
                for remat in (False, True):
                    label = (f"B={b} {'images' if images else 'image cache'} wsum_remat "
                             f"{'on' if remat else 'off'}")
                    state, _, step = _train_state(models[remat])
                    state, _, launches, recomputes = _counted_step(step, state, data)
                    expect = layers * (2 if remat else 1) + (tower_layers if images else 0)
                    _expect_launches(f"large train {label}", launches, mha_layer_block=expect)
                    _expect_recomputes(f"large train {label}", recomputes)
                    holder, losses = [state], []
                    del state

                    def one(holder=holder, losses=losses, step=step, data=data):
                        holder[0], metrics = step(holder[0], data)
                        losses.append(metrics["train_loss"])

                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    times = _step_ms(one)
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    finite = bool(torch.isfinite(torch.stack(losses)).all())
                    out[label] = dict(ms=statistics.median(times),
                                      range=[min(times), max(times)], peak_gib=peak,
                                      launches=launches)
                    say(f"phase 20 large train step {label}: {statistics.median(times):.3f} "
                        f"ms [{min(times):.3f}, {max(times):.3f}] (median [min, max] of "
                        f"{TRAIN_TIMED_STEPS} back-to-back steps by CUDA events, after "
                        f"{TRAIN_WARMUP_STEPS} warm-up steps), peak {peak:.3f} GiB, launches a "
                        f"step {launches}, losses finite {finite}, on {smi}")
                    if not finite:
                        fail(f"large train {label}: a non-finite loss")
                    del holder, step, one
                    torch.cuda.empty_cache()
            del batch, cached, data
            torch.cuda.empty_cache()
    del models
    torch.cuda.empty_cache()
    out["agreement"] = dict(loss=agree[False][0], loss_remat=agree[True][0],
                            grad_norm=agree[False][2], grad_norm_remat=agree[True][2])
    return out


# phase 22: the trainable encoder and towers (flagship_config() at full
# HuBERT-base width, seeded random weights, 6.4 s utterances)
TRAINABLE_BATCH = 64  # (a), (b), (d): one forward and backward, kernel vs plain
TRAINABLE_TIMED_BATCHES = (256, 128, 64)  # (c): the largest that fits
TRAINABLE_TIMED_STEPS = 2  # (c), (e): steps timed a configuration, after TRAIN_WARMUP_STEPS
TRAINABLE_UNFREEZE = (10, 11)
TRAINABLE_REINIT = (11,)
LARGE_UNFREEZE = (22, 23)
LARGE_TRAINABLE_BATCH = 128


def _trainable_model(hubert_dropout: float = 0.0, remat: bool = False, base=None,
                     **switches):
    """``base`` (``flagship_config()``) on the card with the trainable
    ``switches``, HuBERT's dropout and attention dropout at
    ``hubert_dropout`` (JAX's ``audio_encoder.custom`` fields), its
    ``remat``, and both branches' dropout at 0."""
    from speechclip_tpu_torch import SpeechCLIPModel, flagship_config

    cfg = base or flagship_config()
    cfg = dataclasses.replace(
        cfg, audio=dataclasses.replace(cfg.audio, conv_batch_chunk=64, dropout=hubert_dropout,
                                       attention_dropout=hubert_dropout, remat=remat),
        parallel_branch=dataclasses.replace(cfg.parallel_branch, dropout=0.0),
        cascaded_branch=dataclasses.replace(cfg.cascaded_branch, dropout=0.0), **switches)
    return SpeechCLIPModel(cfg)


def _leaf_paths(tree, prefix=""):
    """(dotted path, leaf) over the leaves of a params tree in the order the
    optimizer holds them (insertion order, None leaves left out)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def _trainable_paths(model, state):
    from speechclip_tpu_torch.training.optim import tree_leaves

    flags = list(tree_leaves(model.trainable_mask(state.params)))
    return [path for (path, _), keep in zip(_leaf_paths(state.params), flags) if keep]


def _group(path: str) -> str:
    """The part of the model a leaf belongs to, for the gradient cosines."""
    parts = path.split(".")
    if parts[0] == "audio_encoder":
        if parts[1] == "encoder" and parts[2] == "layers":
            return f"hubert layer {parts[3]}"
        if parts[1] == "encoder":
            return f"hubert {parts[2]}"
        return "hubert conv front end"
    if parts[0] == "clip":
        return f"clip {parts[1]}"
    return "branches, projections, weighted sum"


def _group_cosines(paths, grads, p_grads):
    """{group: cosine of the group's gradients, concatenated, kernel path
    against plain}."""
    import torch

    acc = {}
    for path, a, b in zip(paths, grads, p_grads):
        ab, aa, bb = acc.setdefault(_group(path), [0.0, 0.0, 0.0])
        a, b = a.double().flatten(), b.double().flatten()
        acc[_group(path)] = [ab + float(a @ b), aa + float(a @ a), bb + float(b @ b)]
    return {g: ab / max(math.sqrt(aa * bb), 1e-300) for g, (ab, aa, bb) in acc.items()}


def _trainable_agreement(label, model, batch, backend, expect, expect_recomputes, groups):
    """``phase_train_agreement``'s checks on a trainable configuration: one
    train-mode forward and backward on the kernel path and on the all-plain
    path from the same params, held to each other at phase 16's limits
    (the kernel path's keyword ids imposed on the plain VQ); the gradient
    cosine of each part of the model named in ``groups`` (each held to
    TRAIN_MIN_GRAD_COSINE); then one counted step through
    ``make_train_step``. -> (launches, recomputes, {group: cosine})."""
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend

    with attention_backend(backend):
        state, optimizer, step = _train_state(model)
        got = _train_grads(model, state, optimizer, batch, plain=False)
        p_state, p_optimizer, _ = _train_state(model, plain=True)
        natural = _train_grads(model, p_state, p_optimizer, batch, plain=True)
        with imposed_keyword_ids(got[2]):
            imposed = _train_grads(model, p_state, p_optimizer, batch, plain=True)
        pre_vq = _train_pre_vq(model, state, batch)
        say(f"phase 22 {label} (backend {backend}): B={batch['wav'].shape[0]} x {WAV_SAMPLES} "
            f"samples, 224 x 224 images")
        _check_train_agreement(label, got, natural, imposed, pre_vq)
        cos = _group_cosines(_trainable_paths(model, state), got[3], imposed[3])
        say(f"  {label}: gradient cosine kernel vs plain by part: "
            + ", ".join(f"{g} {c:.6f}" for g, c in cos.items()))
        missing = [g for g in groups if g not in cos]
        low = {g: c for g, c in cos.items() if g in groups and c < TRAIN_MIN_GRAD_COSINE}
        if missing or low:
            fail(f"{label}: parts without a gradient {missing}, below "
                 f"{TRAIN_MIN_GRAD_COSINE}: {low}")
        del got, natural, imposed, pre_vq, p_state, p_optimizer
        state, metrics, launches, recomputes = _counted_step(step, state, batch)
    say(f"  {label} step through make_train_step: train_loss "
        f"{float(metrics['train_loss']):.6f}, grad_norm {float(metrics['grad_norm']):.6f}; "
        f"launches {launches} (expect {expect}), backward recomputes {recomputes} (expect "
        f"{expect_recomputes})")
    _expect_launches(f"phase 22 {label}", launches, **expect)
    _expect_recomputes(f"phase 22 {label}", recomputes, **expect_recomputes)
    if not math.isfinite(float(metrics["train_loss"])):
        fail(f"{label}: a non-finite loss")
    return launches, recomputes, cos


def _snapshot(tree):
    return {path: leaf.detach().clone() for path, leaf in _leaf_paths(tree)}


def _moved(before, tree):
    """The paths of the leaves of ``tree`` that differ from ``before``."""
    import torch

    return {path for path, leaf in _leaf_paths(tree) if not torch.equal(before[path], leaf)}


def _selected_layers(batch, counts):
    """(b): ``unfreeze_layers`` [10, 11], then ``reinit_layers`` [11]: which
    encoder leaves take a gradient and move in one step, and its launches
    and recomputes (the selected layers and the branch layer)."""
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend

    out = {}
    with attention_backend("auto"):
        model = _trainable_model(audio_trainable=True, unfreeze_layers=TRAINABLE_UNFREEZE)
        state, optimizer, step = _train_state(model)
        paths = _trainable_paths(model, state)
        grads = _train_grads(model, state, optimizer, batch, plain=False)[3]
        held = {_group(p) for p, g in zip(paths, grads) if bool(g.abs().max() > 0)}
        before = _snapshot(state.params)
        state, _, launches, recomputes = _counted_step(step, state, batch)
        moved = _moved(before, state.params)
        encoder_moved = {_group(p) for p in moved if p.startswith("audio_encoder")}
        want = {f"hubert layer {i}" for i in TRAINABLE_UNFREEZE}
        say(f"phase 22 unfreeze_layers {list(TRAINABLE_UNFREEZE)} (backend auto, B="
            f"{batch['wav'].shape[0]}): parts with a gradient {sorted(held)}; encoder parts "
            f"moved by one step {sorted(encoder_moved)}; launches {launches}, backward "
            f"recomputes {recomputes} (expect {counts})")
        if held != want | {"branches, projections, weighted sum"} or encoder_moved != want:
            fail("unfreeze_layers: other encoder leaves hold a gradient or moved")
        _expect_launches("phase 22 unfreeze", launches, mha_layer_block=13, ffn_block=13)
        _expect_recomputes("phase 22 unfreeze", recomputes, **counts)
        out["unfreeze"] = dict(launches=launches, recomputes=recomputes,
                               moved=sorted(encoder_moved))
        del model, state, optimizer, step, grads, before
        torch.cuda.empty_cache()

        # seed 1: the reinit draws the port's seed-0 HuBERT init, which a
        # seed-0 model init would already hold
        model = _trainable_model(audio_trainable=True, reinit_layers=TRAINABLE_REINIT)
        state, _, step = _train_state(model, seed=1)
        before = _snapshot(state.params)
        state = dataclasses.replace(state, params=model.load_pretrained(state.params))
        reinit = {_group(p) for p in _moved(before, state.params)}
        loaded = _snapshot(state.params)
        state, _, launches, recomputes = _counted_step(step, state, batch)
        stepped = {_group(p) for p in _moved(loaded, state.params) if p.startswith("audio")}
        want = {f"hubert layer {i}" for i in TRAINABLE_REINIT}
        say(f"phase 22 reinit_layers {list(TRAINABLE_REINIT)}: load_pretrained changed "
            f"{sorted(reinit)}; one step moved the encoder parts {sorted(stepped)}; launches "
            f"{launches}, recomputes {recomputes}")
        if reinit != want or stepped != want | {"hubert layer_norm"}:
            fail("reinit_layers: other leaves changed")
        out["reinit"] = dict(changed=sorted(reinit), moved=sorted(stepped))
        del model, state, step, before, loaded
        torch.cuda.empty_cache()
    return out


def _timed_steps(label, model, plain, make_data, batches=TRAINABLE_TIMED_BATCHES):
    """ms per step (``_step_ms``: TRAINABLE_TIMED_STEPS after
    TRAIN_WARMUP_STEPS, each from its own train state) and peak GiB at the
    first of ``batches`` that fits; every step's loss finite.
    ``make_data(b, params)`` gives the batch of ``b`` for the state's
    params."""
    import gc

    import torch

    for b in batches:
        state = step = holder = data = one = None
        try:
            state, _, step = _train_state(model, plain=plain)
            data = make_data(b, state.params)
            holder, losses = [state], []
            state = None

            def one(holder=holder, losses=losses, step=step, data=data):
                holder[0], metrics = step(holder[0], data)
                losses.append(metrics["train_loss"])

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times = _step_ms(one, steps=TRAINABLE_TIMED_STEPS)
            peak = torch.cuda.max_memory_allocated() / 2**30
            finite = bool(torch.isfinite(torch.stack(losses)).all())
            run = dict(batch=b, ms=statistics.median(times), range=[min(times), max(times)],
                       peak_gib=peak, steps=times)
            say(f"phase 22 timed {label}: B={b}, {run['ms']:.3f} ms [{min(times):.3f}, "
                f"{max(times):.3f}] (median [min, max] of {TRAINABLE_TIMED_STEPS} steps by CUDA "
                f"events after {TRAIN_WARMUP_STEPS} warm-ups), peak {peak:.3f} GiB, losses "
                f"{[round(float(x), 4) for x in losses]}, finite {finite}")
            if not finite:
                fail(f"phase 22 timed {label}: a non-finite loss")
            return run
        except torch.cuda.OutOfMemoryError:
            say(f"phase 22 timed {label}: B={b} does not fit; halving")
        finally:
            del state, step, holder, data, one
            gc.collect()
            torch.cuda.empty_cache()
    fail(f"phase 22 timed {label}: no batch of {batches} fits")


def _towers(batch, phase16_pallas):
    """(d): the trainable ViT-B/32 tower under "auto" and "pallas", the
    trainable text tower under "pallas", each against the plain path; the
    trainer's image cache and the RN50 tower refuse a trainable image
    tower."""
    import os
    import shutil
    import tempfile

    import torch

    from speechclip_tpu_torch import SpeechCLIPModel, flagship_config
    from speechclip_tpu_torch.config import NAMED_CLIP_CONFIGS, load_config
    from speechclip_tpu_torch.training.trainer import Trainer

    out = {}
    flagship = flagship_config()
    image_layers, text_layers = flagship.clip_vision.layers, flagship.clip_text.layers
    runs = {
        "image tower auto": ("auto", dict(image_encoder_trainable=True),
                             dict(mha_layer_block=13, ffn_block=13),
                             dict(mha_layer_block=1, ffn_block=1)),
        "image tower pallas": ("pallas", dict(image_encoder_trainable=True),
                               dict(flash_attention=phase16_pallas),
                               dict(flash_attention=image_layers + 2 + text_layers)),
        "text tower pallas": ("pallas", dict(text_encoder_trainable=True),
                              dict(flash_attention=phase16_pallas),
                              dict(flash_attention=2 + text_layers)),
    }
    for label, (backend, switches, expect, expect_recomputes) in runs.items():
        model = _trainable_model(**switches)
        group = "clip visual" if "image" in label else "clip text"
        launches, recomputes, cos = _trainable_agreement(
            f"trainable {label}", model, batch, backend, expect, expect_recomputes, [group])
        out[label] = dict(launches=launches, recomputes=recomputes, cosine=cos[group])
        del model
        torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cache_")
    tree = load_config("configs/base/spchclp_p.yaml", overrides=[
        "trainer.cache_image_features=true", "clip.image_encoder_trainable=true",
        "trainer.logger=none"])
    trainer = Trainer(tree, workdir=os.path.join(tmp, "run"))
    try:
        trainer._cache_image_features()
        fail("the image-feature cache took a trainable image tower")
    except ValueError as e:
        say(f"phase 22 the trainer's image-feature cache with a trainable image tower raises: {e}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del trainer
    rn50 = NAMED_CLIP_CONFIGS["RN50"]
    try:
        SpeechCLIPModel(dataclasses.replace(flagship, clip_vision=rn50.vision,
                                            clip_text=rn50.text, image_encoder_trainable=True))
        fail("the RN50 tower took image_encoder_trainable")
    except NotImplementedError as e:
        say(f"phase 22 an RN50 config with image_encoder_trainable raises: {e}")
    return out


def _cached_batch(model, params, b, gen):
    """A train batch of ``b`` with the image tower's features at ``params``
    in place of the images (the trainer's image-feature cache)."""
    batch = _train_batch(b, gen)
    cached = {k: v for k, v in batch.items() if k != "image"}
    cached["image_feat_frozen"] = model.encode_image_tower(params, batch["image"]).float()
    return cached


def _large_partial(smi):
    """(e): ``bench_variant_config("large_par")`` with ``unfreeze_layers``
    [22, 23], ``remat`` on and every dropout at 0 (the fused path), B = 128
    with the image-feature cache: launches and recomputes of one step (the
    two layers' forward again under ``remat``, their and the branch layer's
    plain recompute), ms per step and peak GiB."""
    import torch

    from speechclip_tpu_torch import bench_variant_config
    from speechclip_tpu_torch.ops.attention import attention_backend

    model = _trainable_model(remat=True, base=bench_variant_config("large_par"),
                             audio_trainable=True, unfreeze_layers=LARGE_UNFREEZE)
    layers = model.audio_cfg.encoder_layers
    with attention_backend("auto"):
        state, _, step = _train_state(model)
        data = _cached_batch(model, state.params, LARGE_TRAINABLE_BATCH,
                             torch.Generator(device="cuda").manual_seed(44))
        _, _, launches, recomputes = _counted_step(step, state, data)
        del state, step
        torch.cuda.empty_cache()
        n = len(LARGE_UNFREEZE)
        expect = dict(mha_layer_block=layers + n + 1)
        say(f"phase 22 large partial fine-tune (large_par, unfreeze_layers "
            f"{list(LARGE_UNFREEZE)}, remat on, dropout 0, image cache, B="
            f"{LARGE_TRAINABLE_BATCH}): launches {launches} (expect {expect}: {layers} layers, "
            f"the {n} unfrozen again under remat, the branch), recomputes {recomputes}")
        _expect_launches("phase 22 large partial", launches, **expect)
        _expect_recomputes("phase 22 large partial", recomputes, mha_layer_block=n + 1)
        run = _timed_steps("large partial fine-tune", model, False, lambda b, params: data,
                           (LARGE_TRAINABLE_BATCH,))
    del model, data
    torch.cuda.empty_cache()
    return dict(run, launches=launches, recomputes=recomputes)


def phase_trainable(smi, phase16_pallas):
    """Phase 22, the trainable encoder and towers: (a) the full fine-tune
    at HuBERT dropout 0 on the kernel path against the plain path (phase
    16's limits, gradient cosines of the conv front end, ``pos_conv`` and
    each HuBERT layer; 13 + 13 launches and recomputes); (b) ``unfreeze_layers``
    and ``reinit_layers``; (c) ms per step and peak GiB of the full
    fine-tune (kernel and plain path), of it at HuBERT's dropout 0.1 with
    ``remat`` off and on, and of ``unfreeze_layers`` with the image cache;
    the kernel path again at the plain path's batch where that is smaller;
    (d) the trainable towers; (e) the large partial fine-tune. -> the
    summary's ``trainable`` object."""
    import torch

    out = {"device": smi}
    t0 = time.perf_counter()
    batch = _train_batch(TRAINABLE_BATCH, torch.Generator(device="cuda").manual_seed(40))
    model = _trainable_model(audio_trainable=True)
    layers = model.audio_cfg.encoder_layers
    groups = ["hubert conv front end", "hubert pos_conv"] + [
        f"hubert layer {i}" for i in range(layers)]
    launches, recomputes, cos = _trainable_agreement(
        "full fine-tune", model, batch, "auto",
        dict(mha_layer_block=layers + 1, ffn_block=layers + 1),
        dict(mha_layer_block=layers + 1, ffn_block=layers + 1), groups)
    out["full"] = dict(launches=launches, recomputes=recomputes, cosines=cos)
    del model
    torch.cuda.empty_cache()

    out.update(_selected_layers(batch, dict(mha_layer_block=len(TRAINABLE_UNFREEZE) + 1,
                                            ffn_block=len(TRAINABLE_UNFREEZE) + 1)))
    out["towers"] = _towers(batch, phase16_pallas)
    del batch
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(41)
    full_batch = lambda b, params: _train_batch(b, gen)
    timed = {}
    from speechclip_tpu_torch.ops.attention import attention_backend

    with attention_backend("auto"):
        model = _trainable_model(audio_trainable=True)
        kernel = timed["full fine-tune dropout 0, kernel path"] = _timed_steps(
            "full fine-tune dropout 0, kernel path", model, False, full_batch)
        plain = timed["full fine-tune dropout 0, plain path"] = _timed_steps(
            "full fine-tune dropout 0, plain path", model, True, full_batch)
        if plain["batch"] < kernel["batch"]:  # the two paths at one batch, in this run
            label = f"full fine-tune dropout 0, kernel path at B={plain['batch']}"
            timed[label] = _timed_steps(label, model, False, full_batch, (plain["batch"],))
        for remat in (False, True):
            label = f"full fine-tune dropout 0.1, remat {'on' if remat else 'off'}"
            model = _trainable_model(hubert_dropout=0.1, remat=remat, audio_trainable=True)
            timed[label] = _timed_steps(label, model, False, full_batch)
        model = _trainable_model(audio_trainable=True, unfreeze_layers=TRAINABLE_UNFREEZE)
        label = f"unfreeze_layers {list(TRAINABLE_UNFREEZE)}, image cache"
        timed[label] = _timed_steps(label, model, False,
                                    lambda b, params: _cached_batch(model, params, b, gen))
        del model
    torch.cuda.empty_cache()
    out["timed"] = timed
    out["large partial"] = _large_partial(smi)
    out["wall_s"] = time.perf_counter() - t0
    say(f"phase 22 trainable encoder and towers: wall {out['wall_s']:.1f} s on {smi}")
    return out


# kernel -> (source, the TPU kernel it replaces, the phase-2 row whose
# times and bound it reports, the path whose launches it reports)
SERVING_BUCKETS = (102400, 272000)  # 6.4 s (bench.py's serving bucket) and 17 s
SERVING_BATCH = 32  # bench.py serving_throughput: a fixed device batch of 32,
SERVING_WAIT_MS = 60.0  # 60 ms coalescing, bf16 weights, int16 wav on the wire
SERVING_REQUESTS, SERVING_CONCURRENCY = 256, 64
SERVING_DRIVES = 3  # timed drives, after one untimed drive of half the requests
SERVING_LONG = (32, 12.0, 17.0)  # the 17 s drive: requests, their shortest and longest s
SERVING_CHECKED = 8  # served answers per bucket held to the plain path
# the JAX package's flagship_config() as a run's config tree (both branches,
# full CLIP vocabulary, random towers), with bench.py's conv chunk for B = 32
FLAGSHIP_TREE = {
    "model_settings": {
        "cascaded_objective_weight": 1.0, "parallel_objective_weight": 1.0,
        "parallel_branch": {
            "transformer_type": "TransformerEncoder",
            "transformer_args": {"n_layers": 1, "d_model": 768, "nhead": 8,
                                 "dim_feedforward": 3072, "dropout": 0.1, "activation": "gelu",
                                 "layer_norm_eps": 1e-5, "batch_first": True,
                                 "norm_first": False},
            "need_projection": True},
        "cascaded_branch": {
            "type": "KW_CascadedBranch", "transformer_type": "MultiheadAttentionAndNorm",
            "transformer_args": {"n_layers": 1, "d_model": 768, "nhead": 1,
                                 "dim_feedforward": 3072, "dropout": 0.1},
            "keyword": {"number": 8, "batchnorms": {"type": "eachKw", "std_scale": 1.0,
                                                    "learnable": True, "parallel": True}},
            "vq": {"type": "SimpleVectorQuantizer",
                   "args": {"temp": "fixed=0.1", "time_first": True, "use_gumbel": False,
                            "hard": True}}}},
    "cl_loss": {"type": "MaskedContrastiveLoss",
                "args": {"temperature": 0.07, "temperature_trainable": False}},
    "retrieval": {"audio_feat_src": "parallel", "recall_at": [1, 5, 10]},
    "clip": {"name": "ViT-B/32", "image_encoder_trainable": False,
             "text_encoder_trainable": False},
    "audio_encoder": {
        "type": "FairseqHubert", "name": "hubert", "pretrained": False, "trainable": False,
        "feat_select_idx": "weighted_sum", "layer_drop": 0.0, "max_audio_len": 102400,
        "normalize_hiddenstates": False, "conv_batch_chunk": SERVING_BATCH,
        "optim": {"name": "Adam", "args": {"lr": 1e-4, "weight_decay": 1e-6}},
        "scheduler": {"name": "linear_warmup_decay", "warmup": 5000, "max_step": 50000,
                      "final_lr": 1e-8}},
    "trainer": {"precision": 16, "gradient_clip_val": 4, "checkpoint_frozen": False},
}


def _serving_checkpoint(root):
    """The seeded flagship train state written as a slim run checkpoint
    (``<root>/ckpts/last``, ``config.yaml`` beside it); -> its path."""
    import os

    import torch

    from speechclip_tpu_torch import flagship_config
    from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
    from speechclip_tpu_torch.training.checkpoint import CheckpointManager
    from speechclip_tpu_torch.training.train_step import create_train_state

    tree = ConfigTree(FLAGSHIP_TREE)
    cfg = model_config_from_tree(tree)
    flagship = flagship_config()
    want = dataclasses.replace(flagship, audio=dataclasses.replace(
        flagship.audio, conv_batch_chunk=SERVING_BATCH))
    if cfg != want:
        fail("phase 23: the serving config tree does not read as flagship_config()")
    model = SpeechCLIPModel(cfg)
    state = create_train_state(model, seed=0)
    mgr = CheckpointManager(os.path.join(root, "ckpts"),
                            slim_mask=model.trainable_mask(state.params))
    mgr.save(state, 0, {}, tree)
    del model, state
    torch.cuda.empty_cache()
    return os.path.join(root, "ckpts", "last")


def _served_vs_plain(label, service, bucket, wavs, expect):
    """Serve ``wavs`` (distinct lengths) as concurrent requests through the
    bucket's batcher, recording each dispatched batch; then hold every
    served answer to ``encode_speech(plain=True)`` of the batch it was
    padded into, on the service's own (cast) params: the parallel feature's
    cosine, the keyword ids (from each answer's VQ'd keywords), the
    cascaded feature on the rows whose ids all agree; and the launches of
    each batch against ``expect``."""
    import threading

    import torch

    from speechclip_tpu_torch.models import branches

    enc = bucket["exported"]
    model = enc._model
    params, state = enc._captures
    table = params["clip"]["text"]["token_embedding"]
    call, dispatched = enc.call, []

    def record(*args, device=None):
        before = {n: f.launches for n, f in _counters().items()}
        out = call(*args, device=device)
        torch.cuda.synchronize()
        dispatched.append((args, {n: f.launches - before[n] for n, f in _counters().items()}))
        return out

    answers = [None] * len(wavs)

    def client(i):
        answers[i] = service.encode_speech(wavs[i])

    enc.call = record
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(wavs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        enc.call = call
    if any(a is None for a in answers):
        fail(f"phase 23 {label}: a request got no answer")
    rows = {}
    for d, ((wav_arr, wav_len), launches) in enumerate(dispatched):
        if {n: k for n, k in launches.items() if k} != expect:
            fail(f"phase 23 {label}: a batch launched {launches}, expected {expect}")
        for r, n in enumerate(wav_len.tolist()):
            rows.setdefault(n, (d, r))
    plain = []
    with torch.inference_mode():
        for wav_arr, wav_len in (args for args, _ in dispatched):
            out = model.encode_speech(params, state, torch.from_numpy(wav_arr).cuda(),
                                      torch.from_numpy(wav_len).cuda(), plain=True)
            plain.append({k: out[k].float() for k in ("parallel_audio_feat",
                                                      "cascaded_audio_feat", "keywords")})
    ids = lambda kw: branches.cosine_scores(kw, table).argmax(-1)
    par, cas, agree, full_rows = [], [], 0, 0
    for wav, ans in zip(wavs, answers):
        d, r = rows[min(len(wav), bucket["wav_samples"])]
        ref = {k: v[r] for k, v in plain[d].items()}
        got = {k: torch.from_numpy(ans[k]).cuda() for k in ref}
        cos = lambda k: float(torch.nn.functional.cosine_similarity(got[k], ref[k], dim=0))
        par.append(cos("parallel_audio_feat"))
        same = ids(got["keywords"][None]) == ids(ref["keywords"][None])
        agree += int(same.sum())
        if bool(same.all()):
            full_rows += 1
            cas.append(cos("cascaded_audio_feat"))
    k = model.keyword_num
    share = agree / (k * len(wavs))
    check = {"batches": len(dispatched), "parallel_min_cosine": min(par),
             "keyword_id_share": share, "rows_all_ids": full_rows,
             "cascaded_min_cosine": min(cas) if cas else None}
    say(f"phase 23 {label}: {len(wavs)} concurrent requests -> {len(dispatched)} batch(es) of "
        f"{SERVING_BATCH} (launches per batch {expect}); served vs plain on the same padded "
        f"rows and cast params: parallel min cosine {min(par):.6f} (tol {MIN_COSINE}), keyword "
        f"ids agreeing {share:.4f} of {k * len(wavs)} (tol {MIN_KEYWORD_AGREEMENT}), cascaded "
        f"min cosine {check['cascaded_min_cosine']} on the {full_rows} rows whose ids all "
        f"agree (tol {MIN_COSINE})")
    if min(par) < MIN_COSINE or share < MIN_KEYWORD_AGREEMENT or (cas and min(cas) < MIN_COSINE):
        fail(f"phase 23 {label}: served answers disagree with the plain path")
    return check


def _http_checks(service, smi_root):
    """Every endpoint of ``make_http_server`` on a thread, each answer held
    to the direct call; a malformed payload must answer 400, and nothing
    may answer 500."""
    import http.client
    import io
    import os
    import threading

    import numpy as np

    from speechclip_tpu_torch.serving import make_http_server

    server = make_http_server(service, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    addr = server.server_address
    statuses = {}

    def post(path, body=b"", method="POST", expect=200):
        conn = http.client.HTTPConnection(*addr, timeout=120)
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
        statuses.setdefault(f"{method} {path.split('?')[0]}", []).append(resp.status)
        if resp.status != expect:
            fail(f"phase 23 http: {method} {path} answered {resp.status} ({out}), "
                 f"expected {expect}")
        return out

    def npy(arr):
        buf = io.BytesIO()
        np.save(buf, arr)
        return buf.getvalue()

    def cos(a, b):
        a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
        return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))

    worst = 1.0
    try:
        rng = np.random.default_rng(23)
        wav = (rng.standard_normal(80000) * 0.1).astype(np.float32)
        pcm = (wav * 32767).astype(np.int16)
        for payload in (wav, pcm):
            got = post("/encode_speech", npy(payload))["features"]
            want = service.encode_speech(payload)
            for key in ("parallel_audio_feat", "cascaded_audio_feat"):
                worst = min(worst, cos(got[key], want[key]))
        images = [rng.integers(0, 256, (256, 320, 3), dtype=np.uint8) for _ in range(4)]
        try:
            from PIL import Image

            def image_payload(img):
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="JPEG", quality=95)
                return buf.getvalue()
            image_form = "JPEG"
        except ImportError:
            image_payload, image_form = npy, "npy uint8"
        for i, img in enumerate(images):
            payload = image_payload(img)
            post(f"/gallery/add?id=img{i}", payload)
            direct = service.encode_image(payload if image_form == "JPEG" else img)
            worst = min(worst, cos(service._gallery_feats[-1], direct))
        hits = post("/retrieve?k=5", npy(wav))["results"]
        want_hits = service.retrieve(wav, k=5)
        if [h["id"] for h in hits] != [h["id"] for h in want_hits] or len(hits) != 4:
            fail(f"phase 23 http: /retrieve {hits} against the direct call's {want_hits}")
        model = service._exported["encode_text"]._model
        ids = [model.sot_id, 5, 6, 7, model.eot_id]
        got = post("/encode_text", json.dumps({"token_ids": ids,
                                               "eot_position": 4}).encode())["features"]
        worst = min(worst, cos(got["text_feat"], service.encode_text(np.asarray(ids), 4)))
        service.gallery_path = os.path.join(smi_root, "gallery.npz")
        if post("/gallery/save")["saved"] != 4 or post("/gallery/load")["loaded"] != 4:
            fail("phase 23 http: the gallery did not save and load its 4 rows")
        if [h["id"] for h in post("/retrieve?k=5", npy(wav))["results"]] != [
                h["id"] for h in want_hits]:
            fail("phase 23 http: retrieval changed across a gallery save and load")
        health = post("/healthz", method="GET")
        if health["status"] != "ok" or health["gallery_size"] != 4:
            fail(f"phase 23 http: /healthz {health}")
        post("/encode_speech", b"not an npy", expect=400)
    finally:
        server.shutdown()
        server.server_close()
    if worst < MIN_COSINE:
        fail(f"phase 23 http: an answer disagrees with the direct call (cosine {worst})")
    return {"statuses": statuses, "image_form": image_form, "min_cosine_vs_direct": worst}


@contextlib.contextmanager
def _worker_split(service, bucket, rec):
    """While open, record each of ``bucket``'s dispatches on the worker
    thread: its start (host clock), rows, the whole dispatch's ms (packing
    the int16 rows, padding, the encoder call) and the encoder call's host
    ms (the H2D copy and the launches; the card runs on)."""
    dispatch, enc = service._speech_dispatch, bucket["exported"]
    call = enc.call

    def timed_call(*args, device=None):
        t0 = time.perf_counter()
        out = call(*args, device=device)
        rec["call_ms"].append(1e3 * (time.perf_counter() - t0))
        return out

    def timed_dispatch(wavs, b, device=None):
        t0 = time.perf_counter()
        out = dispatch(wavs, b, device)
        if b is bucket:
            rec["start"].append(t0)
            rec["rows"].append(len(wavs))
            rec["dispatch_ms"].append(1e3 * (time.perf_counter() - t0))
        return out

    service._speech_dispatch, enc.call = timed_dispatch, timed_call
    try:
        yield
    finally:
        del service._speech_dispatch
        enc.call = call


def _split_summary(rec):
    """Medians of a batch's worker cycle (one dispatch's start to the next,
    within a drive), its dispatch, packing and encoder call, and rows."""
    import numpy as np

    cycles = [b - a for a, b in zip(rec["start"], rec["start"][1:]) if b - a < 1.0]
    med = lambda xs: float(np.median(xs)) if xs else None
    return {"cycle_ms": med([1e3 * c for c in cycles]), "dispatch_ms": med(rec["dispatch_ms"]),
            "pack_ms": med([d - c for d, c in zip(rec["dispatch_ms"], rec["call_ms"])]),
            "call_host_ms": med(rec["call_ms"]), "rows": med(rec["rows"]),
            "batches": len(rec["rows"])}


def _serving_wavs():
    """bench.py's pool (8 wavs of 3.2-6.4 s) and the 17 s drive's wavs, from
    one seed."""
    import numpy as np

    rng = np.random.default_rng(0)
    pool = [rng.standard_normal(n).astype(np.float32)
            for n in np.linspace(WAV_SAMPLES // 2, WAV_SAMPLES, 8).astype(int)]
    n_long, lo, hi = SERVING_LONG
    long_wavs = [rng.standard_normal(n).astype(np.float32) * 0.1
                 for n in np.linspace(lo * TRAINER_SR, hi * TRAINER_SR, n_long).astype(int)]
    return pool, long_wavs


def _serving_drives(service, pool, long_wavs):
    """The serving drives of phases 23 and 26 on a service with a 6.4 s and
    a 17 s bucket: an untimed half drive, then SERVING_DRIVES timed drives
    of SERVING_REQUESTS at SERVING_CONCURRENCY over ``pool`` (the worker's
    split recorded), then the 17 s drive; each bucket's launch counts set
    to 0 before its drives and read after. -> the rates, latencies,
    launches and batches."""
    import torch

    from speechclip_tpu_torch.serving import drive_requests

    short, long = service._speech_buckets
    counters = _counters()
    drive_requests(service, pool, SERVING_REQUESTS // 2, SERVING_CONCURRENCY)
    batches0 = short["batcher"].batches_run
    _reset(counters)
    rates, latencies = [], []
    split = {"start": [], "rows": [], "dispatch_ms": [], "call_ms": []}
    with _worker_split(service, short, split):
        for _ in range(SERVING_DRIVES):
            elapsed, lat = drive_requests(service, pool, SERVING_REQUESTS, SERVING_CONCURRENCY)
            rates.append(SERVING_REQUESTS / elapsed)
            latencies += lat
    torch.cuda.synchronize()
    out = {"rates": rates, "latencies": latencies, "split": _split_summary(split),
           "short_launches": {n: f.launches for n, f in counters.items()},
           "short_batches": short["batcher"].batches_run - batches0}
    batches0 = long["batcher"].batches_run
    _reset(counters)
    out["long_elapsed"], out["long_lat"] = drive_requests(service, long_wavs, len(long_wavs),
                                                          len(long_wavs))
    torch.cuda.synchronize()
    out["long_launches"] = {n: f.launches for n, f in counters.items()}
    out["long_batches"] = long["batcher"].batches_run - batches0
    return out


def _expect_drive_launches(label, drives, short, long, expect):
    """Each bucket's launches in ``_serving_drives`` equal ``expect`` (per
    batch, by wav length) times its batches."""
    for launches, batches, bucket in ((drives["short_launches"], drives["short_batches"], short),
                                      (drives["long_launches"], drives["long_batches"], long)):
        want = {n: k * batches for n, k in expect[bucket["wav_samples"]].items()}
        _expect_launches(f"{label} {bucket['wav_samples']}-sample bucket", launches, **want)


def phase_serving(smi):
    """Phase 23: serve the seeded flagship checkpoint at bench.py's b32
    serving point through ``EncoderService.from_checkpoint``: utt/s and
    latency on the 6.4 s bucket, a 17 s drive, the served answers against
    the plain path, launches per batch, no plain version on the card, the
    HTTP front."""
    import tempfile

    import numpy as np
    import torch

    from speechclip_tpu_torch.models.hubert import conv_output_length
    from speechclip_tpu_torch.ops.attention import attention_route
    from speechclip_tpu_torch.serving import EncoderService

    t_phase = time.perf_counter()
    rec = {"plain_on_cuda": []}
    with tempfile.TemporaryDirectory() as root:
        ckpt = _serving_checkpoint(root)
        t0 = time.perf_counter()
        service = EncoderService.from_checkpoint(
            ckpt, wav_buckets=SERVING_BUCKETS, batch=SERVING_BATCH, dtype="bf16",
            compact_wav=True, fixed_batch=True, max_wait_ms=SERVING_WAIT_MS)
        restore_s = time.perf_counter() - t0
        try:
            t0 = time.perf_counter()
            service.warmup()
            torch.cuda.synchronize()
            warmup_s = time.perf_counter() - t0
            model = service._speech_buckets[0]["exported"]._model
            short, long = service._speech_buckets
            expect = {b["wav_samples"]: _expected_launches(model, SERVING_BATCH,
                                                           b["wav_samples"], False)
                      for b in (short, long)}
            heads = {}  # the cascaded head's attention route from the route table
            for b in (short, long):
                t = conv_output_length(model.audio_cfg, b["wav_samples"])
                cb = model.config.cascaded_branch
                heads[t] = attention_route(SERVING_BATCH, cb.keyword_number + t,
                                           cb.keyword_number + t, cb.d_model, cb.nhead, 2)
            pool, long_wavs = _serving_wavs()
            n_long, lo, hi = SERVING_LONG
            with _plain_guard(rec):
                drives = _serving_drives(service, pool, long_wavs)
                http = _http_checks(service, root)
            rates, latencies, split = drives["rates"], drives["latencies"], drives["split"]
            short_launches, short_batches = drives["short_launches"], drives["short_batches"]
            long_launches, long_batches = drives["long_launches"], drives["long_batches"]
            elapsed, long_lat = drives["long_elapsed"], drives["long_lat"]
            _expect_drive_launches("phase 23", drives, short, long, expect)
            if rec["plain_on_cuda"]:
                fail(f"phase 23: plain kernel versions ran on CUDA tensors: "
                     f"{sorted(set(rec['plain_on_cuda']))}")
            checks = {
                "6.4s": _served_vs_plain("6.4 s bucket", service, short, pool,
                                         expect[short["wav_samples"]]),
                "17s": _served_vs_plain("17 s bucket", service, long, long_wavs[-SERVING_CHECKED:],
                                        expect[long["wav_samples"]]),
            }
            # one full batch of the pool through the bucket's encoder call
            # (H2D of the int16 rows + the forward), as the worker makes it:
            # alone (host launch path included) and 4 back to back (the card)
            wav_arr = np.zeros((SERVING_BATCH, WAV_SAMPLES), np.int16)
            wav_len = np.empty((SERVING_BATCH,), np.int32)
            for i in range(SERVING_BATCH):
                w = pool[i % len(pool)]
                wav_arr[i, : len(w)] = np.clip(np.round(w * 32768.0), -32768, 32767)
                wav_len[i] = len(w)
            with torch.inference_mode():
                batch_ms = {calls: cuda_time_ms(lambda: short["exported"].call(wav_arr, wav_len),
                                                reps=5, warmup=1, calls=calls)
                            for calls in (1, 4)}
        finally:
            service.close()
    served_ms = 1e3 * SERVING_REQUESTS / max(rates) / (short_batches / SERVING_DRIVES)
    lat_ms = np.asarray(latencies) * 1e3
    out = {
        "config": "flagship_config() (both branches), seeded random weights, slim run checkpoint",
        "buckets": list(SERVING_BUCKETS), "batch": SERVING_BATCH, "fixed_batch": True,
        "dtype": "bf16", "compact_wav": True, "max_wait_ms": SERVING_WAIT_MS,
        "requests": SERVING_REQUESTS, "concurrency": SERVING_CONCURRENCY,
        "utt_per_s": max(rates), "utt_per_s_range": [min(rates), max(rates)],
        "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
        "batches": short_batches, "launches": short_launches,
        "long_utt_per_s": n_long / elapsed, "long_batches": long_batches,
        "long_launches": long_launches,
        "long_p50_ms": float(np.percentile(np.asarray(long_lat) * 1e3, 50)),
        "cascaded_head_route": {str(t): r for t, r in heads.items()},
        "worker": split, "batch_ms_served": served_ms, "batch_ms_alone": batch_ms[1],
        "batch_ms_back_to_back": batch_ms[4],
        "restore_s": restore_s, "warmup_s": warmup_s, "checks": checks, "http": http,
        "card": smi,
    }
    say(f"phase 23 serving (flagship_config(), slim checkpoint via EncoderService.from_checkpoint, "
        f"buckets {SERVING_BUCKETS}, fixed batch {SERVING_BATCH}, bf16 weights, int16 wav, "
        f"{SERVING_WAIT_MS:g} ms coalescing) on {smi}: {SERVING_REQUESTS} requests at "
        f"concurrency {SERVING_CONCURRENCY} over 8 wavs of 3.2-6.4 s: best "
        f"{out['utt_per_s']:.2f} utt/s of {SERVING_DRIVES} drives [{min(rates):.2f}, "
        f"{max(rates):.2f}] after an untimed half drive, latency p50 {out['p50_ms']:.1f} ms "
        f"p99 {out['p99_ms']:.1f} ms, {short_batches} batches, launches {short_launches}; "
        f"17 s: {n_long} requests of {lo:g}-{hi:g} s -> {long_batches} batch(es), "
        f"{out['long_utt_per_s']:.2f} utt/s, launches {long_launches}; a 6.4 s batch: "
        f"{served_ms:.3f} ms of served wall at the best drive, its encoder call {batch_ms[1]:.3f} "
        f"ms alone and {batch_ms[4]:.3f} ms back to back (CUDA events); the worker's median "
        f"batch (host clock, {split['batches']} batches of median {split['rows']:g} rows): a "
        f"cycle of {split['cycle_ms']:.3f} ms, its dispatch {split['dispatch_ms']:.3f} (packing "
        f"{split['pack_ms']:.3f}, the encoder call's host side {split['call_host_ms']:.3f}); "
        f"the cascaded head (K + T "
        f"rows, one head) routes at T = {', '.join(f'{t}: {r}' for t, r in heads.items())} "
        f"(sdpa: sdpa_plain, no kernel); restore "
        f"{restore_s:.1f} s, warmup {warmup_s:.1f} s; http {http['statuses']} "
        f"({http['image_form']} images); no plain kernel on a CUDA tensor; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out, {"serving 6.4s": short_launches, "serving 17s": long_launches}


# ---------------------------------------------------------------------------
# phase 26: export and the artifact backend
# ---------------------------------------------------------------------------
ARTIFACT_POLY_BATCHES = (1, 3, 32)  # the polymorphic artifact's batches
ARTIFACT_TEXT_BATCH = 32
ARTIFACT_MIN_COSINE = 0.99999  # per row, an artifact's features against the direct call
# The loader of the artifacts: one fresh process each (``export.load_program``
# imports the kernels' op registrations and nothing of the model code), one
# call on zeros of the program's input shapes (a polymorphic batch at 2);
# prints the graph's kernel nodes, the call's launches, the load seconds and
# the port's modules under ``models`` that the process imported.
ARTIFACT_LOADER = """
import importlib, json, sys, time
t0 = time.perf_counter()
import torch
from speechclip_tpu_torch.export import kernel_nodes, load_program
program = load_program(sys.argv[1])
load_s = time.perf_counter() - t0
args = []
for node in program.graph.nodes:
    if node.op == "placeholder" and node.name in program.graph_signature.user_inputs:
        val = node.meta["val"]
        shape = [d if isinstance(d, int) else 2 for d in val.shape]
        args.append(torch.zeros(shape, dtype=val.dtype, device="cuda"))
if len(args) == 2 and args[0].dim() == 2 and args[1].dim() == 1 and args[0].shape[1] > 77:
    args[1].fill_(args[0].shape[1])  # speech: full-length rows
with torch.inference_mode():
    program.module()(*args)
torch.cuda.synchronize()
mods = {"mha_layer_block": "mha_block", "ffn_block": "ffn_block",
        "attention_vmem": "attention_vmem", "flash_attention": "flash_attention",
        "fused_conv_chain": "conv_frontend", "pos_conv": "pos_conv"}
launches = {}
for name, mod in mods.items():
    m = sys.modules.get("speechclip_tpu_torch.kernels." + mod)
    launches[name] = getattr(m, name).launches if m else 0
print(json.dumps({"nodes": kernel_nodes(program), "launches": launches, "load_s": load_s,
                  "models": sorted(m for m in sys.modules
                                   if m.startswith("speechclip_tpu_torch.models"))}))
"""


def _nonzero(counts):
    return {n: k for n, k in counts.items() if k}


def _export_cli(ckpt, out):
    """``python -m speechclip_tpu_torch.export`` in a subprocess at phase
    23's serving point; -> {artifact stem: {"mb", "export_s"}} from its
    lines, and the command's wall seconds."""
    cmd = [sys.executable, "-m", "speechclip_tpu_torch.export", "--ckpt", ckpt, "--out", out,
           "--batch", str(SERVING_BATCH), "--wav-samples", *map(str, SERVING_BUCKETS),
           "--dtype", "bf16", "--compact-wav"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"phase 26: the export CLI failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    written = {}
    for m in re.finditer(r"wrote (\S+) \(([\d.]+) MB, exported in ([\d.]+) s", proc.stdout):
        written[os.path.basename(m.group(1))[:-4]] = {"mb": float(m.group(2)),
                                                       "export_s": float(m.group(3))}
    return written, wall, " ".join(cmd[1:])


def _start_fresh_loads(paths):
    """Start one fresh process per artifact (all together) that loads it
    and calls it once (ARTIFACT_LOADER); -> {path: process}."""
    return {p: subprocess.Popen([sys.executable, "-c", ARTIFACT_LOADER, p],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for p in paths}


def _finish_fresh_loads(procs):
    """Wait for ``_start_fresh_loads``' processes; -> {path: the loader's
    JSON}."""
    out = {}
    for p, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for other in procs.values():
                other.kill()
            fail(f"phase 26: loading {p} in a fresh process did not finish in 600 s")
        if proc.returncode != 0:
            fail(f"phase 26: loading {p} in a fresh process failed:\n{stderr[-3000:]}")
        out[p] = json.loads(stdout.strip().splitlines()[-1])
    return out


def _feature_agreement(label, got, want, table=None, gallery=None):
    """An artifact's features against the direct call's: max abs diff and
    bitwise equality, per-row cosine (ARTIFACT_MIN_COSINE) of each feature,
    keyword ids (VQ argmax against ``table``) equal, and retrieve's top-10
    against ``gallery`` equal."""
    import torch

    from speechclip_tpu_torch import retrieve
    from speechclip_tpu_torch.models import branches

    got = got if isinstance(got, dict) else {"feat": got}
    want = want if isinstance(want, dict) else {"feat": want}
    if sorted(got) != sorted(want):
        fail(f"phase 26 {label}: outputs {sorted(got)}, the direct call's {sorted(want)}")
    out = {"max_abs_diff": max(float((got[k].float() - want[k].float()).abs().max())
                               for k in got),
           "bitwise": all(torch.equal(got[k], want[k]) for k in got)}
    feats = [k for k in got if k != "keywords"]
    out["min_cosine"] = min(row_cosine_min(got[k], want[k]) for k in feats)
    if not all(bool(torch.isfinite(got[k].float()).all()) for k in got):
        fail(f"phase 26 {label}: non-finite outputs")
    if out["min_cosine"] < ARTIFACT_MIN_COSINE:
        fail(f"phase 26 {label}: features disagree with the direct call ({out})")
    if "keywords" in got:
        ids = lambda kw: branches.cosine_scores(kw, table).argmax(-1)
        if not torch.equal(ids(got["keywords"]), ids(want["keywords"])):
            fail(f"phase 26 {label}: keyword ids differ from the direct call's")
        out["keyword_ids_equal"] = True
    if gallery is not None:
        for k in feats:
            if not torch.equal(retrieve(got[k].float(), gallery, TOPK)[1],
                               retrieve(want[k].float(), gallery, TOPK)[1]):
                fail(f"phase 26 {label}: retrieve's top-{TOPK} of {k} differs")
        out["top10_equal"] = True
    return out


def _sync_site(fn):
    """Run ``fn`` with ``torch.cuda.set_sync_debug_mode("error")``: the first
    operation that makes the host wait for the card raises; -> that
    operation's line in the innermost generated graph frame (or the port's
    frame), or None when nothing waited."""
    import traceback

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        frames = traceback.extract_tb(e.__traceback__)
        inner = [f for f in frames if f.filename.startswith("<eval_with_key")
                 or "speechclip_tpu_torch" in f.filename]
        site = inner[-1] if inner else frames[-1]
        return f"{os.path.basename(site.filename)}:{site.lineno} {(site.line or '').strip()}"
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return None


def _artifact_expect(model):
    """Each phase-26 artifact's kernel nodes (and launches a call), from
    the gates: the CLI's speech buckets and the polymorphic artifact as
    ``_expected_launches`` gives a 6.4 s / 17 s batch of 32; the image tower
    from ``_tower_launches``; the bf16 text tower's 77 causal rows none under
    "auto"; under "pallas" the speech surface's every attention and the f32
    text tower's 12 causal layers on ``flash_attention``."""
    from speechclip_tpu_torch.ops.attention import attention_backend, attention_route

    short_n = SERVING_BUCKETS[0]
    expect = {f"encode_speech@{n}": _expected_launches(model, SERVING_BATCH, n, False)
              for n in SERVING_BUCKETS}
    expect["encode_image"] = _tower_launches(model, SERVING_BATCH)
    expect["encode_text"] = {}
    text = model.clip_cfg
    with attention_backend("pallas"):
        expect["pallas_speech"] = _expected_launches(model, SERVING_BATCH, short_n, False)
        route = attention_route(ARTIFACT_TEXT_BATCH, text.context_length, text.context_length,
                                text.width, text.heads, 4, causal=True)
    expect["pallas_text"] = {route: text.layers} if route == "flash_attention" else {}
    expect["poly_speech"] = expect[f"encode_speech@{short_n}"]
    return expect


def _artifact_checks(model, params, state, paths, service, launches, out, rec):
    """Phase 26's agreement: each artifact called on seeded inputs (the
    CLI's through ``service``'s loaded programs, the API's loaded here),
    one call's launches against its expected nodes, its outputs against
    the direct call (``_feature_agreement``); the polymorphic artifact at
    ARTIFACT_POLY_BATCHES; the first host wait of an artifact call and of
    the direct call. -> (checks, the polymorphic checks, the expected
    nodes)."""
    import torch

    from speechclip_tpu_torch.export import cast_float_params, load_program
    from speechclip_tpu_torch.ops.attention import attention_backend

    expect = _artifact_expect(model)
    short_n, long_n = SERVING_BUCKETS
    p16 = cast_float_params(params, torch.bfloat16)
    table = params["clip"]["text"]["token_embedding"]
    table16 = p16["clip"]["text"]["token_embedding"]
    gen = torch.Generator(device="cuda").manual_seed(26)
    gallery = torch.nn.functional.normalize(
        torch.randn(GALLERY, model.config.clip_embed_dim, generator=gen, device="cuda"), dim=-1)
    served = {f"encode_speech@{b['wav_samples']}": b["exported"]
              for b in service._speech_buckets}
    served.update(service._exported)

    def module(stem):
        if stem in served:
            return served[stem].module()
        return load_program(paths[stem]).module()

    def int16_batch(b, samples, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        wav = (torch.randn(b, samples, generator=g, device="cuda") * 3000).to(torch.int16)
        lens = torch.randint(samples // 2, samples + 1, (b,), generator=g, device="cuda")
        return wav * (torch.arange(samples, device="cuda") < lens[:, None]), lens.int()

    def counted(stem, fn, *args):
        got, counts = _run_counted(lambda: fn(*args))
        if _nonzero(counts) != expect[stem]:
            fail(f"phase 26: {stem} launched {counts} in one call, its graph holds "
                 f"{expect[stem]}")
        return got, _nonzero(counts)

    checks = {}
    with _plain_guard(rec), torch.inference_mode():
        for stem, backend, ref, tbl in ((f"encode_speech@{short_n}", "auto", p16, table16),
                                        (f"encode_speech@{long_n}", "auto", p16, table16),
                                        ("pallas_speech", "pallas", params, table)):
            samples = long_n if stem.endswith(str(long_n)) else short_n
            wav, lens = int16_batch(SERVING_BATCH, samples, len(checks))
            got, counts = counted(stem, module(stem), wav, lens)
            with attention_backend(backend):
                want = model.encode_speech(ref, state, wav, lens)
            checks[stem] = _feature_agreement(stem, got, {k: want[k] for k in got}, tbl, gallery)
            if stem == "pallas_speech":
                launches["artifact pallas speech"] = counts
        g = torch.Generator(device="cuda").manual_seed(261)
        side = model.vision_cfg.image_size
        images = torch.randn(SERVING_BATCH, side, side, 3, generator=g, device="cuda")
        got, _ = counted("encode_image", module("encode_image"), images)
        checks["encode_image"] = _feature_agreement("encode_image", got,
                                                    model.forward_image(p16, images))
        ctx = model.clip_cfg.context_length
        ids = torch.randint(0, table.shape[0], (ARTIFACT_TEXT_BATCH, ctx), generator=g,
                            device="cuda", dtype=torch.int32)
        eot = torch.randint(1, ctx, (ARTIFACT_TEXT_BATCH,), generator=g, device="cuda",
                            dtype=torch.int32)
        for stem, backend, ref in (("encode_text", "auto", p16), ("pallas_text", "pallas", params)):
            got, counts = counted(stem, module(stem), ids, eot)
            with attention_backend(backend):
                want = model.forward_text(ref, ids.long(), eot)
            checks[stem] = _feature_agreement(stem, got, want)
            if stem == "pallas_text":
                launches["artifact pallas text"] = counts
        fn, poly = module("poly_speech"), {}
        for b in ARTIFACT_POLY_BATCHES:
            wav, lens = int16_batch(b, short_n, 100 + b)
            got, _ = counted("poly_speech", fn, wav, lens)
            want = model.encode_speech(params, state, wav, lens)
            poly[b] = _feature_agreement(f"poly_speech B={b}", got, {k: want[k] for k in got},
                                         table, gallery)
        checks["poly_speech"] = poly
        # where the host first waits for the card: an artifact call, and the
        # direct call it replaces
        fn = module(f"encode_speech@{short_n}")
        wav, lens = int16_batch(SERVING_BATCH, short_n, 7)
        out["host_wait"] = {
            "artifact": _sync_site(lambda: fn(wav, lens)),
            "direct": _sync_site(lambda: model.encode_speech(p16, state, wav, lens))}
    out["checks"] = checks
    if rec["plain_on_cuda"]:
        fail(f"phase 26: plain kernel versions ran on CUDA tensors: "
             f"{sorted(set(rec['plain_on_cuda']))}")
    return checks, poly, expect


def phase_export(smi, serving23):
    """Phase 26: export phase 23's seeded flagship serving checkpoint with
    the CLI (6.4 s and 17 s at a fixed batch of 32, bf16 weights, int16
    wav) and, through the Python API, ``encode_speech`` at 6.4 s and
    ``encode_text`` under "pallas" and a polymorphic ``encode_speech``; load
    each in a fresh process (no model code imported); hold each graph's
    kernel nodes to ``_expected_launches`` and its runtime launches to the
    nodes times the calls; hold the artifacts to the direct calls; serve
    the CLI's artifacts at phase 23's settings. -> (the ``export`` object,
    launches by artifact path)."""
    import numpy as np
    import torch

    from speechclip_tpu_torch.export import export_encode_speech, export_encode_text
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
    from speechclip_tpu_torch.ops.attention import attention_backend
    from speechclip_tpu_torch.serving import EncoderService
    from speechclip_tpu_torch.training.checkpoint import load_any_checkpoint

    t_phase = time.perf_counter()
    rec = {"plain_on_cuda": []}
    launches = {}
    out = {"card": smi, "artifacts": {}}
    with tempfile.TemporaryDirectory() as root:
        ckpt = _serving_checkpoint(root)
        cli_dir, api_dir = os.path.join(root, "exports"), os.path.join(root, "api")
        os.makedirs(api_dir)
        written, cli_wall, cli_cmd = _export_cli(ckpt, cli_dir)
        out["cli"] = {"command": cli_cmd, "wall_s": cli_wall}
        model, params, state = load_any_checkpoint(ckpt)
        cfg = model.config
        poly_model = SpeechCLIPModel(dataclasses.replace(cfg, audio=dataclasses.replace(
            cfg.audio, conv_batch_chunk=0)))
        api = {  # stem -> (export call, backend)
            "pallas_speech": (lambda: export_encode_speech(
                model, params, state, SERVING_BATCH, WAV_SAMPLES, compact_wav=True), "pallas"),
            "pallas_text": (lambda: export_encode_text(model, params, ARTIFACT_TEXT_BATCH),
                            "pallas"),
            "poly_speech": (lambda: export_encode_speech(
                poly_model, params, state, SERVING_BATCH, WAV_SAMPLES, polymorphic_batch=True,
                compact_wav=True), "auto"),
        }
        for stem, (job, backend) in api.items():
            t0 = time.perf_counter()
            with attention_backend(backend):
                blob = job()
            written[stem] = {"mb": len(blob) / 1e6, "export_s": time.perf_counter() - t0}
            with open(os.path.join(api_dir, stem + ".pt2"), "wb") as f:
                f.write(blob)
            del blob
        del poly_model
        paths = {stem: os.path.join(cli_dir if "@" in stem or stem.startswith("encode_")
                                    else api_dir, stem + ".pt2") for stem in written}
        # the fresh processes load while this one checks the artifacts
        t_fresh = time.perf_counter()
        loaders, service = _start_fresh_loads(list(paths.values())), None
        try:
            t0 = time.perf_counter()
            service = EncoderService(cli_dir, max_wait_ms=SERVING_WAIT_MS)
            load_s = time.perf_counter() - t0
            checks, poly, expect = _artifact_checks(model, params, state, paths, service, launches,
                                                    out, rec)
            fresh = _finish_fresh_loads(loaders)
            out["fresh_load_wall_s"] = time.perf_counter() - t_fresh
            for stem, path in paths.items():
                got = fresh[path]
                if got["models"]:
                    fail(f"phase 26: loading {stem} imported the model code {got['models']}")
                # pos_conv's node is not among the launch counts the gates give
                # (``_counters``): one a speech graph where its kernel takes HuBERT
                nodes = {n: k for n, k in got["nodes"].items() if n != "pos_conv"}
                want_pos_conv = int(stem.endswith("speech") or stem.startswith("encode_speech"))
                if nodes != expect[stem] or got["nodes"].get("pos_conv", 0) != want_pos_conv:
                    fail(f"phase 26: {stem}'s graph holds kernel nodes {got['nodes']}, the "
                         f"gates give {expect[stem]} and {want_pos_conv} pos_conv")
                if _nonzero(got["launches"]) != got["nodes"]:
                    fail(f"phase 26: {stem}'s call in the fresh process launched "
                         f"{got['launches']}, its graph holds {got['nodes']}")
                out["artifacts"][stem] = dict(written[stem], nodes=got["nodes"],
                                              fresh_load_s=got["load_s"])
            del model, params, state
            torch.cuda.empty_cache()

            # serving the CLI's artifacts at phase 23's settings
            short, long = service._speech_buckets
            if [b["fixed_batch"] for b in (short, long)] != [SERVING_BATCH] * 2 or [
                    b["wav_dtype"] for b in (short, long)] != [np.int16] * 2:
                fail("phase 26: the CLI's speech artifacts do not read as fixed-batch int16 "
                     "buckets")
            t0 = time.perf_counter()
            service.warmup()
            torch.cuda.synchronize()
            warmup_s = time.perf_counter() - t0
            pool, long_wavs = _serving_wavs()
            with _plain_guard(rec):
                drives = _serving_drives(service, pool, long_wavs)
            per_batch = {b["wav_samples"]: expect[f"encode_speech@{b['wav_samples']}"]
                         for b in (short, long)}
            _expect_drive_launches("phase 26", drives, short, long, per_batch)
            if rec["plain_on_cuda"]:
                fail(f"phase 26: plain kernel versions ran on CUDA tensors: "
                     f"{sorted(set(rec['plain_on_cuda']))}")
        finally:
            for proc in loaders.values():
                if proc.poll() is None:
                    proc.kill()
            if service is not None:
                service.close()
    rates, lat_ms = drives["rates"], np.asarray(drives["latencies"]) * 1e3
    out["serving"] = {
        "utt_per_s": max(rates), "utt_per_s_range": [min(rates), max(rates)],
        "p50_ms": float(np.percentile(lat_ms, 50)), "p99_ms": float(np.percentile(lat_ms, 99)),
        "batches": drives["short_batches"], "launches": drives["short_launches"],
        "long_utt_per_s": len(long_wavs) / drives["long_elapsed"],
        "long_batches": drives["long_batches"], "long_launches": drives["long_launches"],
        "worker": drives["split"], "load_s": load_s, "warmup_s": warmup_s,
        "phase23": {k: serving23[k] for k in ("utt_per_s", "utt_per_s_range", "p50_ms",
                                               "p99_ms", "long_utt_per_s")},
    }
    out["wall_s"] = time.perf_counter() - t_phase
    launches["artifact 6.4 s"] = drives["short_launches"]
    launches["artifact 17 s"] = drives["long_launches"]
    arts = ", ".join(f"{stem} {a['mb']:.1f} MB in {a['export_s']:.1f} s (nodes {a['nodes']}, "
                     f"fresh load {a['fresh_load_s']:.1f} s)" for stem, a in out["artifacts"].items())
    srv, s23 = out["serving"], out["serving"]["phase23"]
    say(f"phase 26 export (phase 23's flagship checkpoint; the CLI: {cli_cmd}, "
        f"{cli_wall:.1f} s of wall; the Python API: encode_speech 6.4 s and encode_text under "
        f"\"pallas\", a polymorphic encode_speech) on {smi}: {arts}; every artifact loaded in a "
        f"fresh process without the model code ({out['fresh_load_wall_s']:.1f} s for all, in "
        f"parallel), each graph's kernel nodes as the gates give, each call's launches its "
        f"nodes; against the direct calls: " + "; ".join(
            f"{stem} max abs {c['max_abs_diff']:.3g} (bitwise {c['bitwise']}), min row cosine "
            f"{c['min_cosine']:.6f}" for stem, c in checks.items() if stem != "poly_speech")
        + f"; polymorphic at B = {list(poly)}: bitwise {[c['bitwise'] for c in poly.values()]}; "
        f"keyword ids and top-{TOPK} equal; the host waits in an artifact call at "
        f"{out['host_wait']['artifact']!r} (the direct call at {out['host_wait']['direct']!r}); "
        f"served from the artifacts (EncoderService(artifact_dir), fixed batch {SERVING_BATCH}, "
        f"{SERVING_WAIT_MS:g} ms): best {srv['utt_per_s']:.2f} utt/s of {SERVING_DRIVES} drives "
        f"[{srv['utt_per_s_range'][0]:.2f}, {srv['utt_per_s_range'][1]:.2f}], p50 "
        f"{srv['p50_ms']:.1f} ms p99 {srv['p99_ms']:.1f} ms, {srv['batches']} batches, launches "
        f"{srv['launches']}; 17 s {srv['long_utt_per_s']:.2f} utt/s, launches "
        f"{srv['long_launches']}; beside phase 23's from_checkpoint in this run: best "
        f"{s23['utt_per_s']:.2f} utt/s [{s23['utt_per_s_range'][0]:.2f}, "
        f"{s23['utt_per_s_range'][1]:.2f}], p50 {s23['p50_ms']:.1f} ms p99 {s23['p99_ms']:.1f} "
        f"ms, 17 s {s23['long_utt_per_s']:.2f} utt/s; service load {load_s:.1f} s, warmup "
        f"{warmup_s:.1f} s; no plain kernel on a CUDA tensor; phase wall {out['wall_s']:.1f} s")
    return out, launches


# ---------------------------------------------------------------------------
# phase 24: the text side
# ---------------------------------------------------------------------------
TEXT_SIDE_CAPTIONS = 256
TEXT_SIDE_IMAGES = 32
CAPTION_WORDS = ("a", "the", "dog", "dogs", "man", "woman", "child", "girl", "boy", "people",
                 "runs", "running", "jumps", "sits", "plays", "walks", "stands", "rides",
                 "on", "in", "at", "with", "of", "and", "near", "over", "through", "across",
                 "grass", "water", "snow", "street", "field", "beach", "park", "road", "wall",
                 "red", "blue", "white", "black", "brown", "green", "small", "large", "two",
                 "three", "ball", "bike", "shirt", "hat", "camera", "building", "crowd")


def _seeded_captions(words, n: int, seed: int):
    """n captions of 4-14 words drawn from ``words`` (a sequence, or a
    mapping's keys), single-spaced."""
    import numpy as np

    words = list(words)
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, int(rng.integers(4, 15)))) for _ in range(n)]


def _table_words(tokenizer, vocab, limit: int | None = 3000):
    """Words of the reduced table (its first ``limit`` rows, all for None):
    each a word-final subword whose text tokenizes back to that one id, so
    captions made of them map onto the table (CLIP's real merges file is not
    in the repository; over the synthetic one a Flickr caption's subwords
    need not be in the table). -> {word: original id}, in table order."""
    words = {}
    for orig in vocab.selected_ids[:limit]:
        tok = tokenizer.decoder[int(orig)]
        word = tok[:-len("</w>")] if tok.endswith("</w>") else None
        if word and word.isalpha() and word == word.lower() and tokenizer.encode(word) == [
                int(orig)]:
            words[word] = int(orig)
    return words


def _text_side_check(label, clip, captions, clip_mod, attention_backend):
    """prep_text, encode_text under "pallas" (12 f32 flash_attention)
    against the plain path, deTokenize against the captions. -> (ids,
    eot, features, sequences/s)."""
    import torch

    ids, eot = clip.prep_text(captions)
    layers = clip.cfg.text.layers
    with attention_backend("pallas"):
        feats, launches = _run_counted(lambda: clip.encode_text(ids, eot))
        plain = clip_mod.encode_text(clip.params, clip.cfg.text, ids, eot, plain=True)
        rate = _rate(lambda: clip.encode_text(ids, eot), len(captions))
    scale = max(1.0, float(plain.abs().max()))
    err = float((feats - plain).abs().max()) / scale
    cos = row_cosine_min(feats, plain)
    rows = ids.shape[0]
    ends_ok = bool((ids[:, 0] == clip.sot_id).all()) and bool(
        (ids[torch.arange(rows, device=ids.device), eot] == clip.eot_id).all())
    detok = [clip.deTokenize(ids[i, :int(eot[i]) + 1])[0] for i in range(rows)]
    want = [c.lower() for c in captions]
    say(f"  {label}: {rows} captions -> ids {tuple(ids.shape)} (SOT {clip.sot_id}, EOT "
        f"{clip.eot_id}, table {clip.params['text']['token_embedding'].shape[0]} rows; first and "
        f"EOT ids in place {ends_ok}); encode_text 'pallas' launches {launches} (expect "
        f"{layers} flash_attention, f32) -> {tuple(feats.shape)} {feats.dtype}; vs plain: max "
        f"abs {err:.3e} x max(1, max|feat|) (tol {F32_TOL}), min row cosine {cos:.7f} (tol "
        f"{MIN_F32_COSINE}); deTokenize of the rows to their EOT equals the lower-cased "
        f"captions: {detok == want}; {rate:.2f} sequences/s ({RATE_NOTE})")
    _expect_launches(f"text side {label}", launches, flash_attention=layers)
    if err > F32_TOL or cos < MIN_F32_COSINE:
        fail(f"text side {label}: encode_text under 'pallas' disagrees with the plain path")
    if feats.dtype != torch.float32 or not bool(torch.isfinite(feats).all()) or not ends_ok:
        fail(f"text side {label}: features or ids malformed")
    if detok != want:
        bad = next(i for i, (a, b) in enumerate(zip(detok, want)) if a != b)
        fail(f"text side {label}: deTokenize row {bad} {detok[bad]!r} != {want[bad]!r}")
    return ids, eot, feats, rate


def phase_text_side(smi):
    """Phase 24: the CLIP tokenizer over the synthetic full-size merges
    file (``SPEECHCLIP_BPE_PATH``), ``ClipWrapper`` over ViT-B/32 from a
    seeded init: tokenize TEXT_SIDE_CAPTIONS captions (host ms, cold
    cache), ``prep_text`` -> ``encode_text`` under "pallas" against the
    plain path, with the full table and the reduced Flickr one (SOT / EOT
    remapped), ``get_scores`` against ``encode_image`` and ``encode_text``
    recomputed in float64, ``deTokenize``."""
    import numpy as np
    import torch

    from speechclip_tpu_torch.config import FLICKR_VOCAB
    from speechclip_tpu_torch.models import clip as clip_mod
    from speechclip_tpu_torch.models.clip_api import ClipWrapper
    from speechclip_tpu_torch.models.tokenizer import CLIPTokenizer
    from speechclip_tpu_torch.ops.attention import attention_backend

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    tok = CLIPTokenizer()
    load_s = time.perf_counter() - t0
    captions = _seeded_captions(CAPTION_WORDS, TEXT_SIDE_CAPTIONS, 24)
    t0 = time.perf_counter()
    tok.tokenize(captions)
    tokenize_ms = (time.perf_counter() - t0) * 1e3
    say(f"phase 24 text side: tokenizer over {tok.vocab_size} ids (SOT {tok.sot_id}, EOT "
        f"{tok.eot_id}) loaded in {load_s:.3f} s; tokenize {len(captions)} captions "
        f"{tokenize_ms:.3f} ms on the host (cold BPE cache)")
    if (tok.vocab_size, tok.sot_id, tok.eot_id) != (49408, 49406, 49407):
        fail("text side: the merges file does not give CLIP's id layout")
    out = {"tokenize_ms": tokenize_ms}
    clip = ClipWrapper("ViT-B/32", tokenizer=tok, seed=24)
    ids, eot, feats, out["sequences_per_s"] = _text_side_check(
        "full table", clip, captions, clip_mod, attention_backend)

    gen = torch.Generator(device="cuda").manual_seed(24)
    images = torch.randn(TEXT_SIDE_IMAGES, 224, 224, 3, generator=gen, device="cuda")
    rows = slice(0, 64)
    logits_img, logits_txt = clip.get_scores(images, ids[rows], eot[rows])
    img = clip.encode_image(images).double().cpu().numpy()
    txt = feats[rows].double().cpu().numpy()
    img /= np.linalg.norm(img, axis=-1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    want = math.exp(float(clip.params["logit_scale"])) * img @ txt.T
    err = float(np.abs(logits_img.double().cpu().numpy() - want).max()) / max(
        1.0, float(np.abs(want).max()))
    transposed = bool(torch.equal(logits_txt, logits_img.T))
    say(f"  get_scores: {TEXT_SIDE_IMAGES} seeded images x {txt.shape[0]} captions -> "
        f"{tuple(logits_img.shape)} {logits_img.dtype}; vs float64 from encode_image and "
        f"encode_text: max abs {err:.3e} x max(1, max|logit|) (tol {F32_TOL}); per text = per "
        f"image transposed: {transposed}")
    if logits_img.dtype != torch.float32 or err > F32_TOL or not transposed:
        fail("text side: get_scores disagrees with encode_image / encode_text")

    reduced = ClipWrapper("ViT-B/32", tokenizer=tok, seed=24,
                          reduce_subword_embbedding=FLICKR_VOCAB)
    table = reduced.reduced_vocab
    remapped = (reduced.sot_id, reduced.eot_id) == (table.original_to_reduced[49406],
                                                    table.original_to_reduced[49407])
    if reduced.params["text"]["token_embedding"].shape[0] != 8112 or not remapped:
        fail("text side: the reduced table is not Flickr's 8112 rows with SOT / EOT remapped")
    words = list(_table_words(tok, table))
    say(f"  reduced table: {table.size} rows, SOT / EOT -> {reduced.sot_id} / "
        f"{reduced.eot_id}; {len(words)} word-final subwords of its first 3000 rows tokenize "
        f"back to themselves")
    _, _, _, out["reduced_sequences_per_s"] = _text_side_check(
        "reduced table", reduced, _seeded_captions(words, TEXT_SIDE_CAPTIONS, 25), clip_mod,
        attention_backend)
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"phase 24 text side on {smi}: {out['sequences_per_s']:.2f} sequences/s full table, "
        f"{out['reduced_sequences_per_s']:.2f} reduced; wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 25: the s3prl upstreams
# ---------------------------------------------------------------------------
UPSTREAM_BATCH = 256
UPSTREAM_TRAIN_BATCH = 64


def _apc_config():
    """The flagship's parallel topology over the APC upstream at its own
    widths (80 mels, 3 GRU layers of 512) and a parallel branch at
    d_model 512 (8 heads, FFN 2048): the branch prepends CLS at the
    upstream's width, with no input projection."""
    from speechclip_tpu_torch import base_config
    from speechclip_tpu_torch.models.upstream import APCConfig

    base = base_config()
    return dataclasses.replace(
        base, audio=APCConfig(), audio_encoder_type="s3prl_plus",
        parallel_branch=dataclasses.replace(base.parallel_branch, d_model=512,
                                            dim_feedforward=2048))


def _gru_library(params, x):
    """cuDNN's GRU (torch.nn.GRU) with the stack's weights, in x's dtype:
    timed beside the port's step loop, used nowhere in the port."""
    import torch

    layers = params["layers"]
    h = layers[0]["w_hh"].shape[0]
    gru = torch.nn.GRU(x.shape[-1], h, num_layers=len(layers), batch_first=True).to(
        device=x.device, dtype=x.dtype)
    gru.flatten_parameters()  # the copies below land in cuDNN's one weight buffer
    with torch.no_grad():
        for i, p in enumerate(layers):
            getattr(gru, f"weight_ih_l{i}").copy_(p["w_ih"].T)
            getattr(gru, f"weight_hh_l{i}").copy_(p["w_hh"].T)
            getattr(gru, f"bias_ih_l{i}").copy_(p["b_ih"])
            getattr(gru, f"bias_hh_l{i}").copy_(p["b_hh"])
    return gru


def _below_half_ulp(x, lr: float) -> bool:
    """Whether every element of the f32 tensor ``x`` has half an ulp above
    ``lr``: an update of at most ``lr`` rounds back to it."""
    import torch

    a = x.detach().float().abs()
    return bool(((torch.nextafter(a, torch.full_like(a, float("inf"))) - a) / 2 > lr).all())


def _gru_in_encode(encode, reps: int = 5):
    """The GRU stack's share of ``encode()``, timed inside the same calls:
    CUDA events around each ``gru_layer_apply`` call of the upstream and
    around the whole encode, on one stream, so the GRU's intervals lie
    within the encode's and the share cannot exceed 1. -> (median encode
    ms, median GRU ms, median share), over ``reps`` calls after one warm-up."""
    import torch

    from speechclip_tpu_torch.models import upstream as upstream_mod

    gru, marks = upstream_mod.gru_layer_apply, []

    def timed_gru(params, x):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = gru(params, x)
        end.record()
        marks.append((start, end))
        return out

    upstream_mod.gru_layer_apply = timed_gru
    try:
        encode()
        rows = []
        for _ in range(reps):
            marks.clear()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            encode()
            end.record()
            torch.cuda.synchronize()
            total = start.elapsed_time(end)
            in_gru = sum(a.elapsed_time(b) for a, b in marks)
            rows.append((total, in_gru, in_gru / total))
    finally:
        upstream_mod.gru_layer_apply = gru
    if not marks:
        fail("upstreams: the APC encode called no GRU layer")
    return tuple(statistics.median(r[i] for r in rows) for i in range(3))


def phase_upstreams(smi):
    """Phase 25: ``audio_encoder.type: s3prl_plus``. APC (``_apc_config``)
    encode + retrieve at B = UPSTREAM_BATCH x 6.4 s against the plain path
    (phase 3's cosine limit), launches a forward against the gates, utt/s,
    the log-mel, GRU-stack and branch times (and cuDNN's GRU beside the
    step loop); one train step at B = UPSTREAM_TRAIN_BATCH: a finite loss,
    the frozen upstream unchanged, the branch and weighted sum moved;
    ``modified_cpc`` with ``feat_select_idx`` [1]: one forward at B = 64.
    -> (summary, the APC forward's launches)."""
    import torch

    from speechclip_tpu_torch import retrieve
    from speechclip_tpu_torch.models import branches
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
    from speechclip_tpu_torch.models.upstream import CPCConfig, log_mel
    from speechclip_tpu_torch.ops.basic import l2_normalize
    from speechclip_tpu_torch.ops.mlp import mlp_apply
    from speechclip_tpu_torch.training.optim import build_optimizer
    from speechclip_tpu_torch.training.train_step import create_train_state, make_train_step

    t_phase = time.perf_counter()
    cfg = _apc_config()
    model = SpeechCLIPModel(cfg)
    params, state = (cast_params(t, model.compute_dtype) for t in model.init(0))
    up, pb = model.audio_cfg, cfg.parallel_branch
    gen = torch.Generator(device="cuda").manual_seed(25)
    gallery = torch.nn.functional.normalize(
        torch.randn(GALLERY, cfg.clip_embed_dim, generator=gen, device="cuda"), dim=-1)
    wav, wav_len = _wavs(UPSTREAM_BATCH, WAV_SAMPLES, WAV_SAMPLES // 2, gen)
    wav = wav.to(model.compute_dtype)
    t = WAV_SAMPLES // up.hop_length
    expect = _encoder_layer_launches(UPSTREAM_BATCH, t + 1, pb.d_model, pb.nhead,
                                     pb.dim_feedforward)
    expect = {name: n * pb.n_layers for name, n in expect.items() if n}

    def encode(plain=False):
        feats = model.encode_speech(params, state, wav, wav_len, plain=plain)
        return feats["parallel_audio_feat"]

    feats, launches = _run_counted(encode)
    plain_feats = encode(plain=True)
    _, top = retrieve(feats, gallery, TOPK)
    _, plain_top = retrieve(plain_feats, gallery, TOPK)
    cos = row_cosine_min(feats, plain_feats)
    top1, overlap = _top_agreement(top, plain_top)
    rate = _rate(lambda: retrieve(encode(), gallery, TOPK)[1], UPSTREAM_BATCH)
    plain_rate = _rate(lambda: retrieve(encode(True), gallery, TOPK)[1], UPSTREAM_BATCH)

    ae = params["audio_encoder"]
    mel = log_mel(wav, up.n_mels, up.win_length, up.hop_length).to(wav.dtype)
    x = mel @ ae["prenet"]["w"].to(wav.dtype) + ae["prenet"]["b"].to(wav.dtype)
    with torch.no_grad():
        audio, audio_len = model.forward_audio(params, wav, wav_len)

        def branch():
            feat = branches.parallel_branch_apply(params["parallel_branch"], pb, audio, audio_len)
            feat = l2_normalize(mlp_apply(params["p_branch_proj"], feat).float()
                                if "p_branch_proj" in params else feat.float())
            return retrieve(feat, gallery, TOPK)[1]

        ms = {"log-mel": cuda_time_ms(lambda: log_mel(wav, up.n_mels, up.win_length,
                                                       up.hop_length), reps=5, warmup=1),
              "upstream": cuda_time_ms(lambda: model.upstream.apply(ae, wav, wav_len), reps=5,
                                       warmup=1),
              "branch + retrieve": cuda_time_ms(branch, reps=5, warmup=1)}
        ms["encode"], ms["GRU stack"], gru_share = _gru_in_encode(encode)
        from speechclip_tpu_torch.models.upstream import gru_layer_apply

        def stack():
            h = x
            for layer in ae["layers"]:
                h = gru_layer_apply(layer, h)
            return h

        gru = _gru_library(ae, x)
        ms["cuDNN GRU (library)"] = cuda_time_ms(lambda: gru(x), reps=5, warmup=1)
        lib_cos = row_cosine_min(gru(x)[0].flatten(0, 1), stack().flatten(0, 1))
        # the bf16 stack against an f32 one on the same weights (the CPU tests
        # hold the port to JAX at f32 1e-4 and bf16 cosine 0.999)
        f32_ae = {k: v if k != "layers" else [{n: t.float() for n, t in layer.items()}
                                                for layer in v] for k, v in ae.items()}
        states16, _ = model.upstream.apply(ae, wav[:16], wav_len[:16])
        states32, _ = model.upstream.apply(f32_ae, wav[:16].float(), wav_len[:16])
        bf16_cos = min(row_cosine_min(a.flatten(0, 1), b.flatten(0, 1))
                       for a, b in zip(states16, states32))
    say(f"phase 25 upstreams: APC (80 mels, {up.num_layers} GRU layers of "
        f"{up.encoder_embed_dim}) + parallel branch (d_model {pb.d_model}, {pb.nhead} heads, FFN "
        f"{pb.dim_feedforward}) encode_speech B={UPSTREAM_BATCH} x {WAV_SAMPLES} samples "
        f"(T={t}, +1 CLS) -> {tuple(feats.shape)}; launches {launches} (expect {expect}: "
        f"the branch layer at T={t + 1}); min row cosine vs plain {cos:.6f} (tol "
        f"{MIN_COSINE}); retrieve top-{TOPK} of {GALLERY}: top-1 agreement {top1:.4f}, "
        f"top-{TOPK} overlap {overlap:.4f}")
    say(f"  on {smi}: encode + retrieve {rate:.2f} utt/s (plain {plain_rate:.2f}; {RATE_NOTE}); "
        f"ms (CUDA-event medians of 5): {({k: round(v, 3) for k, v in ms.items()})}; the GRU "
        f"stack is {gru_share:.1%} of the encode (median of 5 encodes, each timed with its "
        f"GRU calls inside it); cuDNN's GRU on the same weights and input (not used: its f32 "
        f"gate sums differ from JAX's bf16 rounding points) min row cosine {lib_cos:.6f} "
        f"against the step loop; the bf16 GRU "
        f"states against the same stack in f32 (16 rows): min row cosine {bf16_cos:.6f}")
    if launches != {name: expect.get(name, 0) for name in launches}:
        fail(f"upstreams: APC launches {launches}, the gates give {expect}")
    if tuple(feats.shape) != (UPSTREAM_BATCH, cfg.clip_embed_dim) or not bool(
            torch.isfinite(feats).all()) or cos < MIN_COSINE:
        fail("upstreams: the APC kernel path disagrees with the plain path")
    if not math.isfinite(lib_cos) or not 0.0 < gru_share <= 1.0:
        fail(f"upstreams: cuDNN's GRU min row cosine {lib_cos}, the GRU share {gru_share}")
    out = {"apc": {"utt_per_s": rate, "plain_utt_per_s": plain_rate, "ms": ms,
                   "gru_share": gru_share, "bf16_vs_f32_min_cosine": bf16_cos,
                   "launches": launches, "min_cosine": cos, "top1": top1}}
    apc_launches = launches
    del feats, plain_feats, mel, x, gru, audio
    torch.cuda.empty_cache()

    # one train step: the frozen upstream holds, the branch and weighted sum move
    train = create_train_state(model, seed=0)
    optimizer, scheduler = build_optimizer(model.config, train.params,
                                           model.trainable_mask(train.params))
    step = make_train_step(model, optimizer, scheduler)
    b = UPSTREAM_TRAIN_BATCH
    batch = {"wav": wav[:b].float().cpu().numpy(), "wav_len": wav_len[:b].cpu().numpy(),
             "image": _uint8_images(b, 224, gen).cpu().numpy(),
             "id": (torch.arange(b) % (b // 5)).numpy()}
    from speechclip_tpu_torch.training.train_step import to_device

    before = {k: _snapshot(train.params[k])
              for k in ("audio_encoder", "parallel_branch", "weighted_sum")}
    lr = optimizer.param_groups[0]["lr"]  # this step's: the scheduler steps after it
    (train, metrics), train_launches = _run_counted(
        lambda: step(train, to_device(batch, "cuda")))
    loss = float(metrics["train_loss"])
    moved = {k: _moved(v, train.params[k]) for k, v in before.items()}
    live = dict(_leaf_paths(train.params["parallel_branch"]))
    # Adam's first update is at most lr in size: a leaf every element of
    # which has half an f32 ulp above lr cannot move in round to nearest (the
    # LayerNorm scales at 1.0 under the warm-up's first lr); each of those
    # must still hold a gradient, 10x weight decay's share of Adam's moment
    stuck = {path for path, x in before["parallel_branch"].items() if _below_half_ulp(x, lr)}
    wd, beta1 = optimizer.defaults["weight_decay"], optimizer.defaults["betas"][0]
    no_grad = sorted(
        path for path in stuck
        if not float(optimizer.state[live[path]]["exp_avg"].abs().max()) > 10 * (1 - beta1) * wd
        * float(before["parallel_branch"][path].abs().max()))
    say(f"  train step B={b}: loss {loss:.6f}, grad_norm {float(metrics['grad_norm']):.6f}, "
        f"launches {train_launches} (the branch's dropout 0.1 keeps its layer unfused); leaves "
        f"moved: upstream {len(moved['audio_encoder'])} of {len(before['audio_encoder'])}, "
        f"parallel branch {len(moved['parallel_branch'])} of "
        f"{len(before['parallel_branch'])} (lr {lr:.3e}: {sorted(stuck)} cannot move in one "
        f"step and hold a gradient in Adam's moment), weighted sum "
        f"{len(moved['weighted_sum'])} of {len(before['weighted_sum'])}")
    if not math.isfinite(loss) or moved["audio_encoder"] or moved["weighted_sum"] != set(
            before["weighted_sum"]) or moved["parallel_branch"] != set(
            before["parallel_branch"]) - stuck or no_grad:
        still = sorted(set(before["parallel_branch"]) - moved["parallel_branch"] - stuck)
        fail(f"upstreams: the APC train step trained the frozen upstream or not the branch "
             f"(branch leaves that should move and did not: {still}; without a gradient: "
             f"{no_grad})")
    out["apc"]["train"] = {"loss": loss, "launches": train_launches, "lr": lr,
                           "unmoved_by_rounding": sorted(stuck)}
    del train, optimizer, scheduler, step, model, params, state
    torch.cuda.empty_cache()

    cpc_cfg = dataclasses.replace(
        cfg, audio=CPCConfig(), feat_select_idx=(1,),
        parallel_branch=dataclasses.replace(pb, d_model=256, nhead=4, dim_feedforward=1024))
    cpc = SpeechCLIPModel(cpc_cfg)
    cpc_params, _ = (cast_params(t, cpc.compute_dtype) for t in cpc.init(0))
    with torch.no_grad():
        (sel,), feat_len = cpc.forward_audio(cpc_params, wav[:64], wav_len[:64])
        cpc_ms = cuda_time_ms(lambda: cpc.forward_audio(cpc_params, wav[:64], wav_len[:64]),
                              reps=5, warmup=1)
    frames = WAV_SAMPLES
    for k, s in zip(cpc.audio_cfg.conv_kernels, cpc.audio_cfg.conv_strides):
        frames = (frames + 2 * (k // 2) - k) // s + 1
    say(f"  modified_cpc feat_select_idx [1]: forward_audio B=64 -> state c "
        f"{tuple(sel.shape)} {sel.dtype} (z is {cpc.audio_cfg.conv_dim} wide, c "
        f"{cpc.audio_cfg.context_dim}), lengths {int(feat_len.min())}..{int(feat_len.max())}; "
        f"{cpc_ms:.3f} ms")
    if tuple(sel.shape) != (64, frames, 256) or not bool(torch.isfinite(sel).all()):
        fail(f"upstreams: CPC's selected state {tuple(sel.shape)}")
    out["cpc_forward_ms"] = cpc_ms
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"phase 25 upstreams: wall {out['wall_s']:.1f} s")
    return out, apc_launches


DP_WORLD = 2  # phase 27 (b): two gloo ranks, both on cuda:0
DP_STEPS = 2  # steps each run takes after its gradient reading
DP_SEED = 27  # the global batch (every rank makes it and takes its rows)
DP_DROPOUT = 0.1  # the run that holds the global-noise property
# phase 27's limits by run, the world of two against world 1 on the same
# global batch: 5-100x above the first runs' worst readings (PERF.md §6, PR
# 15). Under "auto" each row of HuBERT's hand kernels has the same bits at
# either batch; under "pallas" the unfused layers' cuBLAS GEMMs round rows by
# the batch and train-mode kw-BN magnifies it at random init, as phase 16's
# limits allow for the plain path. The planted fault is held to "auto"'s.
DP_LIMITS = {
    # read: 1.7e-4 (a step's loss), 0.99938, 7.7e-4, 1.2e-7, 2.7e-5, 0
    "auto": dict(loss_rtol=1e-3, min_grad_cosine=0.995, grad_norm_rtol=5e-3, param_atol=1e-5,
                 bn_rtol=2e-3, vq_rtol=1e-3),
    # read: 4.6e-6, 0.99144, 0.011, 6.0e-8, 3.6e-4, 0.0106 (the code perplexity
    # counts the VQ's own argmaxes, before the imposed ids)
    "pallas": dict(loss_rtol=1e-3, min_grad_cosine=0.98, grad_norm_rtol=0.03, param_atol=1e-5,
                   bn_rtol=2e-3, vq_rtol=0.05),
}
DP_LIMITS["dropout"] = DP_LIMITS["auto"]  # read: 1.7e-5, 0.99944, 6.0e-4, 1.2e-7, 2.0e-5, 0


def _dp_run(model, params, model_state, mesh, backend, batch_size, steps, planted=False,
            impose=None, seed=DP_SEED):
    """One run of phase 27 on ``mesh`` (None: world 1): the train state from
    ``params`` (every rank's the same, ``place_state``), the global batch's
    rows, the loss, the VQ's perplexities, kw-BN's new statistics and the
    trainable gradients at the initial params (reduced over the ranks as
    the step reduces them; the generator rewound, so the steps draw the
    same masks), then ``steps`` counted train steps (the first one's
    collectives recorded), their metrics, host ms and launches, and the
    params and statistics after them, and the VQ's keyword ids at the
    initial params. ``planted``: the gradient reading alone. ``impose``:
    the global batch's keyword ids (B, K) imposed on the VQ throughout
    (``imposed_keyword_ids``: its argmax flips under rounding alone). On a
    mesh with a model axis (phase 28) the params are sharded and the
    readings (gradients, params) gathered into the full layout; the
    trainable leaves no rank shards are kept as this rank holds them."""
    import torch

    from speechclip_tpu_torch.ops.attention import attention_backend
    from speechclip_tpu_torch.parallel import collectives
    from speechclip_tpu_torch.parallel import tensor as tp
    from speechclip_tpu_torch.parallel.inventory import recording
    from speechclip_tpu_torch.parallel.mesh import shard_batch
    from speechclip_tpu_torch.training.optim import build_optimizer
    from speechclip_tpu_torch.training.train_step import (create_train_state, make_train_step,
                                                          place_state)

    batch = _train_batch(batch_size, torch.Generator(device="cuda").manual_seed(seed))
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    out = {"metrics": [], "launches": [], "recomputes": [], "ms": []}
    with contextlib.ExitStack() as imposed:
        if impose is not None:
            rows = impose if mesh is None else impose[mesh.rows(len(impose))]
            imposed.enter_context(imposed_keyword_ids(rows))
        imposed.enter_context(attention_backend(backend))
        state = place_state(create_train_state(model, params=params, model_state=model_state,
                                               mesh=mesh), mesh, model)
        optimizer, scheduler = build_optimizer(model.config, state.params,
                                               model.trainable_mask(state.params))
        leaves = optimizer.param_groups[0]["params"]
        flags = _paths(model.trainable_mask(state.params))
        out["names"] = [path for path, keep in flags.items() if keep]
        full = (lambda ts, what: ts) if mesh is None else (
            lambda ts, what: tp.full_like(ts, leaves, mesh, what))
        drawn = state.generator.get_state()
        with tp.model_mesh(mesh):
            feats, _, others, new_state = model.forward(
                state.params, state.model_state, batch, generator=state.generator, train=True,
                num_updates=torch.tensor(0, device="cuda"), mesh=mesh)
            losses = model.compute_loss(state.params, feats, mesh=mesh)
            grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        grads = full(collectives.all_reduce_mean(grads, mesh), "reading")
        state.generator.set_state(drawn)
        out.update(loss=float(losses["loss"].detach()), grads=[g.float().cpu() for g in grads])
        vq = others["vq_results"]
        if vq is not None:
            out.update(
                vq={k: float(vq[k].detach()) for k in ("code_perplexity", "prob_perplexity")},
                bn={k: v.cpu() for k, v in new_state["cascaded_branch"]["bn"].items()},
                ids=vq["targets"][..., 0].detach().cpu())
        del feats, others, new_state, losses, grads
        if planted:
            return out
        step = make_train_step(model, optimizer, scheduler, mesh=mesh)
        for i in range(steps):
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                inv = stack.enter_context(recording(mesh)) if mesh is not None and i == 0 else None
                state, metrics, launches, recomputes = _counted_step(step, state, batch)
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            out["launches"].append(launches)
            out["recomputes"].append(recomputes)
            if inv is not None:
                out["inventory"] = {"entries": inv.entries, "bytes": inv.collective_bytes(),
                                    "by_axis": inv.by_axis(),
                                    "trainable_bytes": sum(p.numel() * p.element_size()
                                                           for p in leaves)}
        out["params"] = [p.cpu().clone() for p in full([p.detach() for p in leaves], "params")]
        if "cascaded_branch" in state.model_state:
            out["bn_after"] = {k: v.cpu() for k, v in
                               state.model_state["cascaded_branch"]["bn"].items()}
        if mesh is not None and mesh.model_size > 1:
            out["replicated"] = [p.detach().cpu().clone() for p in leaves
                                 if tp.kind_of(p) is None]
            out["layout"] = _tp_layout(model, params, state, mesh)
    return out


def _paths(tree, prefix=""):
    """{path: leaf} over a tree of dicts and lists, None leaves left out."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix: tree}
    return {k: v for key, sub in items for k, v in _paths(sub, f"{prefix}/{key}").items()}


def _tp_layout(model, params, state, mesh):
    """Phase 28: ``gather_params`` of the placed state against the world-1
    tree this rank casts from the same init (every leaf's shape; the frozen
    leaves, which no step moves, bit for bit), and its wall seconds."""
    import torch

    from speechclip_tpu_torch.models.speechclip import cast_params
    from speechclip_tpu_torch.parallel import tensor as tp
    from speechclip_tpu_torch.training.optim import tree_leaves

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gathered = tp.gather_params(state.params, mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    want = cast_params(params, model.compute_dtype, "cuda")
    mask = _paths(model.trainable_mask(want))
    got, ref = _paths(gathered), _paths(want)
    shapes = got.keys() == ref.keys() and all(got[k].shape == ref[k].shape for k in ref)
    frozen = shapes and all(torch.equal(got[k], ref[k]) for k in ref if not mask[k])
    return {"shapes_equal": shapes, "frozen_bitwise": frozen, "leaves": len(got),
            "sharded": sum(tp.kind_of(p) is not None for p in tree_leaves(state.params)),
            "gather_s": seconds}


def _slice_backward(ctx, g):
    """The planted fault of phase 27: the gather's backward takes each rank's
    rows of its own gradient, without the sum over the ranks."""
    return g[ctx.mesh.rows(g.shape[0])], None, None


def _dp_rank(rank, out_dir):
    """One rank of phase 27 (b): each run of ``_dp_run`` over the world of
    DP_WORLD gloo ranks on cuda:0 ("pallas" with world 1's keyword ids
    imposed); the results saved for the parent."""
    import torch

    from speechclip_tpu_torch.parallel import collectives
    from speechclip_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * DP_WORLD)
    model = _train_model()
    params, model_state = model.init(0)
    ids = torch.load(os.path.join(out_dir, "pallas_ids.pt")).cuda()
    res = {"auto": _dp_run(model, params, model_state, mesh, "auto", TRAIN_BATCH, DP_STEPS),
           "pallas": _dp_run(model, params, model_state, mesh, "pallas", TRAIN_PALLAS_BATCH, 1,
                             impose=ids),
           "dropout": _dp_run(_train_model(dropout=DP_DROPOUT), params, model_state, mesh, "auto",
                              TRAIN_BATCH, DP_STEPS)}
    real = collectives._AllGatherRows.backward
    collectives._AllGatherRows.backward = staticmethod(_slice_backward)
    try:
        res["planted"] = _dp_run(model, params, model_state, mesh, "auto", TRAIN_BATCH, 0,
                                 planted=True)
    finally:
        collectives._AllGatherRows.backward = real
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _dp_readings(got, want):
    """The world of two (``got``: rank 0) against world 1 (``want``) on one
    global batch: the loss, each live leaf's gradient cosine and norm ratio,
    and, where the run took steps, ``grad_norm``, the params and kw-BN's
    statistics after them and the VQ's perplexities."""
    import torch

    norms = [float(g.norm()) for g in want["grads"]]
    live = [i for i, n in enumerate(norms) if n >= TRAIN_LIVE_GRAD * max(norms)]
    cos = [float(torch.nn.functional.cosine_similarity(got["grads"][i].flatten(),
                                                       want["grads"][i].flatten(), dim=0))
           for i in live]
    ratio = [float(got["grads"][i].norm()) / norms[i] for i in live]
    out = {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "min_grad_cosine": min(cos), "max_grad_norm_rel": max(abs(r - 1) for r in ratio),
           "live_leaves": len(live), "leaves": len(norms)}
    if "names" in want:  # the live leaf of the lowest cosine, its share of the largest norm
        worst = live[cos.index(min(cos))]
        out["worst_leaf"] = want["names"][worst]
        out["worst_leaf_norm_share"] = norms[worst] / max(norms)
    stat_rel = lambda a, b: max(float((a[k] - b[k]).abs().max() / b[k].abs().max()) for k in b)
    if "vq" in want:
        out["vq_rel"] = max(abs(got["vq"][k] - v) / abs(v) for k, v in want["vq"].items())
        out["bn_rel"] = stat_rel(got["bn"], want["bn"])
    if got.get("params"):
        out["grad_norm_rel"] = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                                   for g, w in zip(got["metrics"], want["metrics"]))
        out["step_loss_rel"] = max(abs(g["train_loss"] - w["train_loss"]) / abs(w["train_loss"])
                                   for g, w in zip(got["metrics"], want["metrics"]))
        out["param_max_abs"] = max(float((a - b).abs().max())
                                   for a, b in zip(got["params"], want["params"]))
        if "bn_after" in want:
            out["bn_after_rel"] = stat_rel(got["bn_after"], want["bn_after"])
    return out


def _dp_violations(r, limits):
    """The readings ``r`` outside ``limits`` (a DP_LIMITS entry)."""
    checks = [("loss_rel", r["loss_rel"] <= limits["loss_rtol"]),
              ("min_grad_cosine", r["min_grad_cosine"] >= limits["min_grad_cosine"]),
              ("max_grad_norm_rel", r["max_grad_norm_rel"] <= limits["grad_norm_rtol"])]
    if "vq_rel" in r:
        checks += [("vq_rel", r["vq_rel"] <= limits["vq_rtol"]),
                   ("bn_rel", r["bn_rel"] <= limits["bn_rtol"])]
    if "param_max_abs" in r:
        checks += [("grad_norm_rel", r["grad_norm_rel"] <= limits["grad_norm_rtol"]),
                   ("step_loss_rel", r["step_loss_rel"] <= limits["loss_rtol"]),
                   ("param_max_abs", r["param_max_abs"] <= limits["param_atol"])]
        if "bn_after_rel" in r:
            checks.append(("bn_after_rel", r["bn_after_rel"] <= limits["bn_rtol"]))
    return [name for name, ok in checks if not ok]


def _dp_inventory(inv, global_batch, feat_dim):
    """Phase 27 (c): one step's collectives against ``tests/test_scaling_hlo.py``'s
    gates: the features (B, feat) and ids (B,) are the only gathers (no rank-3
    float tensor), the gradient all-reduce moves the trainable leaves' bytes
    alone, and every other all-reduce carries statistics (kw-BN, the VQ) or
    the gathered features' gradients."""
    entries = inv["entries"]
    gathers = sorted((dt, dims, what) for op, dt, dims, what, _ in entries if op == "all-gather")
    want = sorted([("f32", (global_batch, feat_dim), "features")] * 4
                  + [("s64", (global_batch,), "ids")] * 2)
    if gathers != want:
        fail(f"phase 27 inventory: gathers {gathers}, expected {want}")
    grads = [(op, dims) for op, dt, dims, what, _ in entries if what == "gradients"]
    if len(grads) != 1 or grads[0][0] != "all-reduce" or math.prod(grads[0][1]) * 4 != inv[
            "trainable_bytes"]:
        fail(f"phase 27 inventory: gradient reduction {grads}, trainable bytes "
             f"{inv['trainable_bytes']}")
    tags = {what for op, dt, dims, what, _ in entries if op == "all-reduce"}
    allowed = {"gradients", "kw_bn", "kw_bn gradient", "vq", "features gradient"}
    if not tags <= allowed:
        fail(f"phase 27 inventory: all-reduces of {tags - allowed}")
    by_tag = {}
    for op, dt, dims, what, _ in entries:
        n, b = by_tag.get((op, what), (0, 0))
        by_tag[(op, what)] = (n + 1, b + math.prod(dims) * {"f32": 4, "s64": 8}[dt])
    return {"bytes": {op: list(v) for op, v in inv["bytes"].items()},
            "by_what": {f"{op} {what}": list(v) for (op, what), v in sorted(by_tag.items())},
            "trainable_bytes": inv["trainable_bytes"]}


def phase_data_parallel(smi, nccl_world1, flash, flash_recomputes):
    """Phase 27 (b) and (c), the data-parallel step held to world 1: the
    flagship at full width from one seeded init, at dropout 0 under "auto"
    (B = TRAIN_BATCH, DP_STEPS steps) and "pallas" (TRAIN_PALLAS_BATCH, 1
    step) and at DP_DROPOUT (DP_STEPS steps), first at world 1 in this
    process, then in a world of DP_WORLD gloo ranks on cuda:0
    (``parallel.mesh.spawn``; "pallas" with world 1's keyword ids imposed),
    with a planted wrong-reduction gather that must fail the limits; each rank's launches; rank 0's inventory of one
    step. ``flash`` / ``flash_recomputes``: phase 16's "pallas" counts a
    step. (a), world 1 under NCCL through the CLI, ran within phase 18
    (``nccl_world1``)."""
    import shutil
    import tempfile

    import torch

    from speechclip_tpu_torch.parallel.mesh import spawn

    t_phase = time.perf_counter()
    model = _train_model()
    params, model_state = model.init(0)
    ref = {"auto": _dp_run(model, params, model_state, None, "auto", TRAIN_BATCH, DP_STEPS),
           "pallas": _dp_run(model, params, model_state, None, "pallas", TRAIN_PALLAS_BATCH, 1),
           "dropout": _dp_run(_train_model(dropout=DP_DROPOUT), params, model_state, None, "auto",
                              TRAIN_BATCH, DP_STEPS)}
    feat_dim = model.config.clip_embed_dim
    del model, params, model_state
    torch.cuda.empty_cache()
    t_world = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        # under "pallas" cuBLAS's GEMMs round rows by the batch: the world
        # of two takes world 1's keyword ids, as phase 16 imposes them
        torch.save(ref["pallas"]["ids"], os.path.join(tmp, "pallas_ids.pt"))
        spawn(_dp_rank, DP_WORLD, "gloo", args=(tmp,))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    world_s = time.perf_counter() - t_world
    readings = {run: _dp_readings(ranks[0][run], ref[run]) for run in ("auto", "pallas", "dropout")}
    readings["planted"] = _dp_readings(ranks[0]["planted"], ref["auto"])
    bitwise = {run: all(torch.equal(a, b) for a, b in zip(*(r[run]["params"] for r in ranks)))
               for run in ("auto", "pallas", "dropout")}
    expect = {"auto": (dict(mha_layer_block=13, ffn_block=13), dict(mha_layer_block=1,
                                                                     ffn_block=1)),
              "pallas": (dict(flash_attention=flash), dict(flash_attention=flash_recomputes)),
              "dropout": (dict(mha_layer_block=12, ffn_block=12), {})}
    for run, (launches, recomputes) in expect.items():
        for r, rank in enumerate(ranks):
            for i, (got, rec) in enumerate(zip(rank[run]["launches"], rank[run]["recomputes"])):
                _expect_launches(f"phase 27 {run} rank {r} step {i + 1}", got, **launches)
                _expect_recomputes(f"phase 27 {run} rank {r} step {i + 1}", rec, **recomputes)
    inventory = _dp_inventory(ranks[0]["auto"]["inventory"], TRAIN_BATCH, feat_dim)
    for run, r in readings.items():
        say(f"phase 27 (b) {run}: world {DP_WORLD} (gloo, both ranks on cuda:0) against world 1 "
            f"on {smi}: " + _fmt(r))
    ms = {f"rank {r}": {run: [round(x, 3) for x in rank[run]["ms"]] for run in expect}
          for r, rank in enumerate(ranks)}
    say(f"phase 27 (b) step ms per rank (host clock, each step synchronized; two ranks sharing "
        f"one card, not a scaling figure) {ms}; world 1 in this process "
        f"{ {run: [round(x, 3) for x in ref[run]['ms']] for run in expect} }; ranks' params "
        f"bitwise equal {bitwise}; peak GiB per rank "
        f"{[round(rank['peak_gib'], 2) for rank in ranks]}")
    say(f"phase 27 (c) one world-{DP_WORLD} step's collectives (rank 0): {inventory['bytes']} "
        f"(op: count, bytes); by what {inventory['by_what']}; trainable gradient bytes "
        f"{inventory['trainable_bytes']}")
    planted = _dp_violations(readings["planted"], DP_LIMITS["auto"])
    say(f"phase 27 (b) limits {DP_LIMITS}; the planted gather (no sum over the ranks) fails "
        f"\"auto\"'s on {planted}")
    if not planted:
        fail("phase 27: the planted wrong-reduction gather passes the limits")
    for run in ("auto", "pallas", "dropout"):
        bad = _dp_violations(readings[run], DP_LIMITS[run])
        if bad:
            fail(f"phase 27 {run}: world {DP_WORLD} outside the limits on {bad}")
        if not bitwise[run]:
            fail(f"phase 27 {run}: the ranks' params differ")
    wall = time.perf_counter() - t_phase
    say(f"phase 27 data parallel: wall {wall:.1f} s (the world of {DP_WORLD} {world_s:.1f} s)")
    launches = {f"data parallel {run} (a rank)": ranks[0][run]["launches"][0] for run in expect}
    return {"nccl_world1": nccl_world1, "world": DP_WORLD, "backend": "gloo",
            "readings": readings, "limits": DP_LIMITS, "planted_fails": planted,
            "params_bitwise_across_ranks": bitwise, "ms_per_rank": ms,
            "inventory": inventory, "wall_s": wall}, launches


TP_MODEL = 2  # phase 28: the model axis, both runs
TP_LARGE_CONFIG = "configs/large_flickr/spchclp_p.yaml"  # (a): HuBERT-large, ViT-L/14
TP_LARGE_BATCH = 32
TP_LARGE_STEPS = 2
TP_DATA = 2  # (b): data 2 x model 2, the flagship at B = TP_FLAGSHIP_BATCH, one step
TP_FLAGSHIP_BATCH = 64
TP_SEED = 28  # the global batch
# phase 28's limits by run: the (data, model) world against world 1 on the
# same batch and weights under "xla" (the unfused layers a model axis runs,
# which JAX's partitioned step computes; the world runs them on the
# whole-row kernel at its heads, world 1 on sdpa_plain), written before the
# first run with the readings predicted (PERF.md section 6). That run (one
# H100 80GB HBM3 at 700 W) read (a)'s loss 4.9e-5, grad_norm 1.6e-3 and
# params 1.2e-7 within these limits, but missed the per-leaf limits (cosine
# 0.99, norms 0.02) on one leaf, the branch's norm2 bias (0.4 % of the
# largest gradient norm), where world 1 under "auto" parts from world 1
# under "xla" as far (0.988375, 0.067): bf16 rounding at random init, not
# the model axis. So each live leaf's cosine gap and norm ratio are held to
# TP_FLOOR_FACTOR times those of the two single-card routes on the same run
# (``_tp_violations``).
TP_LIMITS = {
    # predicted: loss 1e-3, grad_norm 5e-3, params 1e-7 (and per leaf:
    # cosine 0.999, norms within 0.02; missed, see above)
    "large": dict(loss_rtol=1e-2, grad_norm_rtol=0.02, param_atol=1e-5),
    # predicted: loss 1e-3, grad_norm 0.01, params 1e-7, kw-BN 5e-4, VQ 0.01
    # (the keyword ids imposed; per leaf: cosine 0.99)
    "flagship": dict(loss_rtol=1e-2, grad_norm_rtol=0.03, param_atol=1e-5, bn_rtol=2e-3,
                     vq_rtol=0.05),
}
TP_FLOOR_FACTOR = 2.0


def _tp_violations(r, floor, limits):
    """Phase 28's readings ``r`` outside ``limits`` (absolute: the losses,
    ``grad_norm``, the params, kw-BN and the VQ) or outside TP_FLOOR_FACTOR
    times ``floor``'s per-leaf gradient disagreement (world 1 "auto"
    against world 1 "xla")."""
    checks = [("loss_rel", r["loss_rel"] <= limits["loss_rtol"]),
              ("step_loss_rel", r["step_loss_rel"] <= limits["loss_rtol"]),
              ("grad_norm_rel", r["grad_norm_rel"] <= limits["grad_norm_rtol"]),
              ("param_max_abs", r["param_max_abs"] <= limits["param_atol"]),
              ("min_grad_cosine", 1 - r["min_grad_cosine"]
               <= TP_FLOOR_FACTOR * (1 - floor["min_grad_cosine"])),
              ("max_grad_norm_rel", r["max_grad_norm_rel"]
               <= TP_FLOOR_FACTOR * floor["max_grad_norm_rel"])]
    if "vq_rel" in r:
        checks += [("vq_rel", r["vq_rel"] <= limits["vq_rtol"]),
                   ("bn_rel", r["bn_rel"] <= limits["bn_rtol"]),
                   ("bn_after_rel", r["bn_after_rel"] <= limits["bn_rtol"])]
    return [name for name, ok in checks if not ok]


def _fmt(readings):
    return ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in readings.items())


def _tp_large_model():
    """``configs/large_flickr/spchclp_p.yaml`` as a model on the card:
    HuBERT-large, ViT-L/14 and the 1024-wide parallel branch (dropout 0.1),
    seeded random weights (no pretrained file is read)."""
    from speechclip_tpu_torch import SpeechCLIPModel
    from speechclip_tpu_torch.config import load_config, model_config_from_tree

    return SpeechCLIPModel(model_config_from_tree(load_config(TP_LARGE_CONFIG)))


def _tp_rank(rank, out_dir, run):
    """One rank of phase 28: ``run`` "large" ((a): a world of TP_MODEL, data
    1) or "flagship" ((b): TP_DATA x TP_MODEL), every rank a gloo process
    on cuda:0; the results saved for the parent."""
    import torch

    from speechclip_tpu_torch.parallel.mesh import make_mesh

    world = TP_MODEL * (1 if run == "large" else TP_DATA)
    mesh = make_mesh(devices=["cuda:0"] * world, model=TP_MODEL)
    if run == "large":
        model = _tp_large_model()
        params, model_state = model.init(0)
        res = _dp_run(model, params, model_state, mesh, "auto", TP_LARGE_BATCH, TP_LARGE_STEPS,
                      seed=TP_SEED)
    else:
        model = _train_model()
        params, model_state = model.init(0)
        ids = torch.load(os.path.join(out_dir, "ids.pt")).cuda()
        res = _dp_run(model, params, model_state, mesh, "auto", TP_FLAGSHIP_BATCH, 1,
                      impose=ids, seed=TP_SEED)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["coords"] = (mesh.data_rank, mesh.model_rank)
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _tp_spawn(run, world, ids=None):
    """Phase 28's world for ``run`` -> each rank's results and the wall s."""
    import shutil
    import tempfile

    import torch

    from speechclip_tpu_torch.parallel.mesh import spawn

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    try:
        if ids is not None:
            torch.save(ids, os.path.join(tmp, "ids.pt"))
        spawn(_tp_rank, world, "gloo", args=(tmp, run))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ranks, time.perf_counter() - t0


def _tp_model_axis_bytes(model, batch, frames):
    """The model axis's forward collectives a rank issues per step, from the
    code: each sharded attention gathers its (rows, D) heads in the
    activation dtype, and each row-parallel layer all-reduces its (rows, D)
    f32 partials -> {tower: (gathers, all-reduces, bytes)}."""
    a, v, pb = model.audio_cfg, model.vision_cfg, model.config.parallel_branch
    towers = {"hubert": (a.encoder_layers, batch * frames, a.encoder_embed_dim),
              "image tower": (v.layers, batch * ((v.image_size // v.patch_size) ** 2 + 1),
                              v.width),
              "parallel branch": (pb.n_layers, batch * (frames + 1), pb.d_model)}
    return {k: (n, n, n * rows * d * (2 + 4)) for k, (n, rows, d) in towers.items()}


def _tp_check_ranks(label, ranks, expect_launches, expect_recomputes):
    """The ranks' launches a step, their trainable replicated leaves bitwise
    equal, their params gathered bitwise equal, and each rank's gathered
    tree in world 1's layout (frozen leaves bitwise)."""
    import torch

    for r, rank in enumerate(ranks):
        for i, (got, rec) in enumerate(zip(rank["launches"], rank["recomputes"])):
            _expect_launches(f"phase 28 {label} rank {r} step {i + 1}", got, **expect_launches)
            _expect_recomputes(f"phase 28 {label} rank {r} step {i + 1}", rec,
                               **expect_recomputes)
        lay = rank["layout"]
        if not (lay["shapes_equal"] and lay["frozen_bitwise"] and lay["sharded"] > 0):
            fail(f"phase 28 {label} rank {r}: gather_params's tree {lay}")
    same = lambda key: all(all(torch.equal(a, b) for a, b in zip(ranks[0][key], rank[key]))
                           for rank in ranks[1:])
    replicated, params = same("replicated"), same("params")
    if not (replicated and params):
        fail(f"phase 28 {label}: the ranks' replicated leaves equal {replicated}, "
             f"gathered params equal {params}")
    return {"replicated_bitwise": replicated, "params_bitwise": params,
            "replicated_trainable_leaves": len(ranks[0]["replicated"]),
            "layout": ranks[0]["layout"]}


def _tp_inventory(inv, predicted):
    """(a)'s model-axis forward collectives against ``predicted``
    (``_tp_model_axis_bytes``: every sharded attention's heads gathered,
    every row-parallel output reduced in f32); -> the readings."""
    model = [e for e in inv["entries"] if e[4] == "model"]
    heads = [e for e in model if e[3] == "heads"]
    outputs = [e for e in model if e[0] == "all-reduce" and e[3].endswith("output")]
    if any(e[1] != "f32" for e in outputs):
        fail("phase 28 inventory: row-parallel partials reduced in "
             f"{sorted({e[1] for e in outputs})}")
    size = lambda es: sum(math.prod(e[2]) * {"f32": 4, "bf16": 2}[e[1]] for e in es)
    want_n = sum(n for n, _, _ in predicted.values())
    want_bytes = sum(b for _, _, b in predicted.values())
    got_bytes = size(heads) + size(outputs)
    if len(heads) != want_n or len(outputs) != want_n or got_bytes != want_bytes:
        fail(f"phase 28 inventory: {len(heads)} head gathers and {len(outputs)} partial "
             f"reductions of {got_bytes} B, predicted {want_n} each, {want_bytes} B")
    return {"by_axis": {a: {op: list(v) for op, v in d.items()} for a, d in inv["by_axis"].items()},
            "forward_model_axis_bytes": got_bytes, "predicted_bytes": want_bytes,
            "predicted_by_tower": {k: list(v) for k, v in predicted.items()}}


def phase_tensor_parallel(smi):
    """Phase 28, the model axis held to world 1. (a) ``TP_LARGE_CONFIG`` at
    full width (HuBERT-large and ViT-L/14 frozen, the image tower running,
    the large parallel branch trainable at its dropout 0.1) on a world of
    TP_MODEL gloo ranks on cuda:0 (data 1): B = TP_LARGE_BATCH of 6.4 s,
    TP_LARGE_STEPS steps, against world 1 under "xla" (and read beside
    world 1 under "auto"); the launches a rank a step (``attention_vmem``
    at the local heads, no fused block), the model axis's collectives
    against the bytes the code predicts, peak GiB. (b) ``flagship_config()``
    at dropout 0 on TP_DATA x TP_MODEL ranks: B = TP_FLAGSHIP_BATCH, one
    step, world 1's keyword ids imposed, against world 1 under "xla"."""
    import torch

    t_phase = time.perf_counter()
    out = {}
    model = _tp_large_model()
    params, model_state = model.init(0)
    frames = 319  # HuBERT frames of a 6.4 s buffer
    predicted = _tp_model_axis_bytes(model, TP_LARGE_BATCH, frames)
    ref = {}
    for backend in ("xla", "auto"):
        torch.cuda.reset_peak_memory_stats()
        ref[backend] = _dp_run(model, params, model_state, None, backend, TP_LARGE_BATCH,
                               TP_LARGE_STEPS, seed=TP_SEED)
        ref[backend]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, params, model_state
    torch.cuda.empty_cache()
    ranks, world_s = _tp_spawn("large", TP_MODEL)
    a = _tp_check_ranks("(a)", ranks, dict(attention_vmem=48), {})
    a["launches"] = ranks[0]["launches"][0]
    a["readings"] = _dp_readings(ranks[0], ref["xla"])
    a["readings_vs_auto"] = _dp_readings(ranks[0], ref["auto"])
    a["world1_auto_vs_xla"] = _dp_readings(ref["auto"], ref["xla"])
    a["inventory"] = _tp_inventory(ranks[0]["inventory"], predicted)
    a["ms_per_rank"] = [[round(x, 3) for x in rank["ms"]] for rank in ranks]
    a["ms_world1"] = {b: [round(x, 3) for x in ref[b]["ms"]] for b in ref}
    a["peak_gib"] = {"ranks": [round(rank["peak_gib"], 3) for rank in ranks],
                     "world1": {b: round(ref[b]["peak_gib"], 3) for b in ref}}
    a["world_s"] = world_s
    say(f"phase 28 (a) {TP_LARGE_CONFIG} at model {TP_MODEL}, data 1 (gloo, both ranks on "
        f"cuda:0) against world 1 \"xla\" on {smi}: "
        + _fmt(a["readings"]))
    say(f"phase 28 (a) against world 1 \"auto\" (the fused blocks; not held to the limits): "
        + _fmt(a["readings_vs_auto"]))
    say(f"phase 28 (a) world 1 \"auto\" against world 1 \"xla\" (two single-card routes: the "
        f"rounding the limits must clear): " + _fmt(a["world1_auto_vs_xla"]))
    say(f"phase 28 (a) launches a rank a step {ranks[0]['launches']}; replicated trainable "
        f"leaves bitwise equal over the ranks {a['replicated_bitwise']} "
        f"({a['replicated_trainable_leaves']} leaves); gather_params {a['layout']}")
    say(f"phase 28 (a) model-axis forward collectives a rank a step: "
        f"{a['inventory']['forward_model_axis_bytes'] / 1e9:.4f} GB (predicted "
        f"{a['inventory']['predicted_bytes'] / 1e9:.4f} GB: {a['inventory']['predicted_by_tower']}"
        f" as (gathers, all-reduces, bytes)); one step by axis {a['inventory']['by_axis']}")
    say(f"phase 28 (a) step ms (host clock, each step synchronized; gloo copies every "
        f"collective through the host and both ranks share one card: not a tensor-parallel "
        f"figure) ranks {a['ms_per_rank']}, world 1 {a['ms_world1']}; peak GiB {a['peak_gib']}; "
        f"the world {world_s:.1f} s")
    bad = _tp_violations(a["readings"], a["world1_auto_vs_xla"], TP_LIMITS["large"])
    if bad:
        fail(f"phase 28 (a): model {TP_MODEL} outside the limits on {bad}")
    out["large"] = a
    del ranks, ref
    torch.cuda.empty_cache()

    model = _train_model()
    params, model_state = model.init(0)
    torch.cuda.reset_peak_memory_stats()
    ref = _dp_run(model, params, model_state, None, "xla", TP_FLAGSHIP_BATCH, 1, seed=TP_SEED)
    ref["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    auto = _dp_run(model, params, model_state, None, "auto", TP_FLAGSHIP_BATCH, 1,
                   impose=ref["ids"].cuda(), seed=TP_SEED)
    del model, params, model_state
    torch.cuda.empty_cache()
    ranks, world_s = _tp_spawn("flagship", TP_DATA * TP_MODEL, ids=ref["ids"])
    if sorted(r["coords"] for r in ranks) != [(d, m) for d in range(TP_DATA)
                                              for m in range(TP_MODEL)]:
        fail(f"phase 28 (b): the ranks' (data, model) {[r['coords'] for r in ranks]}")
    b = _tp_check_ranks("(b)", ranks, dict(attention_vmem=13), dict(attention_vmem=1))
    b["launches"] = ranks[0]["launches"][0]
    b["readings"] = _dp_readings(ranks[0], ref)
    b["world1_auto_vs_xla"] = _dp_readings(auto, ref)
    axes = ranks[0]["inventory"]["by_axis"]
    if not ({"data", "model"} <= set(axes) and axes["data"].get("all-gather")
            and axes["model"].get("all-gather") and axes["model"].get("all-reduce")):
        fail(f"phase 28 (b): one step's collectives by axis {axes}")
    b["by_axis"] = {k: {op: list(v) for op, v in d.items()} for k, d in axes.items()}
    b["peak_gib"] = {"ranks": [round(rank["peak_gib"], 3) for rank in ranks],
                     "world1": round(ref["peak_gib"], 3)}
    b["world_s"] = world_s
    say(f"phase 28 (b) flagship at data {TP_DATA} x model {TP_MODEL} (four gloo ranks on "
        f"cuda:0) against world 1 \"xla\", keyword ids imposed, on {smi}: "
        + _fmt(b["readings"]))
    say(f"phase 28 (b) world 1 \"auto\" (the same ids imposed) against world 1 \"xla\": "
        + _fmt(b["world1_auto_vs_xla"]))
    say(f"phase 28 (b) launches a rank {ranks[0]['launches']}, recomputes "
        f"{ranks[0]['recomputes']}; one step by axis {b['by_axis']}; peak GiB {b['peak_gib']}; "
        f"the world {world_s:.1f} s")
    bad = _tp_violations(b["readings"], b["world1_auto_vs_xla"], TP_LIMITS["flagship"])
    if bad:
        fail(f"phase 28 (b): data {TP_DATA} x model {TP_MODEL} outside the limits on {bad}")
    out["flagship"] = b
    out["limits"] = dict(TP_LIMITS, floor_factor=TP_FLOOR_FACTOR)
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"phase 28 tensor parallel: wall {out['wall_s']:.1f} s")
    launches = {"tensor parallel large (a rank)": out["large"]["launches"],
                "tensor parallel flagship (a rank)": out["flagship"]["launches"]}
    return out, launches


REPLACES = {
    "mha_layer_block": ("speechclip_tpu_torch/csrc/gemm_epilogue.cu + "
                        "speechclip_tpu_torch/csrc/attention_vmem.cu",
                        "speechclip_tpu/kernels/mha_block.py:59", "hubert B=", "main"),
    "ffn_block": ("speechclip_tpu_torch/csrc/gemm_epilogue.cu",
                  "speechclip_tpu/kernels/ffn_block.py:40", "hubert B=", "main"),
    "attention_vmem": ("speechclip_tpu_torch/csrc/attention_vmem.cu",
                       "speechclip_tpu/kernels/attention_vmem.py:64", "hubert 17s", "long 17s"),
    "flash_attention": ("speechclip_tpu_torch/csrc/flash_attention.cu",
                        "speechclip_tpu/kernels/flash_attention.py:38", "cascaded 768",
                        "cascaded pallas"),
    "fused_conv_chain": ("speechclip_tpu_torch/csrc/conv_chain.cu",
                         "speechclip_tpu/kernels/conv_frontend.py:74", "hubert conv1..6",
                         "conv A/B"),
}


def main(argv) -> int:
    if argv not in ([], ["--profile"]):
        print("usage: chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    profile_only = argv == ["--profile"]
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

    from speechclip_tpu_torch import base_config, flagship_config, shipped_cascaded_config

    smi = phase_card_and_build()
    kern = None if profile_only else phase_kernels()

    model, params, _ = _model(base_config())
    gen = torch.Generator(device="cuda").manual_seed(0)
    gallery = torch.nn.functional.normalize(
        torch.randn(GALLERY, model.config.clip_embed_dim, generator=gen, device="cuda"),
        dim=-1,
    )
    if profile_only:
        phase_gemm_ab(smi)
        phase_conv_tiles(smi)
        phase_profile(model, params, gallery, smi, _model(shipped_cascaded_config()))
        phase_frontend_split(model, params, smi)
        phase_profile_gallery(model, params, smi)
        del model, params
        torch.cuda.empty_cache()
        phase_profile_train(smi)
        torch.cuda.empty_cache()
        phase_profile_trainable(smi)
        torch.cuda.empty_cache()
        phase_profile_large(smi)
        return 0
    launches = {"main": phase_path(3, "main", model, params, gallery, seed=2)}
    phase_throughput(model, params, gallery, smi)
    launches["long 17s"] = phase_path(5, "long 17s", model, params, gallery, seed=5)
    launches["long 12s"] = phase_path(5, "long 12s", model, params, gallery, seed=6)
    launches["flash backend"] = phase_path(6, "flash backend", model, params, gallery, seed=7)
    for label in ("long 17s", "long 12s", "flash backend"):
        phase_path_throughput(label, model, params, gallery, smi)
    del model, params
    torch.cuda.empty_cache()

    launches["conv A/B"] = phase_conv_ab(smi)
    model, params, state = _model(shipped_cascaded_config())
    for i, label in enumerate(CASCADED_PATHS):
        launches[label] = phase_cascaded(label, model, params, state, gallery, seed=12 + i)
    phase_cascaded_throughput(model, params, state, gallery, smi)
    del model, params, state
    torch.cuda.empty_cache()

    model, params, _ = _model(base_config())
    phase_gallery(model, params, smi)
    phase_text(model, params, smi)
    phase_eval(model, params, smi)
    del model, params
    torch.cuda.empty_cache()
    phase_vit_l14(smi)
    phase_resnet(smi)
    torch.cuda.empty_cache()
    recomputes = {}
    launches["train auto"], recomputes["train auto"] = phase_train_agreement(
        "auto", "auto", TRAIN_BATCH, 22, dict(mha_layer_block=13, ffn_block=13),
        dict(mha_layer_block=1, ffn_block=1))
    torch.cuda.empty_cache()
    flagship = flagship_config()
    text_layers = flagship.clip_text.layers
    flash = dict(hubert=flagship.audio.encoder_layers, image_tower=flagship.clip_vision.layers,
                 cascaded_head=1, text_tower=text_layers,
                 parallel_branch=flagship.parallel_branch.n_layers)
    say(f"phase 16 training pallas: flash_attention launches expected {flash} = "
        f"{sum(flash.values())}, backward recomputes cascaded head 1 + text tower "
        f"{text_layers} + parallel branch 1")
    launches["train pallas"], recomputes["train pallas"] = phase_train_agreement(
        "pallas", "pallas", TRAIN_PALLAS_BATCH, 23, dict(flash_attention=sum(flash.values())),
        dict(flash_attention=2 + text_layers))
    torch.cuda.empty_cache()
    train = phase_train_timed(smi)
    torch.cuda.empty_cache()
    cache_step = f"phase 17's image-cache step {train['cache_ms']:.3f}"
    # the CLIP tokenizer of phases 18, 21 and 24: CLIP's id layout over a
    # synthetic merges file (CLIP's own is not in the repository)
    bpe_dir = tempfile.mkdtemp(prefix="chip_smoke_bpe_")
    atexit.register(shutil.rmtree, bpe_dir, True)
    t0 = time.perf_counter()
    os.environ["SPEECHCLIP_BPE_PATH"] = write_synthetic_merges(
        os.path.join(bpe_dir, "bpe_simple_vocab_16e6.txt.gz"))
    say(f"tokenizer: synthetic merges file ({BPE_MERGES} merges) written in "
        f"{time.perf_counter() - t0:.2f} s; SPEECHCLIP_BPE_PATH points at it")
    trainer = phase_trainer(smi, {"spchclp_p": cache_step, "spchclp_c": cache_step})
    torch.cuda.empty_cache()

    large_launches, large_rates = phase_large_encode(smi)
    launches.update(large_launches)
    large_train = phase_large_train(smi)
    for label, run in large_train.items():
        if "launches" in run:
            launches[f"large train {label}"] = run["launches"]
    beside = {key: "phase 20's B=256 image-cache step, wsum_remat {}: {:.3f}".format(
        on, large_train[f"B=256 image cache wsum_remat {on}"]["ms"])
        for key, on in (("spchclp_p", "off"), ("spchclp_c", "on"))}
    large_trainer = phase_trainer(smi, beside, phase=21, configs=LARGE_TRAINER_CONFIGS,
                                  c_overrides=["audio_encoder.wsum_remat=true"], resume_c=True)
    torch.cuda.empty_cache()

    trainable = phase_trainable(smi, sum(flash.values()))
    for label, run in [("trainable full", trainable["full"]),
                       ("trainable unfreeze", trainable["unfreeze"]),
                       ("trainable large partial", trainable["large partial"])] + [
            (f"trainable {k}", v) for k, v in trainable["towers"].items()]:
        launches[label], recomputes[label] = run["launches"], run["recomputes"]

    torch.cuda.empty_cache()
    serving, serving_launches = phase_serving(smi)
    launches.update(serving_launches)
    torch.cuda.empty_cache()
    export, export_launches = phase_export(smi, serving)
    launches.update(export_launches)
    torch.cuda.empty_cache()
    text_side = phase_text_side(smi)
    torch.cuda.empty_cache()
    upstreams, launches["apc"] = phase_upstreams(smi)
    torch.cuda.empty_cache()
    data_parallel, dp_launches = phase_data_parallel(smi, trainer.pop("nccl_world1"),
                                                     sum(flash.values()), 2 + text_layers)
    launches.update(dp_launches)
    torch.cuda.empty_cache()
    tensor_parallel, tp_launches = phase_tensor_parallel(smi)
    launches.update(tp_launches)

    kernels = []
    for name, (source, replaces, row, path) in REPLACES.items():
        label, timed = next((label, r) for label, r in kern[name].items() if label.startswith(row))
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[path][name],
            "max_abs_err": max(r["err"] for r in kern[name].values()),
            "ms": timed["ms"],
            "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"],
            "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"],
            "device_ms": timed["device_ms"],
            "library_device_ms": timed["library_device_ms"],
            "path": path,
            "shape": label,
            "launches_by_path": {p: n[name] for p, n in launches.items() if n.get(name)},
        })
        if "layers" in timed:
            kernels[-1]["layers"] = timed["layers"]
        if name in kern["backward"]:
            kernels[-1]["backward"] = kern["backward"][name]
            kernels[-1]["recomputes"] = {path: r[name] for path, r in recomputes.items()}
    say(f"chip_smoke wall {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels, "train": train, "trainer": trainer,
                      "large": {"encode_utt_per_s": large_rates, "train": large_train,
                                "trainer": large_trainer},
                      "trainable": trainable, "serving": serving, "export": export,
                      "text_side": text_side,
                      "upstreams": upstreams, "data_parallel": data_parallel,
                      "tensor_parallel": tensor_parallel}))
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
    sys.exit(main(sys.argv[1:]))
