#!/usr/bin/env python3
"""Where one served batch's forward makes the host wait for the card:

    python3 scripts/torch_host_sync_probe.py

``flagship_config()`` with bf16-cast weights (the serving runtime's
``dtype="bf16"``) on one B = 32 batch of 6.4 s int16 rows through
``export.encode_speech_surface``, as ``serving.py``'s worker calls it, under
``torch.inference_mode()``: after a warm-up call, one more under
``torch.cuda.set_sync_debug_mode("warn")``, which warns at every operation
that synchronizes the host with the card. Prints the card, then each
synchronizing site (the port's innermost three frames) with its count. A
site before the forward's end makes the host wait for every kernel queued
before it, so the serving worker cannot pack the next batch meanwhile.
"""

import collections
import os
import subprocess
import sys
import traceback
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from speechclip_tpu_torch import SpeechCLIPModel, flagship_config
    from speechclip_tpu_torch.export import cast_float_params, encode_speech_surface

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    model = SpeechCLIPModel(flagship_config())
    params, state = model.init(0)
    params = cast_float_params(params, torch.bfloat16)
    surface = encode_speech_surface(model)
    gen = torch.Generator().manual_seed(0)
    wav = (torch.randn(32, 102400, generator=gen) * 3000).to(torch.int16).cuda()
    lens = torch.full((32,), 102400, dtype=torch.int32)
    lens[::2] = 60000
    lens = lens.cuda()
    seen = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1] if "speechclip_tpu_torch" in f.filename]
        seen[" <- ".join(f"{f.filename.split('speechclip_tpu_torch/')[-1]}:{f.lineno} {f.line}"
                         for f in reversed(frames[-3:])) or "(outside the port)"] += 1

    with torch.inference_mode():
        surface(params, state, wav, lens)
        torch.cuda.synchronize()
        shown = warnings.showwarning
        warnings.showwarning = record
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    surface(params, state, wav, lens)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        finally:
            warnings.showwarning = shown
    for site, n in seen.most_common():
        print(f"{n} x {site}")
    print(f"synchronizing sites in one B = 32 forward: {len(seen)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
