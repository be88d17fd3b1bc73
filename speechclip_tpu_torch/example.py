"""Embedding extraction with the port (the counterpart of the repository's
``example.py``, the reference example.py:1-40 contract): load a checkpoint,
or take the flagship's seeded random init, then print the per-layer hidden
states and the speech embeddings of some waveforms.

    python -m speechclip_tpu_torch.example [--ckpt <run>/ckpts/last | <file>.ckpt]
        [--wav a.wav b.wav] [--platform cpu]

Without ``--wav`` two seeded 2 s noise waveforms stand in. It runs on the
card unless ``--platform cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", default=None,
                        help="run checkpoint dir or reference .ckpt (seeded random init if "
                             "omitted)")
    parser.add_argument("--wav", nargs="*", default=[], help="wav files (seeded noise if none)")
    parser.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    args = parser.parse_args(argv)
    device = args.platform

    from .data.audio import read_wav

    if args.ckpt is None:
        from .config import flagship_config
        from .models.speechclip import SpeechCLIPModel
        from .training.train_step import create_train_state

        model = SpeechCLIPModel(flagship_config(), device=device)
        state = create_train_state(model, seed=0)
        params, model_state = state.params, state.model_state
    else:
        from .training.checkpoint import load_any_checkpoint

        model, params, model_state = load_any_checkpoint(args.ckpt, device=device)

    if args.wav:
        wavs = [read_wav(p) for p in args.wav]
    else:
        rng = np.random.default_rng(0)
        wavs = [rng.standard_normal(16000 * 2).astype(np.float32) for _ in range(2)]
    wav = np.zeros((len(wavs), max(len(w) for w in wavs)), np.float32)
    for i, w in enumerate(wavs):
        wav[i, :len(w)] = w
    wav = torch.from_numpy(wav)
    wav_len = torch.tensor([len(w) for w in wavs])

    with torch.no_grad():
        # the reference's model.feature_extractor_s3prl(wav=...)
        last_hidden, hidden_states = model.extract_hidden_states(params, wav, wav_len)
        print(f"#hidden states: {len(hidden_states)}")
        print(f"last hidden state shape: {tuple(last_hidden.shape)}")
        # the reference's model.encode_speech(wav=...)
        output = model.encode_speech(params, model_state, wav, wav_len)
    for key in ("parallel_audio_feat", "cascaded_audio_feat", "keywords"):
        if key in output:
            print(f"{key}: {tuple(output[key].shape)}")
    return output


if __name__ == "__main__":
    main()
