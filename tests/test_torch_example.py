"""``python -m speechclip_tpu_torch.example`` (the port's counterpart of the
repository's ``example.py``): from a tiny run checkpoint on the CPU it
prints the hidden states and the features, which equal
``load_any_checkpoint`` + ``encode_speech`` on the same seeded waveforms;
WAV files are read; without ``--platform cpu`` it needs the card."""

import wave

import numpy as np
import pytest
import torch

from speechclip_tpu_torch import example
from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.training.checkpoint import CheckpointManager, load_any_checkpoint
from speechclip_tpu_torch.training.optim import build_optimizer
from speechclip_tpu_torch.training.train_step import create_train_state
from tests.test_models import tiny_speechclip_config


@pytest.fixture(scope="module")
def run_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("example")
    tree = ConfigTree(tiny_speechclip_config(tmp).to_dict())
    model = SpeechCLIPModel(model_config_from_tree(tree), device="cpu")
    state = create_train_state(model, seed=3)
    optimizer, scheduler = build_optimizer(model.config, state.params,
                                           model.trainable_mask(state.params))
    CheckpointManager(str(tmp / "ckpts")).save(state, 1, {}, tree, optimizer, scheduler)
    return tmp / "ckpts" / "last"


def test_example_from_a_run_checkpoint(run_ckpt, capsys):
    out = example.main(["--ckpt", str(run_ckpt), "--platform", "cpu"])
    printed = capsys.readouterr().out
    assert "#hidden states: 5" in printed  # HuBERT's 3 + the two branches' layers
    assert "parallel_audio_feat: (2, 16)" in printed and "keywords: (2, 4, 32)" in printed
    model, params, model_state = load_any_checkpoint(str(run_ckpt), device="cpu")
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(np.stack([rng.standard_normal(32000).astype(np.float32)
                                     for _ in range(2)]))
    with torch.no_grad():
        want = model.encode_speech(params, model_state, wav, torch.tensor([32000, 32000]))
    for key in ("parallel_audio_feat", "cascaded_audio_feat"):
        torch.testing.assert_close(out[key], want[key], rtol=0, atol=0)


def test_example_reads_wavs(run_ckpt, tmp_path, capsys):
    paths = []
    for i, n in enumerate((8000, 12000)):
        paths.append(str(tmp_path / f"{i}.wav"))
        pcm = (np.random.default_rng(i).standard_normal(n) * 3000).astype("<i2")
        with wave.open(paths[-1], "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
    out = example.main(["--ckpt", str(run_ckpt), "--platform", "cpu", "--wav", *paths])
    assert out["parallel_audio_feat"].shape == (2, 16)
    assert "last hidden state shape: (2, 599, 32)" in capsys.readouterr().out


def test_example_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
