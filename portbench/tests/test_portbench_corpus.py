"""The corpus writer's output is what the program's Flickr8k dataset and
bucketed loader read, in the buckets the traffic file predicts, and the
reference's reading of it (``loader_plan``) gives the loader's batches."""

import os

import numpy as np
import pytest

from portbench import corpus
from portbench.harness import HERE, load_json
from portbench.reference import loader_plan

FLICKR = load_json(os.path.join(HERE, "traffic", "flickr.json"))["corpus"]


def test_flickr_buckets_and_epoch():
    """2.0-9.7 s captions (a mean of 5.85 s, the corpus's published one)
    cropped to 6.4 s: quantile buckets of 4.0, 6.0 and 6.4 s, and 116 full
    batches of 256 an epoch of 30 000 captions."""
    from speechclip_tpu_torch.data.loader import make_buckets

    secs = corpus.durations(FLICKR)["train"].ravel()
    lengths = np.rint(secs * FLICKR["sample_rate"]).astype(np.int64)
    want = [64000, 96000, 102400]
    assert make_buckets(lengths, max_len=102400) == want
    assert loader_plan.buckets(lengths, 102400) == want
    plan = loader_plan.epoch_plan(lengths, want, 102400, 256, seed=3, epoch=0)
    assert 5.8 < secs.mean() < 5.9
    assert len(plan) == 116
    mean = np.mean([b for b, _i, _o in plan]) / FLICKR["sample_rate"]
    assert 5.6 < mean < 5.75


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    spec = dict(FLICKR, images={"train": 12, "dev": 2})
    root = corpus.ensure_corpus(str(tmp_path_factory.mktemp("c")), spec)
    return root, spec


def test_dataset_reads_it(small_corpus):
    from speechclip_tpu_torch.data.datasets import FlickrDataset

    root, spec = small_corpus
    ds = FlickrDataset(root, ["audio", "image"], split="train")
    secs = corpus.durations(spec)["train"].ravel()
    assert len(ds) == 60
    lengths = [ds.wav_length(i) for i in range(len(ds))]
    assert lengths == [int(round(s * 16000)) for s in secs]
    ref = loader_plan.entries(root, "train")
    assert [(e["id"], e["wav"], e["image"]) for e in ref] == [
        (e["id"], e["wav"], e["image"]) for e in ds.data]
    img = ds.get_item(0, skip_wav=True)["image"]
    assert img.shape == (224, 224, 3)
    again = corpus.ensure_corpus(os.path.dirname(root), spec)
    assert again == root


@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_loader_batches_are_the_references(small_corpus, seed):
    from speechclip_tpu_torch.data.datasets import FlickrDataset
    from speechclip_tpu_torch.data.loader import BucketedLoader

    root, _spec = small_corpus
    ds = FlickrDataset(root, ["audio", "image"], split="train")
    loader = BucketedLoader(ds, batch_size=8, train=True, max_audio_len=102400, seed=seed,
                            skip_images=True)
    got = [b for _e, b in zip(range(9), (x for _ in range(3) for x in loader))]
    want = loader_plan.first_batches(root, 102400, 8, seed, len(got))
    for g, w in zip(got, want):
        assert np.array_equal(g["id"], w["id"])
        assert np.array_equal(g["wav_len"], w["wav_len"])
        assert np.array_equal(g["wav"], w["wav"])
