"""The port's data layer (``speechclip_tpu_torch.data``: datasets, the
bucketed loader, the native ingest binding, the audio readers) against the
JAX package's on synthetic corpora (``tests/test_data.py``'s writers): the
same entries and pair ids, and batches bitwise equal over two epochs, train
and eval, with int16 PCM (``compact_wav``), ``skip_images``, uint8 images,
and the native decode on and off. The native decode equals the Python
reader, and a native failure falls back to it for that batch.
``native/libwavio.so`` is built by tests/conftest.py where it is absent."""

import json
import logging

import numpy as np
import pytest

from speechclip_tpu.data import datasets as jax_datasets
from speechclip_tpu.data import loader as jax_loader
from speechclip_tpu.data import native as jax_native
from speechclip_tpu_torch.data import audio as port_audio
from speechclip_tpu_torch.data import datasets as port_datasets
from speechclip_tpu_torch.data import loader as port_loader
from speechclip_tpu_torch.data import native as port_native
from tests.test_data import flickr_root, write_jpg, write_wav  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    """A SpokenCOCO tree: 4 images with 3 captions each, in both the
    default and the ksplit json (which carries reassigned ids)."""
    root = tmp_path_factory.mktemp("coco")
    (root / "SpokenCOCO" / "wavs").mkdir(parents=True)
    (root / "mscoco_img").mkdir()
    data = []
    for i in range(4):
        image = f"COCO_val_{40 + i:012d}.jpg"
        write_jpg(root / "mscoco_img" / image, size=40, seed=i)
        caps = []
        for n in range(3):
            write_wav(root / "SpokenCOCO" / "wavs" / f"{i}_{n}.wav", 3000 + 700 * n + 90 * i,
                      seed=10 * i + n)
            caps.append({"wav": f"wavs/{i}_{n}.wav", "text": f"A Thing {i}.{n}"})
        data.append({"image": image, "reassign_id": 100 - i, "captions": caps})
    for prefix in ("SpokenCOCO", "SpokenCOCO_ksplit"):
        for split in ("train", "val"):
            with open(root / "SpokenCOCO" / f"{prefix}_{split}.json", "w") as f:
                json.dump({"data": data}, f)
    return root


MODALITIES = [["audio", "image"], ["audio"], ["image"], ["audio", "image", "text"]]


@pytest.mark.parametrize("modalities", MODALITIES, ids="+".join)
@pytest.mark.parametrize("split", ["train", "dev"])
def test_flickr_entries_equal_jax(flickr_root, split, modalities):
    kw = dict(split=split, image_size=32)
    want = jax_datasets.FlickrDataset(str(flickr_root), modalities, **kw)
    got = port_datasets.FlickrDataset(str(flickr_root), modalities, **kw)
    assert got.data == want.data and len(got.data) > 0
    assert got.raw_decode_size == want.raw_decode_size
    if "audio" in modalities:
        assert [got.wav_length(i) for i in range(len(got))] == [
            want.wav_length(i) for i in range(len(want))]


def test_generated_pair_ids_equal_jax(tmp_path):
    names = [f"img{i:03d}" for i in (5, 1, 9, 1, 3)]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = jax_datasets._generate_id_pairs(str(tmp_path / "a"), names)
    got = port_datasets._generate_id_pairs(str(tmp_path / "b"), names)
    assert got == want
    assert (tmp_path / "a" / "Flickr8k_idPairs.json").read_text() == (
        tmp_path / "b" / "Flickr8k_idPairs.json").read_text()


@pytest.mark.parametrize("prefix", ["SpokenCOCO", "SpokenCOCO_ksplit"])
@pytest.mark.parametrize("modalities", MODALITIES, ids="+".join)
def test_coco_entries_equal_jax(coco_root, prefix, modalities):
    kw = dict(split="val", split_prefix=prefix)
    want = jax_datasets.SpokenCOCODataset(str(coco_root), modalities, **kw)
    got = port_datasets.SpokenCOCODataset(str(coco_root), modalities, **kw)
    assert got.data == want.data and len(got.data) > 0


class _Cfg(dict):
    __getattr__ = dict.__getitem__


@pytest.mark.parametrize("name", ["flickr", "coco"])
def test_build_dataset_equals_jax(flickr_root, coco_root, name):
    root = flickr_root if name == "flickr" else coco_root
    cfg = _Cfg(dataset=_Cfg(name=name, dataset_root=str(root), on_device_preprocess=True,
                            image_size=32))
    split = "train"
    want = jax_datasets.build_dataset(cfg, split)
    got = port_datasets.build_dataset(cfg, split)
    assert got.data == want.data and got.image_mode == want.image_mode == "raw"


def _batches(module, ds, epochs=2, **kw):
    loader = module.BucketedLoader(ds, num_workers=2, **kw)
    out = []
    for _ in range(epochs):
        out.extend(loader)
    return loader, out


def _assert_bitwise(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


LOADER_CASES = {
    "train crop": dict(batch_size=4, train=True, max_audio_len=6000),
    "train compact skip": dict(batch_size=4, train=True, max_audio_len=7000, compact_wav=True,
                               skip_images=True),
    "eval": dict(batch_size=5, train=False),
    "eval compact": dict(batch_size=3, train=False, compact_wav=True),
    "eval keep ragged train": dict(batch_size=5, train=True, drop_last=False),
}


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", list(LOADER_CASES))
@pytest.mark.parametrize("image_mode", ["clip", "raw"])
def test_loader_batches_bitwise_equal_jax(flickr_root, case, native, image_mode, monkeypatch):
    """Two epochs of ``np.random.default_rng(seed + epoch)`` draws: bucket
    shuffles, the plan shuffle and the per-batch crop offsets in the JAX
    loader's order, so every array is bitwise the JAX loader's."""
    if not native:
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)
    else:
        assert port_native.available() and jax_native.available()
    kw = dict(split="train", image_size=32, image_mode=image_mode)
    mods = ["audio", "image"]
    jl, want = _batches(jax_loader, jax_datasets.FlickrDataset(str(flickr_root), mods, **kw),
                        seed=11, **LOADER_CASES[case])
    pl, got = _batches(port_loader, port_datasets.FlickrDataset(str(flickr_root), mods, **kw),
                       seed=11, **LOADER_CASES[case])
    assert pl.buckets == jl.buckets and len(pl) == len(jl)
    _assert_bitwise(got, want)


def test_make_buckets_and_bucket_for_equal_jax():
    lengths = np.random.default_rng(0).integers(1000, 300000, 777)
    for max_len in (None, 102400):
        for groups in (1, 4, 7):
            b = port_loader.make_buckets(lengths, max_len=max_len, num_buckets=groups)
            assert b == jax_loader.make_buckets(lengths, max_len=max_len, num_buckets=groups)
            for n in (1, 3200, 5000, 10**6):
                assert port_loader.bucket_for(n, b) == jax_loader.bucket_for(n, b)


def test_native_decode_equals_python_reader(tmp_path):
    paths = []
    for i, n in enumerate([4000, 2500, 7000, 16000]):
        write_wav(tmp_path / f"w{i}.wav", n, seed=i)
        paths.append(str(tmp_path / f"w{i}.wav"))
    out, lens = port_native.decode_wav_batch(paths, max_len=8000)
    np.testing.assert_array_equal(lens, [4000, 2500, 7000, 8000])
    for i, p in enumerate(paths):
        ref = port_audio.read_wav(p)
        np.testing.assert_array_equal(out[i, :lens[i]], ref[:8000])
        assert not out[i, lens[i]:].any()
        assert port_native.wav_num_samples(p) == port_audio.wav_num_samples(p) == len(ref)
    offsets = np.array([0, 100, 3000, 9000])
    cropped, clens = port_native.decode_wav_batch(paths, max_len=4000, offsets=offsets)
    for i, p in enumerate(paths):
        ref = port_audio.read_wav(p)[offsets[i]:offsets[i] + 4000]
        np.testing.assert_array_equal(cropped[i, :clens[i]], ref)


def test_a_failed_native_decode_falls_back_for_the_batch(flickr_root, monkeypatch, caplog):
    ds = port_datasets.FlickrDataset(str(flickr_root), ["audio"], split="train")
    loader = port_loader.BucketedLoader(ds, batch_size=4, train=False, num_workers=2)
    reference = [b["wav"].copy() for b in loader]

    def boom(*a, **k):
        raise RuntimeError("native decode failed for 'w1.wav'")

    monkeypatch.setattr(port_native, "decode_wav_batch", boom)
    with caplog.at_level(logging.WARNING):
        fallback = [b["wav"].copy() for b in loader]
    assert "python fallback" in caplog.text
    assert len(fallback) == len(reference) > 0
    for a, b in zip(reference, fallback):
        np.testing.assert_array_equal(a, b)


def test_a_failed_native_jpeg_decode_falls_back_to_pil(flickr_root, monkeypatch):
    ds = port_datasets.FlickrDataset(str(flickr_root), ["audio", "image"], split="train",
                                     image_size=32, image_mode="raw")
    loader = port_loader.BucketedLoader(ds, batch_size=4, train=False, num_workers=2)

    def boom(*a, **k):
        raise RuntimeError("Unsupported JPEG (CMYK)")

    monkeypatch.setattr(port_native, "has_jpeg", lambda: True)
    monkeypatch.setattr(port_native, "decode_jpeg_batch", boom)
    batch = next(iter(loader))
    assert batch["image"].dtype == np.uint8 and batch["image"].shape[0] == 4
    assert batch["image"].any(axis=(1, 2, 3)).all()


def test_library_path_and_override(monkeypatch, tmp_path):
    """The library loads from native/libwavio.so beside the repository, or
    from SPEECHCLIP_WAVIO_PATH; a path that does not load leaves the Python
    readers."""
    assert port_native._lib_path() == jax_native._lib_path()
    monkeypatch.setattr(port_native, "_TRIED", False)
    monkeypatch.setattr(port_native, "_LIB", None)
    monkeypatch.setenv("SPEECHCLIP_WAVIO_PATH", str(tmp_path / "missing.so"))
    assert not port_native.available()
    bad = tmp_path / "bad.so"
    bad.write_bytes(b"not an ELF")
    monkeypatch.setattr(port_native, "_TRIED", False)
    monkeypatch.setenv("SPEECHCLIP_WAVIO_PATH", str(bad))
    assert not port_native.available()


def test_audio_helpers_equal_jax(tmp_path):
    from speechclip_tpu.data import audio as jax_audio

    write_wav(tmp_path / "a.wav", 5000, sr=8000, seed=3)
    np.testing.assert_array_equal(port_audio.read_wav(str(tmp_path / "a.wav")),
                                  jax_audio.read_wav(str(tmp_path / "a.wav")))
    wav = np.random.default_rng(0).standard_normal(9000).astype(np.float32)
    for max_len in (-1, 4000, 12000):
        a = port_audio.random_crop_max_length(wav, max_len, rng=np.random.default_rng(5))
        b = jax_audio.random_crop_max_length(wav, max_len, rng=np.random.default_rng(5))
        np.testing.assert_array_equal(a, b)
