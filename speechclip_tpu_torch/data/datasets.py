"""Datasets: Flickr8k (spoken captions) and SpokenCOCO (port of
speechclip_tpu/data/datasets.py: the same entries in the same order, the
same pair ids, the same ``raw_decode_size``).

Flickr8k root/
  Flickr_8k.{train,dev,test}Images.txt     split lists
  flickr_audio/wavs[_with_no_silence]/     <img>_<n>.wav (5 per image)
  Flickr8k.token.txt | captions.txt        captions ("img#N caption" / CSV)
  Images/                                  jpgs
  Flickr8k_idPairs.json                    image <-> pair-id map (generated
                                           here if missing)

SpokenCOCO root/
  SpokenCOCO/{prefix}_{split}.json         {"data": [{image, captions:[{wav,
                                           text}], reassign_id?}]}
  mscoco_img/                              images

Samples are dicts of file paths and a pair id; decoding happens in the
loader's worker threads.
"""

from __future__ import annotations

import json
import logging
import os
import re
from collections import defaultdict
from typing import Dict, List

from .audio import read_wav, wav_num_samples
from .image import load_image, load_image_raw

logger = logging.getLogger(__name__)


class PairedDataset:
    """Index of {wav path, image path, caption text, pair id} entries."""

    def __init__(
        self,
        dataset_root: str,
        split: str,
        modalities: List[str],
        target_sr: int = 16_000,
        image_size: int = 224,
        tokenizer=None,
        image_mode: str = "clip",  # "clip" (host preprocess) | "raw" (uint8,
        # resize+normalize batched on device — BASELINE.json north star)
    ):
        assert modalities, "Dataset's modalities cannot be none"
        assert image_mode in ("clip", "raw"), image_mode
        self.dataset_root = dataset_root
        self.split = split
        self.modalities = modalities
        self.target_sr = target_sr
        self.image_size = image_size
        self.image_mode = image_mode
        self.tokenizer = tokenizer
        self.data: List[Dict] = []

    def __len__(self) -> int:
        return len(self.data)

    def wav_length(self, index: int) -> int:
        path = self.data[index]["wav"]
        from . import native

        if native.available():
            try:
                return native.wav_num_samples(path, self.target_sr)
            except RuntimeError:
                pass
        return wav_num_samples(path, self.target_sr)

    def __getitem__(self, index: int) -> Dict:
        return self.get_item(index)

    @property
    def raw_decode_size(self) -> int:
        """Host-decode square size for image_mode="raw" (device does the
        final bicubic resize + normalize)."""
        return max(self.image_size + 32, 256 * self.image_size // 224)

    def get_item(
        self, index: int, skip_wav: bool = False, skip_image: bool = False
    ) -> Dict:
        entry = self.data[index]
        out: Dict = {"id": entry["id"]}
        if "wav" in entry and not skip_wav:
            out["wav"] = read_wav(entry["wav"], self.target_sr)
        if "image" in entry and not skip_image:
            if self.image_mode == "raw":
                # cheap decode to a fixed uint8 square; the bicubic resize +
                # normalize runs batched on device (data/image.py)
                out["image"] = load_image_raw(entry["image"], self.raw_decode_size)
            else:
                out["image"] = load_image(entry["image"], self.image_size)
        if "text" in entry:
            if self.tokenizer is not None:
                out["text"] = self.tokenizer.tokenize(entry["text"])[0]
            else:
                out["text"] = entry["text"]
        return out


def _generate_id_pairs(dataset_root: str, image_names: List[str]) -> dict:
    """Deterministic image -> pair-id map (sorted names), generated on demand
    and written beside the corpus when the directory allows."""
    names = sorted(set(image_names))
    filename2Id = {n: i for i, n in enumerate(names)}
    id2Filename = {i: n for n, i in filename2Id.items()}
    payload = {"id2Filename": id2Filename, "filename2Id": filename2Id}
    path = os.path.join(dataset_root, "Flickr8k_idPairs.json")
    try:
        with open(path, "w") as f:
            json.dump(payload, f)
        logger.info("generated %s", path)
    except OSError:
        logger.warning("could not persist %s; using in-memory ids", path)
    return payload


class FlickrDataset(PairedDataset):
    def __init__(
        self,
        dataset_root: str,
        modalities: List[str],
        split: str = "train",
        text_file: str = "Flickr8k.token.txt",
        wav_rm_silence: bool = False,
        target_sr: int = 16_000,
        image_size: int = 224,
        tokenizer=None,
        image_mode: str = "clip",
        **kwargs,
    ):
        super().__init__(
            dataset_root, split, modalities, target_sr, image_size, tokenizer,
            image_mode,
        )
        image_list_txt = os.path.join(
            dataset_root, f"Flickr_8k.{split}Images.txt"
        )
        wav_dir = "wavs_with_no_silence" if wav_rm_silence else "wavs"
        wav_base = os.path.join(dataset_root, "flickr_audio", wav_dir)
        wav_list = os.listdir(wav_base)
        # "<image>_<n>.wav" -> image name strips the "_<n>.wav" suffix
        wav_names = {p[:-6] for p in wav_list if p.endswith(".wav")}
        wav_names_to_paths = defaultdict(list)
        for p in wav_list:
            name = p[:-6]
            if name in wav_names:
                wav_names_to_paths[name].append(os.path.join(wav_base, p))

        captions = self._parse_captions(
            os.path.join(dataset_root, text_file), text_file
        )

        id_pairs_path = os.path.join(dataset_root, "Flickr8k_idPairs.json")
        if os.path.exists(id_pairs_path):
            with open(id_pairs_path) as f:
                filename2Id = json.load(f)["filename2Id"]
        else:
            filename2Id = _generate_id_pairs(dataset_root, list(wav_names))[
                "filename2Id"
            ]

        with open(image_list_txt) as fp:
            for line in fp:
                line = line.strip()
                if not line:
                    continue
                image_name = line.split(".")[0]
                image_path = os.path.join(dataset_root, "Images", line)
                if image_name not in wav_names:
                    # the wav filter applies to every modality
                    # combination, image-only included
                    continue
                if "audio" in modalities or "text" in modalities:
                    for p in sorted(wav_names_to_paths[image_name]):
                        stem = os.path.basename(p).split("_")[-1].replace(".wav", "")
                        if "txt" in stem:  # skip tts "_txt" wavs
                            continue
                        entry: Dict = {"id": int(filename2Id[image_name])}
                        sub_id = int(stem)
                        if "audio" in modalities:
                            entry["wav"] = p
                        if "image" in modalities:
                            entry["image"] = image_path
                        if "text" in modalities:
                            entry["text"] = captions[image_name][sub_id]
                        self.data.append(entry)
                else:
                    self.data.append(
                        {"image": image_path, "id": int(filename2Id[image_name])}
                    )
        logger.info("Flickr8k (%s): %d samples", split, len(self.data))

    @staticmethod
    def _parse_captions(path: str, text_file: str) -> Dict[str, List[str]]:
        assert text_file in (
            "captions.txt",
            "Flickr8k.lemma.token.txt",
            "Flickr8k.token.txt",
        ), text_file
        captions: Dict[str, List[str]] = defaultdict(list)
        with open(path) as f:
            if text_file == "captions.txt":  # CSV: image.jpg,caption
                for line in f:
                    if line.strip() == "image,caption":
                        continue
                    img_name, caption = line.split(".jpg,")
                    caption = caption.lower().strip().rstrip(".").strip()
                    captions[img_name].append(caption)
            else:  # "img.jpg#N\tcaption"
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    # maxsplit=1: a caption holding '#1' still parses
                    img_name, caption = re.split("#[0-9]", line, maxsplit=1)
                    img_name = img_name.replace(".jpg", "")
                    caption = caption.strip().rstrip(".").strip()
                    captions[img_name].append(caption)
        return captions


class SpokenCOCODataset(PairedDataset):
    def __init__(
        self,
        dataset_root: str,
        modalities: List[str],
        split: str = "train",
        split_prefix: str = "SpokenCOCO",
        target_sr: int = 16_000,
        image_size: int = 224,
        tokenizer=None,
        image_mode: str = "clip",
        **kwargs,
    ):
        super().__init__(
            dataset_root, split, modalities, target_sr, image_size, tokenizer,
            image_mode,
        )
        assert split in ("train", "val", "test")
        json_path = os.path.join(
            dataset_root, "SpokenCOCO", f"{split_prefix}_{split}.json"
        )
        with open(json_path) as f:
            raw = json.load(f)["data"]
        for entry in raw:
            if split_prefix != "SpokenCOCO":  # ksplit carries reassigned ids
                data_id = int(entry["reassign_id"])
            else:
                data_id = int(
                    entry["image"].split("_")[-1].replace(".jpg", "")
                )
            image_path = os.path.join(dataset_root, "mscoco_img", entry["image"])
            if "audio" in modalities or "text" in modalities:
                for cap in entry["captions"]:
                    e: Dict = {"id": data_id}
                    if "audio" in modalities:
                        e["wav"] = os.path.join(
                            dataset_root, "SpokenCOCO", cap["wav"]
                        )
                    if "image" in modalities:
                        e["image"] = image_path
                    if "text" in modalities:
                        e["text"] = cap["text"].lower()
                    self.data.append(e)
            else:
                self.data.append({"image": image_path, "id": data_id})
        logger.info("SpokenCOCO (%s): %d samples", split, len(self.data))


DATASETS = {"flickr": FlickrDataset, "coco": SpokenCOCODataset}


def build_dataset(
    data_cfg, split: str, tokenizer=None, image_size: int = 224
) -> PairedDataset:
    """Construct from the config block (config data.dataset schema)."""
    name = data_cfg.dataset.name
    modalities = ["audio", "image"]
    if data_cfg.dataset.get("tokenizeText", False) and tokenizer is not None:
        modalities.append("text")
    cls = DATASETS[name]
    return cls(
        dataset_root=data_cfg.dataset.dataset_root,
        modalities=modalities,
        split=split,
        text_file=data_cfg.dataset.get("text_file", "Flickr8k.token.txt"),
        split_prefix=data_cfg.dataset.get("split_prefix", "SpokenCOCO"),
        wav_rm_silence=data_cfg.dataset.get("wav_rm_silence", False),
        image_size=data_cfg.dataset.get("image_size", image_size),
        tokenizer=tokenizer,
        image_mode=(
            "raw" if data_cfg.dataset.get("on_device_preprocess", False) else "clip"
        ),
    )
