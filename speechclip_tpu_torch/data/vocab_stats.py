"""Subword-usage tables for the reduced vocabulary (port of
speechclip_tpu/data/vocab_stats.py).

Tokenize every caption of a corpus, count each token id, and save the
``(token_id, count)`` tables that ``clip.reduce_subword_embbedding`` reads:
``text_clip_vocab_usage_byID.npy`` (ascending id) and
``text_clip_vocab_usage_byfreq.npy`` (descending count, ties by ascending
id), each with a ``.txt`` copy.

    python -m speechclip_tpu_torch.data.vocab_stats --dataset flickr \\
        --dataset_root data/flickr --output_dir /tmp/flickr_stat [--bpe_path ...]

The shipped tables (``assets/{flickr,coco}_stat/``) are the reference's
own, whose tie order no numpy sort reproduces; a table made here serves a
new corpus.
"""

from __future__ import annotations

import argparse
import os
from collections import Counter
from typing import Iterable

import numpy as np


def compute_vocab_usage(texts: Iterable[str], tokenizer) -> np.ndarray:
    """-> (V_used, 2) int64 rows [token_id, count], ascending id. Counts the
    whole padded 77-token buffer of each caption, pad id 0 included (the
    reference's stat script flattens ``clip.tokenize``'s output, so row 0 of
    a byfreq table is the pad and rows 2 / 3 are SOT / EOT, which the VQ's
    ``prob_msk`` masks). ``truncate=False``: a caption longer than the
    context raises, as ``clip.tokenize``'s default does there."""
    counter: Counter = Counter()
    for text in texts:
        counter.update(int(i) for i in tokenizer.tokenize(text, truncate=False)[0])
    return np.array(sorted(counter.items()), dtype=np.int64)


def save_vocab_usage(data: np.ndarray, output_dir: str) -> None:
    """Write the byID (ascending id) and byfreq (descending count, ties by
    ascending id: a lexsort, stable across numpy versions) tables as
    ``.npy`` and as ``.txt`` ("id count" lines)."""
    os.makedirs(output_dir, exist_ok=True)
    by_id = data[data[:, 0].argsort()]
    by_freq = by_id[np.lexsort((by_id[:, 0], -by_id[:, 1]))]
    for name, arr in (("byID", by_id), ("byfreq", by_freq)):
        base = os.path.join(output_dir, f"text_clip_vocab_usage_{name}")
        np.save(base + ".npy", arr)
        with open(base + ".txt", "w") as f:
            for tok_id, count in arr:
                f.write(f"{tok_id} {count}\n")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", choices=["flickr", "coco"], required=True)
    parser.add_argument("--dataset_root", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--split_prefix", default="SpokenCOCO")
    parser.add_argument("--bpe_path", default=None)
    args = parser.parse_args(argv)

    from ..models.tokenizer import CLIPTokenizer
    from .datasets import FlickrDataset, SpokenCOCODataset

    tokenizer = CLIPTokenizer(args.bpe_path)
    texts = []
    if args.dataset == "flickr":
        for split in ("train", "dev", "test"):
            ds = FlickrDataset(args.dataset_root, split=split, modalities=["text"])
            texts += [e["text"] for e in ds.data]
    else:
        for split in ("train", "val", "test"):
            ds = SpokenCOCODataset(args.dataset_root, split=split, modalities=["text"],
                                   split_prefix=args.split_prefix)
            texts += [e["text"] for e in ds.data]
    data = compute_vocab_usage(texts, tokenizer)
    save_vocab_usage(data, args.output_dir)
    print(f"saved vocab usage for {len(data)} subwords to {args.output_dir}")


if __name__ == "__main__":
    main()
