"""CLIP byte-pair-encoding tokenizer, host side (port of
speechclip_tpu/models/tokenizer.py, which the port keeps its own copy of).

Lower-cased byte-level BPE over CLIP's ``bpe_simple_vocab_16e6.txt.gz``
merges list: 256 byte symbols, their 256 ``</w>`` word-end forms, the
merges (48 894 in CLIP's file) and ``<|startoftext|>`` /
``<|endoftext|>``, so CLIP's file gives 49 408 ids with SOT 49406 and EOT
49407. Text cleaning: ``_fix_mojibake`` (ftfy's core repair: cp1252 /
latin-1 re-decoded as UTF-8, at most twice, then NFC), a double HTML
unescape and whitespace folding.

The merges file is not in the repository: pass its path, point
``SPEECHCLIP_BPE_PATH`` at it, or put it at
``<repo>/assets/bpe_simple_vocab_16e6.txt.gz``. ``regex`` (for the
``\\p{L}`` / ``\\p{N}`` classes of the token pattern) is imported on first
use, not when the module is imported. No tensors: ``tokenize`` returns
numpy.
"""

from __future__ import annotations

import functools
import gzip
import html
import logging
import os
import unicodedata
from pathlib import Path
from typing import Iterable, List, Sequence, Union

import numpy as np

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
CONTEXT_LENGTH = 77
BPE_FILE = "bpe_simple_vocab_16e6.txt.gz"
REPO_ROOT = Path(__file__).resolve().parents[2]
logger = logging.getLogger(__name__)


@functools.lru_cache(maxsize=None)
def _regex():
    import regex

    return regex


@functools.lru_cache(maxsize=None)
def _token_pattern():
    re = _regex()
    return re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        re.IGNORECASE,
    )


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict:
    """Reversible byte -> printable-unicode map (GPT-2 convention)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# The repair fires on a classic marker ('Ã' / 'Â': Latin-1-range 2-byte
# UTF-8 leads; 'â': the 3-byte E2 class of smart quotes, dashes, '€') or on
# two or more cp1252 renderings of a UTF-8 lead byte (0xC2-0xF4): real
# prose like "Spaß”" has one such letter, mojibake one per character.
_MOJIBAKE_CLASSIC = ("Ã", "Â", "â")
_MOJIBAKE_LEADS = frozenset(bytes([b]).decode("cp1252") for b in range(0xC2, 0xF5))


def _fix_mojibake(text: str) -> str:
    """Text that was UTF-8 but was decoded as cp1252 / latin-1, re-encoded
    and decoded as UTF-8 (twice heals a double encoding), where the marker
    test says it looks like mojibake; NFC-normalized always (ftfy's
    default). A rewrite is logged at DEBUG."""
    looks_mojibake = any(m in text for m in _MOJIBAKE_CLASSIC) or (
        sum(c in _MOJIBAKE_LEADS for c in text) >= 2)
    if not looks_mojibake:
        return unicodedata.normalize("NFC", text)
    original = text
    for _ in range(2):
        try:
            raw = text.encode("cp1252")
        except UnicodeEncodeError:
            try:
                raw = text.encode("latin-1")
            except UnicodeEncodeError:
                break
        try:
            fixed = raw.decode("utf-8")
        except UnicodeDecodeError:
            break
        if fixed == text:
            break
        text = fixed
    if text != original:
        logger.debug("mojibake repair fired: %r -> %r", original, text)
    return unicodedata.normalize("NFC", text)


def _clean(text: str) -> str:
    text = _fix_mojibake(text)
    text = html.unescape(html.unescape(text))
    text = _regex().sub(r"\s+", " ", text)
    return text.strip()


def _get_pairs(word: Sequence[str]) -> set:
    return {(a, b) for a, b in zip(word[:-1], word[1:])}


def default_bpe_path() -> str | None:
    """``SPEECHCLIP_BPE_PATH`` where that file exists, else
    ``<repo>/assets/bpe_simple_vocab_16e6.txt.gz`` where it exists, else
    None."""
    env = os.environ.get("SPEECHCLIP_BPE_PATH")
    if env and os.path.exists(env):
        return env
    here = REPO_ROOT / "assets" / BPE_FILE
    return str(here) if here.exists() else None


class CLIPTokenizer:
    def __init__(self, bpe_path: str | None = None, max_merges: int = 48894):
        bpe_path = bpe_path or default_bpe_path()
        if bpe_path is None:
            raise FileNotFoundError(
                "CLIP BPE merges file not found; set SPEECHCLIP_BPE_PATH or pass bpe_path "
                f"(expected {BPE_FILE}).")
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in lines[1:max_merges + 1] if line]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT_TEXT, EOT_TEXT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}

    @property
    def sot_id(self) -> int:
        return self.encoder[SOT_TEXT]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT_TEXT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean(text).lower()
        for token in _token_pattern().findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        """Ids -> text: the special tokens pass through literally, the rest
        goes back through the byte decoder, ``</w>`` becomes a space."""
        text = "".join(self.decoder[int(i)] for i in ids)
        buf = bytearray()
        res: List[str] = []
        idx = 0
        while idx < len(text):
            special = next((s for s in (SOT_TEXT, EOT_TEXT) if text.startswith(s, idx)), None)
            if special is not None:
                res.append(buf.decode("utf-8", errors="replace") if buf else "")
                buf = bytearray()
                res.append(special)
                idx += len(special)
            else:
                ch = text[idx]
                if ch in self.byte_decoder:
                    buf.append(self.byte_decoder[ch])
                idx += 1
        if buf:
            res.append(buf.decode("utf-8", errors="replace"))
        return "".join(res).replace("</w>", " ")

    def tokenize(self, texts: Union[str, Sequence[str]], context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        """-> (B, context_length) int64 rows [SOT, ids..., EOT, 0...]. A text
        too long for the context is cut with EOT kept last, or raises when
        ``truncate`` is False (``clip.tokenize``'s contract)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), np.int64)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > context_length:
                if not truncate:
                    raise RuntimeError(f"input too long for context {context_length}: {text!r}")
                ids = ids[:context_length]
                ids[-1] = self.eot_id
            out[i, :len(ids)] = ids
        return out
