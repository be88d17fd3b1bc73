"""A CLIP wrapper for callers that drive CLIP directly (port of
speechclip_tpu/models/clip_api.py, the reference ``ClipModel``'s API):
``prep_image`` (paths -> pixels), ``prep_text`` (sentences -> token ids,
reduced where a reduced vocabulary is set, and EOT positions),
``deTokenize``, ``encode_image`` / ``encode_text`` / ``encode_keywords``
and ``get_scores``. The math is ``models/clip.py``'s; this object holds the
f32 params on one device and the host's id maps.

    clip = ClipWrapper("ViT-B/32", tokenizer=CLIPTokenizer())  # the card
    ids, eot = clip.prep_text(["a dog runs"])
    feats = clip.encode_text(ids, eot)

The params run on the card unless the caller asks for the CPU
(``device="cpu"``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import NAMED_CLIP_CONFIGS
from ..ops.retrieval import _full_f32_matmul
from . import clip as clip_mod
from .speechclip import cast_params, resolve_asset_path, resolve_device
from .tokenizer import EOT_TEXT, SOT_TEXT, CLIPTokenizer


class ClipWrapper:
    def __init__(
        self,
        name: str = "ViT-B/32",
        params=None,
        reduce_subword_embbedding: Optional[str] = None,
        pretrained_path: Optional[str] = None,
        tokenizer: Optional[CLIPTokenizer] = None,
        device="cuda",
        seed: int = 0,
    ):
        """``params``: the port's ``params["clip"]`` tree (``visual``,
        ``text``, ``logit_scale``); else the OpenAI / HF checkpoint at
        ``pretrained_path``; else a random init seeded with ``seed``. A
        full-size token table is cut to ``reduce_subword_embbedding``'s rows
        where that table is given. The towers are frozen: JAX's
        ``image_encoder_trainable`` / ``text_encoder_trainable`` flags, which
        its wrapper stores and never reads, are not taken."""
        self.name = name
        self.cfg = NAMED_CLIP_CONFIGS[name]
        self.tokenizer = tokenizer
        self.device = resolve_device(device)

        if params is None:
            if pretrained_path:
                from ..convert.from_torch import load_clip_checkpoint

                params = load_clip_checkpoint(pretrained_path, self.cfg)
            else:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                params = {"text": clip_mod.text_init(gen, self.cfg.text),
                          "visual": clip_mod.vision_init(gen, self.cfg.vision),
                          "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32)}

        self.reduced_vocab = None
        if reduce_subword_embbedding:
            self.reduced_vocab = clip_mod.load_reduced_vocab(
                resolve_asset_path(reduce_subword_embbedding))
            if params["text"]["token_embedding"].shape[0] == self.cfg.text.vocab_size:
                params = clip_mod.reduce_token_embedding(params, self.reduced_vocab)
        self.params = cast_params(params, torch.float32, self.device)

        full_sot, full_eot = self.cfg.text.vocab_size - 2, self.cfg.text.vocab_size - 1
        if self.reduced_vocab is not None:
            self.sot_id = self.reduced_vocab.original_to_reduced[full_sot]
            self.eot_id = self.reduced_vocab.original_to_reduced[full_eot]
        else:
            self.sot_id, self.eot_id = full_sot, full_eot

    @property
    def out_dim(self) -> int:
        return self.cfg.text.width

    # ------------------------------------------------------------- host prep
    def prep_image(self, paths: Sequence[str]) -> torch.Tensor:
        """-> (B, H, W, 3) normalized f32 pixels on the device."""
        from ..data.image import load_image

        size = self.cfg.vision.image_size
        return torch.from_numpy(np.stack([load_image(p, size) for p in paths])).to(self.device)

    def prep_text(self, sents: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (ids (B, 77), EOT positions (B,)) on the device; the ids are
        reduced where a reduced vocabulary is set."""
        if self.tokenizer is None:
            raise ValueError("prep_text needs a tokenizer")
        ids = self.tokenizer.tokenize(list(sents))
        eot_positions = np.argmax(ids == self.tokenizer.eot_id, axis=1)
        if self.reduced_vocab is not None:
            ids = self.reduced_vocab.map_original(ids)
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(eot_positions).to(self.device))

    def deTokenize(self, ids) -> List[str]:
        """Rows of ids (reduced ones mapped back) -> text without the
        special tokens."""
        if self.tokenizer is None:
            raise ValueError("deTokenize needs a tokenizer")
        arr = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
        if arr.ndim == 1:
            arr = arr[None]
        out = []
        for row in arr:
            row = [int(i) for i in row]
            if self.reduced_vocab is not None:
                row = [self.reduced_vocab.reduced_to_original[i] for i in row]
            text = self.tokenizer.decode(row).replace(SOT_TEXT, "").replace(EOT_TEXT, "")
            out.append(text.strip())
        return out

    # ---------------------------------------------------------------- encode
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return clip_mod.encode_image(self.params, self.cfg.vision, images.to(self.device))

    def encode_text(self, text: torch.Tensor,
                    eot_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if eot_positions is not None:
            eot_positions = eot_positions.to(self.device)
        return clip_mod.encode_text(self.params, self.cfg.text, text.to(self.device),
                                    eot_positions)

    def encode_keywords(self, keywords: torch.Tensor, keyword_num: int) -> torch.Tensor:
        if keywords.shape[1] != keyword_num:
            raise ValueError(f"keywords {tuple(keywords.shape)}: expected {keyword_num} rows")
        return clip_mod.encode_keywords(self.params, self.cfg.text, keywords.to(self.device),
                                        self.sot_id, self.eot_id)

    def get_scores(self, images: torch.Tensor, text: torch.Tensor,
                   eot_positions: Optional[torch.Tensor] = None):
        """-> (logits per image, logits per text), f32 with TF32 off."""
        if eot_positions is not None:
            eot_positions = eot_positions.to(self.device)
        with _full_f32_matmul():
            return clip_mod.get_scores(self.params, self.cfg.vision, self.cfg.text,
                                       images.to(self.device), text.to(self.device),
                                       eot_positions)
