"""The serving runtime (port of speechclip_tpu/serving.py): micro-batching,
wav-length buckets, round-robin over devices and a stdlib HTTP front, over
eager calls of the model's three surfaces with the params as arguments.

    python -m speechclip_tpu_torch.serving --ckpt <run>/ckpts/last --port 8787
    python -m speechclip_tpu_torch.serving --ckpt model.ckpt --platform cpu

- ``MicroBatcher`` gathers concurrent single-item requests into one device
  batch (up to ``max_batch``, waiting at most ``max_wait_ms`` after the
  first arrival); in pipelined mode a fetch thread reads batch N back while
  the worker launches batch N + 1.
- ``EncoderService`` (``from_checkpoint`` / ``from_model``) pads speech to
  its bucket's wav length (exact: the model masks by ``wav_len``), pads
  partial batches (to the next power of two, or to ``batch`` with
  ``fixed_batch``) and slices the results back; each request routes to the
  smallest bucket that fits, overlong audio crops to the largest.
- The HTTP front (``ThreadingHTTPServer``):

    POST /encode_speech   body: .npy float32 or int16 1-D waveform (16 kHz)
    POST /encode_image    body: JPEG bytes, or .npy uint8 (H, W, 3) any
                          size, or .npy float32 already CLIP-preprocessed
    POST /encode_text     body: JSON {"token_ids": [...], "eot_position": N}
    POST /gallery/add     body: an image payload; ?id=name optional
    POST /gallery/save    ?path= optional (defaults to --gallery; confined
                          to --gallery's directory)
    POST /gallery/load    ?path= optional (the same confinement)
    POST /retrieve        body: .npy wav; ?k=5&feat=parallel|cascaded
    GET  /healthz         endpoints, batching stats, gallery size

  Malformed input answers 400; a fault of the server (a kernel that does
  not build or launch, a closed batcher) answers 500 without its detail.

The model runs on the card unless ``--platform cpu`` (``device="cpu"``)
asks for the CPU. Each dispatch runs under ``torch.inference_mode()`` on
the thread that makes it (grad mode is thread-local, so a caller's
``no_grad`` does not reach a batcher's worker) and records a CUDA event
that the fetch waits on before it reads the features back. Nothing falls
back: a kernel that fails raises through the request. The AOT artifact
backend (``EncoderService(artifact_dir)``, ``--artifacts``) waits for the
export item of ROADMAP.md and raises.
"""

from __future__ import annotations

import copy
import io
import itertools
import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import EXPORT_ITEM
from .export import cast_float_params, encode_speech_surface

logger = logging.getLogger(__name__)


class MicroBatcher:
    """Coalesce concurrent single-item requests into device batches.

    ``batch_fn(items) -> list_of_results`` runs on a dedicated worker
    thread; ``submit`` returns a Future. After the first item of a batch
    arrives, the worker waits at most ``max_wait_ms`` for more, capping at
    ``max_batch`` items per call.

    Pipelined mode: with ``finalize_fn``, ``batch_fn`` is the dispatch stage
    (pack and launch, returning a handle without waiting for the device),
    and a fetch thread runs ``finalize_fn(handle) -> list_of_results`` (wait
    and copy to the host) and resolves the futures, so the worker launches
    batch N + 1 while batch N computes. ``pipeline_depth`` bounds the
    batches in flight (backpressure on the worker).
    """

    def __init__(self, batch_fn: Callable[[List], List], max_batch: int = 8,
                 max_wait_ms: float = 5.0, name: str = "",
                 finalize_fn: Optional[Callable] = None, pipeline_depth: int = 2):
        self._fn = batch_fn
        self._finalize = finalize_fn
        self.max_batch = int(max_batch)
        self._max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._submit_lock = threading.Lock()  # serializes submit against close
        self._stop = threading.Event()
        self.batches_run = 0
        self.items_run = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"microbatcher-{name}")
        self._fetch_q: Optional[queue.Queue] = None
        self._fetch_thread = None
        if finalize_fn is not None:
            self._fetch_q = queue.Queue(maxsize=max(int(pipeline_depth), 1))
            self._fetch_thread = threading.Thread(target=self._fetch_loop, daemon=True,
                                                  name=f"microbatcher-fetch-{name}")
            self._fetch_thread.start()
        self._thread.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        # the stop check and the put are atomic against close(): a put that
        # raced past a bare check could land after close() drained the queue
        # and leave its caller waiting forever
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("MicroBatcher is closed")
            self._q.put((item, fut))
        return fut

    def _loop(self):
        while not self._stop.is_set():
            try:
                pairs = [self._q.get(timeout=0.1)]
            except queue.Empty:
                continue
            deadline = time.monotonic() + self._max_wait
            while len(pairs) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    pairs.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            items = [it for it, _ in pairs]
            futs = [f for _, f in pairs]
            # counted before any future resolves: a caller it unblocks sees
            # the batch in the stats
            self.batches_run += 1
            self.items_run += len(items)
            try:
                out = self._fn(items)
            except Exception as exc:  # every waiter gets the error
                for fut in futs:
                    fut.set_exception(exc)
                continue
            if self._fetch_q is None:
                for fut, res in zip(futs, out):
                    fut.set_result(res)
            else:
                self._fetch_q.put((out, futs))  # blocks at pipeline_depth in flight
        if self._fetch_q is not None:
            self._fetch_q.put(None)  # the fetcher's shutdown sentinel

    def _fetch_loop(self):
        while True:
            entry = self._fetch_q.get()
            if entry is None:
                return
            handle, futs = entry
            try:
                results = self._finalize(handle)
                for fut, res in zip(futs, results):
                    fut.set_result(res)
            except Exception as exc:
                for fut in futs:
                    fut.set_exception(exc)

    def close(self):
        with self._submit_lock:  # no put lands after this block
            self._stop.set()
        self._thread.join(timeout=5.0)
        if self._fetch_thread is not None:
            self._fetch_thread.join(timeout=5.0)
        # whatever is still queued fails, so no caller waits on it forever
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError("MicroBatcher closed"))


def _static_dim(d) -> Optional[int]:
    """int for a fixed batch dim, None for a polymorphic one."""
    return int(d) if isinstance(d, (int, np.integer)) else None


def _tree_to(tree, device):
    """A copy of a params tree (dicts, lists, None) on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.detach().to(device) if torch.is_tensor(tree) else tree


class _EagerEncoder:
    """A model surface behind the service's encoder contract (``.in_avals``
    and ``.call(*args, device=)``): ``fn(model, *captures, *inputs)`` runs
    eagerly with the params (and state) as arguments. On a device other than
    the model's own, the model and its captures are copied there once, under
    a lock, and kept (JAX's ``_JitEncoder`` keeps one param copy per serving
    device the same way)."""

    def __init__(self, fn, model, captures, in_avals):
        self._fn = fn
        self._model = model
        self._captures = captures  # (params[, state])
        self._placed: Dict = {}
        self._placed_lock = threading.Lock()
        self.in_avals = list(in_avals)

    def _on(self, device):
        if device is None or torch.device(device) == self._model.device:
            return self._model, self._captures
        key = str(torch.device(device))
        with self._placed_lock:  # one copy per device, ever
            if key not in self._placed:
                model = copy.copy(self._model)
                model.device = torch.device(device)
                self._placed[key] = (model, _tree_to(self._captures, model.device))
            return self._placed[key]

    def call(self, *args, device=None):
        model, captures = self._on(device)
        inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(model.device) for a in args]
        if model.device.type != "cuda":
            return self._fn(model, *captures, *inputs)
        # the kernels launch on the current device's stream: make it this one
        with torch.cuda.device(model.device):
            return self._fn(model, *captures, *inputs)


class _Aval:
    """An input's declared shape and dtype: a None batch dim is polymorphic
    (coalesced batches pad to the next power of two), a number fixes every
    call's batch."""

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = np.dtype(dtype)


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def _cap_batch(max_batch: Optional[int], fixed_batch: Optional[int]) -> int:
    """The micro-batch cap never exceeds a fixed batch: otherwise whole
    coalesced batches would fail under load."""
    cap = max_batch or fixed_batch or 8
    return min(cap, fixed_batch) if fixed_batch is not None else cap


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host; bf16 as f32 (numpy has no bf16)."""
    t = t.detach()
    if t.is_floating_point() and t.dtype not in (torch.float32, torch.float64):
        t = t.float()
    return t.cpu().numpy()


def _speech_fn(model, params, state, wav, wav_len):
    return encode_speech_surface(model)(params, state, wav, wav_len)


def _image_fn(model, params, images):
    return model.forward_image(params, images)


def _text_fn(model, params, text, eot):
    return model.forward_text(params, text.long(), eot)


class EncoderService:
    """The encoder surfaces as padded, micro-batched callables, built by
    ``EncoderService.from_checkpoint(ckpt, ...)`` or ``.from_model(model,
    params, state, ...)``. ``EncoderService(artifact_dir)`` (the JAX
    package's AOT artifact backend) waits for the export item of ROADMAP.md
    and raises."""

    def __init__(self, artifact_dir: Optional[str] = None, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0, devices: Optional[Sequence] = None,
                 pipeline_depth: int = 2, gallery_max: Optional[int] = None,
                 _encoders: Optional[List] = None):
        if _encoders is None:
            if artifact_dir is None:
                raise TypeError("EncoderService needs an artifact_dir (or use "
                                "EncoderService.from_checkpoint / .from_model)")
            raise NotImplementedError(
                f"serving exported artifacts ({artifact_dir}) waits for {EXPORT_ITEM}; "
                "serve a checkpoint with EncoderService.from_checkpoint (--ckpt)")
        # round-robin over `devices`: the pipelined batchers launch batch
        # N + 1 on the next device while batch N computes; None = the
        # model's own device
        self._devices = list(devices) if devices else None
        self._rr = itertools.count()

        self._exported: Dict = {}
        speech_encoders = []
        for stem, encoder in _encoders:
            if stem == "encode_speech":
                speech_encoders.append(encoder)
            else:
                self._exported[stem] = encoder

        self.batchers: Dict[str, MicroBatcher] = {}
        # one bucket per wav length, ascending; a request takes the smallest
        # that fits, overlong audio crops to the largest
        self._speech_buckets: List[Dict] = []
        speech_encoders.sort(key=lambda e: int(e.in_avals[0].shape[1]))
        for encoder in speech_encoders:
            wav_aval = encoder.in_avals[0]
            self._speech_buckets.append({
                "exported": encoder,
                "wav_samples": int(wav_aval.shape[1]),
                "fixed_batch": _static_dim(wav_aval.shape[0]),
                # compact_wav buckets take int16 PCM to the device, else f32
                "wav_dtype": wav_aval.dtype,
            })
        for bucket in self._speech_buckets:
            # a lone bucket keeps the single-bucket name batchers["encode_speech"]
            name = ("encode_speech" if len(self._speech_buckets) == 1
                    else f"encode_speech@{bucket['wav_samples']}")
            bucket["batcher"] = self.batchers[name] = MicroBatcher(
                lambda wavs, b=bucket: self._speech_dispatch(wavs, b),
                max_batch=_cap_batch(max_batch, bucket["fixed_batch"]),
                max_wait_ms=max_wait_ms, name=name, finalize_fn=self._finalize_call,
                pipeline_depth=pipeline_depth)
        if self._speech_buckets:
            self.wav_samples = self._speech_buckets[-1]["wav_samples"]
            self.fixed_batch_speech = self._speech_buckets[-1]["fixed_batch"]
        if "encode_image" in self._exported:
            img_aval = self._exported["encode_image"].in_avals[0]
            self.fixed_batch_image = _static_dim(img_aval.shape[0])
            self.image_size = int(img_aval.shape[1])
            self.batchers["encode_image"] = MicroBatcher(
                self._image_dispatch, max_batch=_cap_batch(max_batch, self.fixed_batch_image),
                max_wait_ms=max_wait_ms, name="image", finalize_fn=self._finalize_call,
                pipeline_depth=pipeline_depth)
        if "encode_text" in self._exported:
            txt_aval = self._exported["encode_text"].in_avals[0]
            self.fixed_batch_text = _static_dim(txt_aval.shape[0])
            self.context_length = int(txt_aval.shape[1])
            self.batchers["encode_text"] = MicroBatcher(
                self._text_dispatch, max_batch=_cap_batch(max_batch, self.fixed_batch_text),
                max_wait_ms=max_wait_ms, name="text", finalize_fn=self._finalize_call,
                pipeline_depth=pipeline_depth)

        # the online retrieval gallery (L2-normalized image features),
        # bounded by gallery_max (FIFO eviction), saved and loaded as .npz
        self._gallery_lock = threading.Lock()
        self._gallery_ids: List[str] = []
        self._gallery_feats: List[np.ndarray] = []
        self._gallery_matrix: Optional[np.ndarray] = None
        self._gallery_max = int(gallery_max) if gallery_max else None
        self._gallery_seq = 0  # monotonic auto-id, survives eviction
        # the default file of /gallery/save and /gallery/load (--gallery)
        self.gallery_path: Optional[str] = None

    # ------------------------------------------------------------ backend
    @classmethod
    def from_model(cls, model, params, state, wav_buckets: Sequence[int] = (102400,),
                   batch: int = 8, dtype=None, compact_wav: bool = False,
                   fixed_batch: bool = False, **kw):
        """Serve an in-memory model: its three surfaces called eagerly with
        the params as arguments, behind the micro-batchers.

        ``wav_buckets``: one wav length per speech bucket. ``batch``: the
        micro-batch cap (unless ``max_batch`` is given); coalesced batches
        pad to the next power of two, or with ``fixed_batch=True`` to
        exactly ``batch``. ``dtype``: "bf16" (or a torch dtype) casts every
        float param (``export.cast_float_params``, the text tower's too).
        ``compact_wav``: the wav goes to the device as int16 PCM, rescaled
        by 1/32768 in the model (exact for int16-origin payloads, float ones
        quantize to the int16 grid)."""
        if dtype is not None:
            dtype = torch.bfloat16 if dtype in ("bf16", "bfloat16") else dtype
            params = cast_float_params(params, dtype)
        state = state or {}
        batch = int(batch)
        # `batch` caps the batchers unless max_batch is set (the CLI passes
        # max_batch=None when the flag is left out)
        if kw.get("max_batch") is None:
            kw["max_batch"] = batch
        wav_dtype = np.int16 if compact_wav else np.float32
        bdim = batch if fixed_batch else None
        encoders = [("encode_speech", _EagerEncoder(
            _speech_fn, model, (params, state), [_Aval((bdim, n), wav_dtype),
                                                 _Aval((bdim,), np.int32)]))
                    for n in sorted({int(b) for b in wav_buckets})]
        size = model.vision_cfg.image_size
        encoders.append(("encode_image", _EagerEncoder(
            _image_fn, model, (params,), [_Aval((bdim, size, size, 3), np.float32)])))
        ctx = model.clip_cfg.context_length
        encoders.append(("encode_text", _EagerEncoder(
            _text_fn, model, (params,), [_Aval((bdim, ctx), np.int32), _Aval((bdim,), np.int32)])))
        return cls(None, _encoders=encoders, **kw)

    @classmethod
    def from_checkpoint(cls, ckpt: str, wav_buckets: Sequence[int] = (102400,), batch: int = 8,
                        dtype=None, compact_wav: bool = False, device="cuda", **kw):
        """Serve a checkpoint: a run checkpoint of the port (the run's
        ``ckpts/last`` or another checkpoint directory, ``config.yaml``
        beside it) or a reference Lightning ``.ckpt``, restored by
        ``training.checkpoint.load_any_checkpoint`` on ``device`` (the card
        unless "cpu")."""
        from .training.checkpoint import load_any_checkpoint

        model, params, state = load_any_checkpoint(ckpt, device=device)
        return cls.from_model(model, params, state, wav_buckets=wav_buckets, batch=batch,
                              dtype=dtype, compact_wav=compact_wav, **kw)

    # ------------------------------------------------------------ speech
    def encode_speech(self, wav: np.ndarray) -> Dict[str, np.ndarray]:
        """One waveform -> feature dict, micro-batched in the bucket it
        routes to. float32 samples pass through; int16 PCM is rescaled by
        1/32768 (exact)."""
        if not self._speech_buckets:
            raise RuntimeError("no encode_speech surface loaded")
        wav = np.asarray(wav)
        if wav.squeeze().ndim > 1:
            # a batch flattened into one row would be one plausible wrong feature
            raise ValueError(f"encode_speech takes ONE 1-D waveform, got shape {wav.shape}; "
                             "send one request per utterance")
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        wav = wav.astype(np.float32).reshape(-1)
        return self._route_speech(len(wav))["batcher"].submit(wav).result()

    def _route_speech(self, n_samples: int) -> Dict:
        """The smallest bucket that fits; overlong audio -> the largest."""
        for bucket in self._speech_buckets:  # ascending
            if n_samples <= bucket["wav_samples"]:
                return bucket
        return self._speech_buckets[-1]

    def _dispatch(self, encoder, args, n, unpack, device=None):
        """Launch a packed batch on the round-robin device (or ``device``)
        under ``torch.inference_mode()``; -> a handle for _finalize_call,
        with a CUDA event recorded after the launches on the card."""
        if device is None and self._devices:
            device = self._devices[next(self._rr) % len(self._devices)]
        with torch.inference_mode():
            out = encoder.call(*args, device=device)
        event = None
        first = next(iter(out.values())) if isinstance(out, dict) else out
        if first.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(first.device))
        return out, n, unpack, event

    @staticmethod
    def _finalize_call(handle) -> List:
        out, n, unpack, event = handle
        if event is not None:
            event.synchronize()  # the batch's kernels are done before the copy
        return unpack(out, n)

    @staticmethod
    def _unpack_feature_dict(out, n: int) -> List[Dict]:
        out = {k: _to_numpy(v) for k, v in out.items()}
        return [{k: v[i] for k, v in out.items()} for i in range(n)]

    @staticmethod
    def _unpack_rows(out, n: int) -> List[np.ndarray]:
        out = _to_numpy(out)
        return [out[i] for i in range(n)]

    def _speech_dispatch(self, wavs: Sequence[np.ndarray], bucket: Dict, device=None):
        n = len(wavs)
        s = bucket["wav_samples"]
        dt = bucket["wav_dtype"]
        wav_arr = np.zeros((n, s), dt)
        wav_len = np.empty((n,), np.int32)
        for i, w in enumerate(wavs):
            if dt == np.int16:
                # int16 on the device (compact_wav): exact for int16-origin payloads
                w = np.clip(np.round(np.asarray(w, np.float32) * 32768.0),
                            -32768, 32767).astype(np.int16)
            else:
                w = np.asarray(w, np.float32)
            w = w.reshape(-1)[:s]  # crop overlong audio
            wav_arr[i, : len(w)] = w
            wav_len[i] = len(w)
        wav_arr, wav_len = self._pad_rows(wav_arr, wav_len, bucket["fixed_batch"], pad_len=s)
        return self._dispatch(bucket["exported"], (wav_arr, wav_len), n,
                              self._unpack_feature_dict, device=device)

    def _speech_batch(self, wavs: Sequence[np.ndarray], bucket: Dict, device=None) -> List[Dict]:
        """Dispatch and finalize at once (warmup, direct callers)."""
        return self._finalize_call(self._speech_dispatch(wavs, bucket, device))

    # ------------------------------------------------------------- image
    def encode_image(self, image) -> np.ndarray:
        """JPEG bytes / uint8 (H, W, 3) / preprocessed f32 -> feature."""
        if "encode_image" not in self._exported:
            raise RuntimeError("no encode_image surface loaded")
        return self.batchers["encode_image"].submit(self.preprocess_image(image)).result()

    def preprocess_image(self, image) -> np.ndarray:
        """-> (size, size, 3) float32, CLIP-normalized on the host (PIL)."""
        if "encode_image" not in self._exported:
            raise RuntimeError("no encode_image surface loaded")
        from .data.image import clip_preprocess_pil

        if isinstance(image, (bytes, bytearray)):
            from PIL import Image

            return clip_preprocess_pil(Image.open(io.BytesIO(image)), self.image_size)
        image = np.asarray(image)
        if image.dtype == np.uint8:
            from PIL import Image

            return clip_preprocess_pil(Image.fromarray(image), self.image_size)
        expect = (self.image_size, self.image_size, 3)
        if image.shape != expect:
            raise ValueError(f"float image must be preprocessed to {expect}, got {image.shape}")
        return image.astype(np.float32)

    def _image_dispatch(self, images: Sequence[np.ndarray], device=None):
        n = len(images)
        arr = np.stack([np.asarray(im, np.float32) for im in images])
        arr, _ = self._pad_rows(arr, None, self.fixed_batch_image)
        return self._dispatch(self._exported["encode_image"], (arr,), n, self._unpack_rows,
                              device=device)

    def _image_batch(self, images: Sequence[np.ndarray], device=None) -> List[np.ndarray]:
        return self._finalize_call(self._image_dispatch(images, device))

    # -------------------------------------------------------------- text
    def encode_text(self, token_ids: np.ndarray, eot_position: int) -> np.ndarray:
        """One tokenized caption (up to ``context_length`` ids, reduced ids
        under a reduced vocabulary) and its EOT index -> text feature."""
        if "encode_text" not in self._exported:
            raise RuntimeError("no encode_text surface loaded")
        ids = np.asarray(token_ids, np.int32).reshape(-1)
        if len(ids) > self.context_length:
            raise ValueError(f"{len(ids)} token ids exceed the context {self.context_length}")
        if not 0 <= int(eot_position) < len(ids):
            # an out-of-range gather would read another position's feature
            raise ValueError(f"eot_position {eot_position} outside the caption "
                             f"(0..{len(ids) - 1})")
        padded = np.zeros((self.context_length,), np.int32)
        padded[: len(ids)] = ids
        return self.batchers["encode_text"].submit((padded, int(eot_position))).result()

    def _text_dispatch(self, items: Sequence, device=None):
        n = len(items)
        ids = np.stack([ids for ids, _ in items])
        eots = np.asarray([eot for _, eot in items], np.int32)
        ids, eots = self._pad_rows(ids, eots, self.fixed_batch_text, pad_len=0)
        return self._dispatch(self._exported["encode_text"], (ids, eots), n, self._unpack_rows,
                              device=device)

    def _text_batch(self, items: Sequence, device=None) -> List[np.ndarray]:
        return self._finalize_call(self._text_dispatch(items, device))

    # ----------------------------------------------------------- helpers
    @staticmethod
    def _pad_rows(arr, lens, fixed_batch, pad_len=None):
        """Pad a partial batch with zero rows of full valid length
        ``pad_len`` (masks stay well-formed): to ``fixed_batch``, else to
        the next power of two (few batch shapes, all covered by warmup)."""
        n = arr.shape[0]
        if fixed_batch is None:
            target = _next_pow2(n)
        else:
            if n > fixed_batch:
                raise ValueError(f"batch {n} exceeds the fixed batch {fixed_batch}")
            target = fixed_batch
        if n == target:
            return arr, lens
        pad = target - n
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)
        if lens is not None:
            lens = np.concatenate([lens, np.full((pad,), pad_len, lens.dtype)], axis=0)
        return arr, lens

    # --------------------------------------------------------- retrieval
    # The gallery lives in process memory, persists as one .npz of ids and
    # L2-normalized features (gallery_save / gallery_load), and is bounded
    # by gallery_max: an add past the bound evicts the oldest entry, and a
    # load keeps the newest gallery_max rows.
    def gallery_add(self, image, image_id: Optional[str] = None) -> str:
        """Encode an image payload into the gallery; returns its id."""
        feat = np.asarray(self.encode_image(image), np.float32)
        feat = feat / max(float(np.linalg.norm(feat)), 1e-12)
        with self._gallery_lock:
            if image_id is None:
                image_id = str(self._gallery_seq)
            self._gallery_seq += 1
            self._gallery_ids.append(str(image_id))
            self._gallery_feats.append(feat)
            if self._gallery_max is not None and len(self._gallery_ids) > self._gallery_max:
                drop = len(self._gallery_ids) - self._gallery_max
                del self._gallery_ids[:drop]
                del self._gallery_feats[:drop]
            self._gallery_matrix = None  # rebuilt at the next retrieve
        return str(image_id)

    def gallery_size(self) -> int:
        with self._gallery_lock:
            return len(self._gallery_ids)

    def gallery_save(self, path: str) -> int:
        """Write the gallery (``ids``, ``feats``, ``seq``) as one .npz, the
        JAX package's format; -> rows written. Atomic: ``path.part``, then a
        rename."""
        with self._gallery_lock:
            ids = np.asarray(self._gallery_ids, dtype=np.str_)
            feats = (np.stack(self._gallery_feats) if self._gallery_feats
                     else np.zeros((0, 0), np.float32))
            seq = self._gallery_seq
        tmp = path + ".part"
        with open(tmp, "wb") as f:
            np.savez(f, ids=ids, feats=feats, seq=np.int64(seq))
        os.replace(tmp, path)
        return len(ids)

    def gallery_load(self, path: str) -> int:
        """Replace the gallery with a saved one; -> rows now live (the
        newest ``gallery_max`` where a bound is set)."""
        with np.load(path, allow_pickle=False) as data:
            ids = [str(s) for s in data["ids"]]
            feats = np.asarray(data["feats"], np.float32)
            seq = int(data["seq"]) if "seq" in data else len(ids)
        if feats.shape[0] != len(ids):
            raise ValueError(f"corrupt gallery artifact: {len(ids)} ids vs "
                             f"{feats.shape[0]} feature rows")
        if self._gallery_max is not None and len(ids) > self._gallery_max:
            ids = ids[-self._gallery_max:]
            feats = feats[-self._gallery_max:]
        with self._gallery_lock:
            self._gallery_ids = ids
            self._gallery_feats = [feats[i] for i in range(len(ids))]
            self._gallery_seq = max(seq, len(ids))
            self._gallery_matrix = None
        return len(ids)

    def retrieve(self, wav: np.ndarray, k: int = 5, feat: str = "parallel") -> List[Dict]:
        """Speech query -> the top-k gallery images by cosine score
        (``feat``: "parallel" | "cascaded"), ranked by host numpy's
        ``argsort(-scores)``, as the JAX service ranks them."""
        key = f"{feat}_audio_feat"
        feats = self.encode_speech(wav)
        if key not in feats:
            raise ValueError(f"audio feature {key!r} not served (available: {sorted(feats)})")
        q = np.asarray(feats[key], np.float32)
        q = q / max(float(np.linalg.norm(q)), 1e-12)
        with self._gallery_lock:
            if not self._gallery_ids:
                return []
            if self._gallery_matrix is None:  # adds are rare, retrievals hot
                self._gallery_matrix = np.stack(self._gallery_feats)
            gallery = self._gallery_matrix
            ids = list(self._gallery_ids)
        scores = gallery @ q
        order = np.argsort(-scores)[: max(int(k), 0)]
        return [{"id": ids[i], "score": float(scores[i])} for i in order]

    @staticmethod
    def _warm_sizes(fixed_batch: Optional[int], max_batch: int) -> List[int]:
        """The batch sizes a surface can see: one with a fixed batch (the
        padding makes it), else every power of two up to the cap."""
        if fixed_batch is not None:
            return [1]
        sizes, s = [], 1
        while s < _next_pow2(max_batch):
            sizes.append(s)
            s *= 2
        sizes.append(s)
        return sizes

    def warmup(self) -> None:
        """Run every surface at every batch shape ``_pad_rows`` can make, on
        every round-robin device, before taking traffic: the first call
        builds the kernels and fills the allocator's pools. Direct calls,
        so the batchers' stats count requests only."""
        for dev in self._devices or [None]:
            for bucket in self._speech_buckets:
                for n in self._warm_sizes(bucket["fixed_batch"], bucket["batcher"].max_batch):
                    self._speech_batch([np.zeros(16, np.float32)] * n, bucket, device=dev)
            if "encode_image" in self._exported:
                img = np.zeros((self.image_size, self.image_size, 3), np.float32)
                for n in self._warm_sizes(self.fixed_batch_image,
                                          self.batchers["encode_image"].max_batch):
                    self._image_batch([img] * n, device=dev)
            if "encode_text" in self._exported:
                item = (np.zeros(self.context_length, np.int32), 0)
                for n in self._warm_sizes(self.fixed_batch_text,
                                          self.batchers["encode_text"].max_batch):
                    self._text_batch([item] * n, device=dev)

    def stats(self) -> Dict:
        return {name: {"batches": b.batches_run, "items": b.items_run,
                       "max_batch": b.max_batch}
                for name, b in self.batchers.items()}

    def close(self):
        for b in self.batchers.values():
            b.close()


def drive_requests(service, wavs, n_req: int, concurrency: int):
    """Fire ``n_req`` encode_speech requests from ``concurrency`` client
    threads over the ``wavs`` pool (round-robin); -> (elapsed seconds,
    per-request latencies). Completion is thread ``join``: a client's
    exception stops the remaining work and re-raises here after every
    thread has joined."""
    remaining = [int(n_req)]
    lock = threading.Lock()
    latencies: List[float] = []
    errors: List[BaseException] = []

    def client():
        try:
            while True:
                with lock:
                    if remaining[0] == 0:
                        return
                    i = remaining[0] = remaining[0] - 1
                t0 = time.perf_counter()
                service.encode_speech(wavs[i % len(wavs)])
                dt = time.perf_counter() - t0
                with lock:
                    latencies.append(dt)
        except BaseException as e:  # noqa: BLE001 (re-raised in the caller)
            with lock:
                errors.append(e)
                remaining[0] = 0  # stop the other clients promptly

    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    elapsed = time.perf_counter() - t_start
    if errors:
        raise errors[0]
    return elapsed, latencies


# ---------------------------------------------------------------------------
# HTTP front end (stdlib only)
# ---------------------------------------------------------------------------
def make_http_server(service: EncoderService, host: str = "0.0.0.0", port: int = 8787):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    def image_payload(body: bytes):
        if body[:2] == b"\xff\xd8":  # JPEG magic
            return bytes(body)
        return np.load(io.BytesIO(body), allow_pickle=False)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet; the stats live in /healthz
            pass

        def _reply(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _gallery_target(self, qs):
            """The save/load file. ?path= is confined to --gallery's
            directory: these endpoints write and read the server's files for
            unauthenticated clients, so an unconfined path would be a remote
            arbitrary-file write."""
            requested = qs.get("path", [None])[0]
            default = service.gallery_path
            if requested is None:
                if not default:
                    raise ValueError("no ?path= and the service was started without --gallery")
                return default
            if not default:
                raise ValueError("?path= requires --gallery (it pins the one directory "
                                 "reachable over HTTP)")
            base = os.path.dirname(os.path.abspath(default)) or "."
            # a relative ?path= is inside the gallery directory, not the CWD
            if not os.path.isabs(requested):
                requested = os.path.join(base, requested)
            target = os.path.abspath(requested)
            if os.path.dirname(target) != base:
                raise ValueError(f"?path= must stay inside the --gallery directory {base}")
            return target

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._reply(200, {"status": "ok", "endpoints": sorted(service.batchers),
                                  "stats": service.stats(),
                                  "gallery_size": service.gallery_size()})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            qs = parse_qs(urlparse(self.path).query)
            try:
                if self.path.startswith("/encode_speech"):
                    feats = service.encode_speech(np.load(io.BytesIO(body), allow_pickle=False))
                    self._reply(200, {"features": {k: v.tolist() for k, v in feats.items()}})
                elif self.path.startswith("/gallery/save"):
                    path = self._gallery_target(qs)
                    self._reply(200, {"saved": service.gallery_save(path), "path": path})
                elif self.path.startswith("/gallery/load"):
                    path = self._gallery_target(qs)
                    self._reply(200, {"loaded": service.gallery_load(path), "path": path})
                elif self.path.startswith("/gallery/add"):
                    image_id = service.gallery_add(image_payload(body), qs.get("id", [None])[0])
                    self._reply(200, {"id": image_id, "gallery_size": service.gallery_size()})
                elif self.path.startswith("/retrieve"):
                    wav = np.load(io.BytesIO(body), allow_pickle=False)
                    hits = service.retrieve(wav, k=int(qs.get("k", ["5"])[0]),
                                            feat=qs.get("feat", ["parallel"])[0])
                    self._reply(200, {"results": hits})
                elif self.path.startswith("/encode_text"):
                    req = json.loads(body)
                    feat = service.encode_text(np.asarray(req["token_ids"], np.int32),
                                               int(req["eot_position"]))
                    self._reply(200, {"features": {"text_feat": feat.tolist()}})
                elif self.path.startswith("/encode_image"):
                    feat = service.encode_image(image_payload(body))
                    self._reply(200, {"features": {"image_feat": feat.tolist()}})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except (ValueError, KeyError) as exc:
                # malformed client input: a bad npy or JSON payload, missing
                # keys, an unknown feature, a gallery path outside its directory
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            except Exception as exc:
                # a fault of the server (a kernel build or launch, a closed
                # batcher, the file system): 500, the detail to the log only
                logger.exception("serving POST failed")
                self._reply(500, {"error": f"internal error ({type(exc).__name__})"})

    return ThreadingHTTPServer((host, port), Handler)


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    parser = argparse.ArgumentParser(prog="python -m speechclip_tpu_torch.serving")
    backend = parser.add_mutually_exclusive_group(required=True)
    backend.add_argument("--artifacts", help=f"a directory of exported artifacts ({EXPORT_ITEM})")
    backend.add_argument("--ckpt", help="a run checkpoint directory of the port or a reference "
                                        "Lightning .ckpt")
    parser.add_argument("--wav-samples", type=int, nargs="+", default=[102400],
                        help="one speech bucket per wav length")
    parser.add_argument("--batch", type=int, default=8, help="the micro-batch cap of a bucket")
    parser.add_argument("--dtype", default=None, choices=["bf16"],
                        help="cast every float weight before serving")
    parser.add_argument("--compact-wav", action="store_true",
                        help="ship the wav to the device as int16 PCM (half the bytes)")
    parser.add_argument("--gallery", default=None,
                        help="gallery .npz: loaded at startup when present, saved on a clean "
                             "shutdown, the default file of /gallery/save and /gallery/load")
    parser.add_argument("--gallery-max", type=int, default=None,
                        help="bound the gallery: adds past it evict the oldest entries")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--max-batch", type=int, default=None)
    parser.add_argument("--max-wait-ms", type=float, default=5.0)
    parser.add_argument("--platform", default=None, choices=["cpu"],
                        help="serve on the CPU (the default is the card)")
    parser.add_argument("--warmup", action="store_true",
                        help="run every surface at every batch shape before taking traffic")
    parser.add_argument("--devices", type=int, default=None,
                        help="round-robin the dispatched batches over the first N devices")
    args = parser.parse_args(argv)

    if args.artifacts:
        raise NotImplementedError(f"--artifacts waits for {EXPORT_ITEM}; serve --ckpt instead")
    device = "cpu" if args.platform == "cpu" else "cuda"
    devices = None
    if args.devices and args.devices > 1:
        devices = ([device] * args.devices if device == "cpu"
                   else [f"cuda:{i}" for i in range(args.devices)])
    service = EncoderService.from_checkpoint(
        args.ckpt, wav_buckets=args.wav_samples, batch=args.batch, dtype=args.dtype,
        compact_wav=args.compact_wav, device=device,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, devices=devices,
        gallery_max=args.gallery_max)
    if args.gallery:
        service.gallery_path = args.gallery
        if os.path.exists(args.gallery):
            n = service.gallery_load(args.gallery)
            print(f"gallery: loaded {n} entries from {args.gallery}", flush=True)
    if args.warmup:
        print("warming up...", flush=True)
        service.warmup()
    server = make_http_server(service, args.host, args.port)
    print(f"serving {', '.join(sorted(service.batchers))} on {args.host}:{args.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if args.gallery and service.gallery_size():
            n = service.gallery_save(args.gallery)
            print(f"gallery: saved {n} entries to {args.gallery}", flush=True)
        service.close()


if __name__ == "__main__":
    main()
