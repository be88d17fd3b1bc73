"""The trainer: fit and validate (port of speechclip_tpu/training/trainer.py).

    trainer = Trainer(load_config("configs/base/spchclp_p.yaml"))
    state = trainer.fit()                      # or fit(resume="auto")
    metrics = trainer.validate(state, split="test")

A run reads its config tree, builds the bucketed Flickr8k / SpokenCOCO
loaders, fills the image-feature cache (``trainer.cache_image_features``:
the frozen image tower run once over the unique images), then loops over
epochs: train steps (``train_step.make_train_step``) on batches staged on
the card ahead of use, metrics logged every ``trainer.log_every_n_steps``,
and every ``trainer.check_val_every_n_epoch`` epochs a validation (losses
over the full batches, recall@k both ways; for the cascaded branch with a
tokenizer, the keyword diagnostics of ``run_keyword_diagnostics``) and the
checkpoints of ``CheckpointManager``'s policy. ``fit(resume=...)``
continues a run from a checkpoint; ``resume="auto"`` from the run's own
``ckpts/last``.

Data parallelism: ``Trainer(config, mesh=make_mesh(...))`` in each rank
of a ``torch.distributed`` world (``parallel/mesh.py``; the CLI's
``--devices N`` spawns one). Every rank builds the same loaders from the
same seed and takes its rows of each global batch; the train and eval steps
gather what the global batch's math needs, so the losses, recalls and
keyword diagnostics are world 1's. JAX's divisibility rules hold:
``data.batch_size`` and the eval batch size must divide over the ranks, and
a ragged trailing train batch is skipped. The image-feature cache is rank
0's on every rank. Rank 0 alone writes the metrics logs, the checkpoints
and ``ckpt_index.json``; the ranks wait for its saves.

Tensor parallelism: ``trainer.model_parallel: M`` lays the world out as
``(world / M, M)`` (``make_mesh(model=M)``, JAX's ``make_mesh(data,
model)``): the data size is world / M, and each model group of M ranks
splits the transformer matrices of the towers and the branches
(``parallel/tensor.py``); fit, validation and the image-feature cache run
on that mesh. Checkpoints hold the full layout (gathered before rank 0
saves), so a run saved at ``(data 2, model 2)`` restores at world 1 and
the other way round. The host waits on the card only at log points and in
validation, where it reads values back.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ConfigTree, model_config_from_tree
from ..data.datasets import build_dataset
from ..data.loader import BucketedLoader
from ..models.speechclip import SpeechCLIPModel
from ..ops.schedules import get_schedule
from ..parallel import collectives
from ..parallel import tensor as tp
from ..parallel.mesh import DataMesh, make_mesh
from ..utils import tracing
from .checkpoint import STATE_FILE, CheckpointManager
from .evaluation import collect_validation_outputs, retrieval_metrics, run_keyword_diagnostics
from .logging import MetricsLogger
from .optim import build_optimizer
from .train_step import (
    TrainState,
    create_train_state,
    device_prefetch,
    gather_state,
    make_eval_step,
    make_train_step,
    place_state,
    shard_batch,
    staged,
    to_device,
)

logger = logging.getLogger(__name__)


def _inject_cached_image_feats(batch: Dict[str, np.ndarray], cache: np.ndarray,
                               id2row: Dict[int, int]) -> Dict[str, np.ndarray]:
    """Swap the batch's pixels for the frozen image tower's cached features,
    gathered by pair id (a copy)."""
    with tracing.span("speechclip.fit.image_feats"):
        batch = dict(batch)
        rows = np.fromiter((id2row[int(i)] for i in batch["id"]), np.int64, len(batch["id"]))
        batch["image_feat_frozen"] = cache[rows]
        batch.pop("image", None)
        return batch


def _pad_batch(batch: Dict[str, np.ndarray], size: int) -> Tuple[Dict[str, np.ndarray], int]:
    """A ragged eval batch padded to ``size`` rows -> (batch, real rows).
    Cached features pad by edge replication (a zero row would normalize to
    NaN); padded ids are negative, so they match no real pair in the loss."""
    n = len(batch["id"])
    if n == size:
        return batch, n
    out = {}
    for k, v in batch.items():
        pad_width = [(0, size - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width, mode="edge" if k == "image_feat_frozen" else "constant")
    out["id"][n:] = -np.arange(1, size - n + 1)
    return out, n


def _first_leaf(tree):
    """The first leaf in sorted-key order (jax.tree_util's leaf order)."""
    while isinstance(tree, (dict, list, tuple)):
        tree = tree[sorted(tree)[0]] if isinstance(tree, dict) else tree[0]
    return tree


class Trainer:
    def __init__(self, config: ConfigTree, workdir: Optional[str] = None, tokenizer=None,
                 device="cuda", mesh: Optional[DataMesh] = None):
        """``mesh``: this rank's ``(data, model)`` world, whose model axis
        must be ``trainer.model_parallel`` (default: ``device`` alone, world
        1, where ``model_parallel`` must be 1)."""
        model_axis = int(config.get_path("trainer.model_parallel", 1) or 1)
        self.mesh = mesh or make_mesh(devices=[device], model=model_axis)
        if self.mesh.model_size != model_axis:
            raise ValueError(f"trainer.model_parallel={model_axis} but the mesh's model axis "
                             f"has {self.mesh.model_size} rank(s)")
        self.n_data = self.mesh.data_size
        self.rank0 = self.mesh.rank == 0
        device = self.mesh.device
        self.config = config
        self.workdir = workdir or config.get_path("trainer.default_root_dir", "exp/run")
        os.makedirs(self.workdir, exist_ok=True)
        self.seed = int(config.get_path("seed", 7122))
        if config.get_path("trainer.fast_rng", False):
            logger.info("trainer.fast_rng (JAX's rbg PRNG) has no effect in the port: dropout "
                        "draws from the train state's torch.Generator")
        self.model = SpeechCLIPModel(model_config_from_tree(config), device=device)
        self.tokenizer = tokenizer
        self.recall_at = list(config.get_path("retrieval.recall_at", [1, 5, 10]))
        self._accum = int(config.get_path("trainer.accumulate_grad_batches", 1) or 1)
        sched = self.model.config.scheduler
        self.schedule = get_schedule(sched.name, self.model.config.optim.lr, warmup=sched.warmup,
                                     max_step=sched.max_step, final_lr=sched.final_lr)
        self._slim = not config.get_path("trainer.checkpoint_frozen", True)
        self.ckpt = CheckpointManager(
            os.path.join(self.workdir, "ckpts"),
            save_at_steps=config.get_path("trainer.save_at_steps", []) or [])
        self.metrics_logger = MetricsLogger(
            self.workdir, backend=config.get_path("trainer.logger", "tb"),
            project=config.get_path("logger.project"),
            run_name=os.path.basename(self.workdir)) if self.rank0 else None
        self._eval_step = make_eval_step(self.model, self.mesh)
        self._eval_img_caches: Dict = {}
        self.optimizer = self.scheduler = self._train_step = None
        # where the train loop's host time goes (read by chip_smoke.py and by
        # the benchmark's portbench/); its timings are the clock reads of
        # the fit's utils/tracing.py spans of the same names
        self.loop_stats: Dict = {}

    # ----------------------------------------------------------------- state
    def create_state(self, initial_params=None, initial_model_state=None) -> TrainState:
        """A train state from the model's seeded init (or ``initial_params``
        and ``initial_model_state``: warm-start weights, e.g. carried from
        JAX, without optimizer state), and the optimizer, the LR scheduler
        and the train step over it."""
        state = create_train_state(self.model, seed=self.seed, params=initial_params,
                                   model_state=initial_model_state, mesh=self.mesh)
        mask = self.model.trainable_mask(state.params)
        self.ckpt.slim_mask = mask if self._slim else None
        self.optimizer, self.scheduler = build_optimizer(self.model.config, state.params, mask)
        self._train_step = make_train_step(self.model, self.optimizer, self.scheduler,
                                           self._accum, mesh=self.mesh)
        return state

    def prepare_restore_target(self, ckpt_path: str, state: TrainState) -> TrainState:
        """A slim checkpoint holds no frozen tower: take them from the
        pretrained files first (``load_pretrained`` keeps the seeded random
        towers, with a warning, where the files are missing; right only for
        a run trained on that same init)."""
        if not self.ckpt.is_slim(ckpt_path):
            return state
        logger.warning("%s is a slim checkpoint: frozen towers come from the pretrained files "
                       "(or the seed-deterministic random init if they are absent)", ckpt_path)
        return dataclasses.replace(state, params=self.model.load_pretrained(state.params))

    def restore(self, ckpt_path: str, state: TrainState) -> TrainState:
        """``state`` (from ``create_state``) with ``ckpt_path`` restored into
        it, the optimizer's and scheduler's state included."""
        state = self.prepare_restore_target(ckpt_path, state)
        return self.ckpt.restore(ckpt_path, state, self.optimizer, self.scheduler)

    # ------------------------------------------------------------------ data
    def eval_split_name(self, split: str) -> str:
        """"dev" -> Flickr8k's "dev" / SpokenCOCO's "val"; "test" -> "test"."""
        if split in ("dev", "val"):
            return "dev" if self.config.data.dataset.name == "flickr" else "val"
        if split == "test":
            return "test"
        raise ValueError(f"unknown eval split {split!r} (use 'dev' or 'test')")

    def _compact_wav(self) -> bool:
        # data.dataset.on_device_preprocess: uint8 images, int16 PCM on the wire
        return bool(self.config.get_path("data.dataset.on_device_preprocess", False))

    def _cache_image_features(self) -> bool:
        # the frozen image tower run once per fit; a trainable tower would
        # leave the cache stale, so it refuses, as the JAX trainer does
        enabled = bool(self.config.get_path("trainer.cache_image_features", False))
        if enabled and self.config.get_path("clip.image_encoder_trainable", False):
            raise ValueError("trainer.cache_image_features requires a frozen image tower")
        return enabled

    def build_eval_loader(self, split: str = "dev") -> BucketedLoader:
        data_cfg = self.config.data
        ds = build_dataset(data_cfg, self.eval_split_name(split), self.tokenizer,
                           image_size=self.model.vision_cfg.image_size)
        # data.eval_batch_size overrides dev_batch_size for throughput; the
        # val_loss magnitude depends on the batch, so it defaults to dev's
        batch_size = int(data_cfg.get("eval_batch_size", data_cfg.get("dev_batch_size", 8)))
        return BucketedLoader(ds, batch_size=batch_size, train=False, seed=self.seed,
                              compact_wav=self._compact_wav(),
                              skip_images=self._cache_image_features())

    def build_loaders(self) -> Tuple[BucketedLoader, BucketedLoader]:
        data_cfg = self.config.data
        train_ds = build_dataset(data_cfg, "train", self.tokenizer,
                                 image_size=self.model.vision_cfg.image_size)
        train_loader = BucketedLoader(
            train_ds, batch_size=int(data_cfg.batch_size), train=True,
            max_audio_len=int(self.config.get_path("audio_encoder.max_audio_len", 102400)),
            seed=self.seed, compact_wav=self._compact_wav(),
            skip_images=self._cache_image_features())
        return train_loader, self.build_eval_loader("dev")

    def build_image_feature_cache(self, dataset, params) -> Tuple[np.ndarray, Dict[int, int]]:
        """-> (features (n_unique, out_dim) f32, pair id -> row): one pass
        of the frozen image tower over the dataset's unique images (the
        first entry of each pair id), in chunks of 64 with the tail padded
        by its first image."""
        first_index_of_id: Dict[int, int] = {}
        for i, entry in enumerate(dataset.data):
            if "image" in entry and entry["id"] not in first_index_of_id:
                first_index_of_id[entry["id"]] = i
        ids = sorted(first_index_of_id)
        chunk, feats = 64, []
        with ThreadPoolExecutor(max_workers=8) as pool:
            for lo in range(0, len(ids), chunk):
                part = ids[lo:lo + chunk]
                imgs = np.stack(list(pool.map(
                    lambda i: dataset.get_item(first_index_of_id[i], skip_wav=True)["image"],
                    part)))
                if len(part) < chunk:
                    imgs = np.concatenate(
                        [imgs, np.repeat(imgs[:1], chunk - len(part), axis=0)], axis=0)
                with tp.model_mesh(self.mesh):
                    out = self.model.encode_image_tower(params, torch.from_numpy(imgs))
                feats.append(out[:len(part)].float().cpu().numpy())
        cache = np.concatenate(feats, axis=0)
        # every rank runs the tower on the same images; rank 0's features
        # are made everyone's, so the ranks' caches are the same bits
        collectives.broadcast_tree(torch.from_numpy(cache), self.mesh, "image cache")
        logger.info("image-feature cache: %d unique images -> (%d, %d) f32 (%.1f MB)",
                    len(ids), *cache.shape, cache.nbytes / 1e6)
        return cache, {pair_id: row for row, pair_id in enumerate(ids)}

    # ------------------------------------------------------------------- fit
    def fit(self, resume: Optional[str] = None, initial_params=None,
            initial_model_state=None) -> TrainState:
        """Train to ``trainer.max_steps``. ``resume``: a checkpoint path, or
        "auto" for the run's own ``ckpts/last`` where it exists.
        ``initial_params`` / ``initial_model_state``: warm-start weights."""
        state = self.create_state(initial_params, initial_model_state)
        if resume == "auto":
            last = os.path.join(self.workdir, "ckpts", "last")
            resume = last if os.path.exists(last) else None
        if resume:
            state = self.restore(resume, state)
            logger.info("resumed from %s at step %d", resume, state.step)
        elif initial_params is None:
            state = dataclasses.replace(state, params=self.model.load_pretrained(state.params))
        state = place_state(state, self.mesh, self.model, self.optimizer)

        train_loader, dev_loader = self.build_loaders()
        if int(train_loader.batch_size) % self.n_data != 0:
            raise ValueError(
                f"data.batch_size={train_loader.batch_size} must be divisible "
                f"by the data-mesh size {self.n_data} (otherwise no batch "
                "could ever run)"
            )
        stats = self.loop_stats = {"data_wait_s": 0.0, "data_waits": [], "train_wall_s": 0.0,
                                   "image_cache_s": None, "validations": [], "saves": []}
        image_cache = id2row = None
        if self._cache_image_features():
            with tracing.Timed("speechclip.fit.image_cache") as timed:
                image_cache, id2row = self.build_image_feature_cache(train_loader.dataset,
                                                                     state.params)
            stats["image_cache_s"] = timed.seconds

        max_steps = int(self.config.get_path("trainer.max_steps", 50000))
        log_every = int(self.config.get_path("trainer.log_every_n_steps", 8))
        val_every_epoch = int(self.config.get_path("trainer.check_val_every_n_epoch", 1))
        profile_steps = self.config.get_path("trainer.profile_steps")
        profiler = None
        wait = tracing.Timed("speechclip.fit.data_wait")
        validating = tracing.Timed("speechclip.fit.validate")
        saving = tracing.Timed("speechclip.fit.save")

        step = state.step
        epoch = 0
        t_last = time.perf_counter()
        steps_at_last_log = step
        while step < max_steps:
            steps_at_epoch_start = step
            # a ragged trailing batch does not split over the ranks: skipped, as JAX's
            whole = (b for b in train_loader if len(b["id"]) % self.n_data == 0)
            batches = (whole if image_cache is None else
                       (_inject_cached_image_feats(b, image_cache, id2row) for b in whole))
            staged_batches = device_prefetch(batches, self.mesh)
            waits = []  # this epoch's wait for each batch
            stats["data_waits"].append(waits)
            t_loop = time.perf_counter()
            while step < max_steps:
                with wait:
                    batch = next(staged_batches, None)
                stats["data_wait_s"] += wait.seconds
                if batch is None:
                    break
                waits.append(wait.seconds)
                if profile_steps and step == int(profile_steps[0]) and self.rank0:
                    profiler = self._start_profiler()
                with tracing.span("speechclip.fit.step"):
                    state, metrics = self._train_step(state, batch)
                step += 1
                if profiler is not None and step >= int(profile_steps[1]):
                    profiler = self._stop_profiler(profiler)
                if step % log_every == 0 and self.rank0:
                    with tracing.span("speechclip.fit.log"):
                        host_metrics = {k: float(v) for k, v in metrics.items()}
                        now = time.perf_counter()
                        host_metrics["steps_per_sec"] = (step - steps_at_last_log) / (now - t_last)
                        steps_at_last_log = step
                        # the lr the latest update applied: the schedule at the
                        # optimizer's count before it
                        host_metrics["lr"] = float(self.schedule(max(step // self._accum - 1, 0)))
                        t_last = now
                        self.metrics_logger.log(host_metrics, step)
            staged_batches.close()
            stats["train_wall_s"] += time.perf_counter() - t_loop
            epoch += 1
            if step == steps_at_epoch_start:
                raise RuntimeError("no training batch ran this epoch (dataset smaller than "
                                   "data.batch_size)")
            if epoch % val_every_epoch == 0 or step >= max_steps:
                with validating:
                    val_metrics = self.validate(state, dev_loader, epoch=epoch)
                stats["validations"].append((step, validating.seconds))
                with saving:
                    full, optimizer = gather_state(state, self.mesh, self.optimizer)
                    if self.rank0:
                        self.metrics_logger.log(val_metrics, step)
                        written = self.ckpt.save(full, step, val_metrics, self.config,
                                                 optimizer, self.scheduler)
                if self.rank0:
                    stats["saves"].append((step, saving.seconds, sum(
                        os.path.getsize(os.path.join(p, STATE_FILE)) for p in written)))
                collectives.barrier(self.mesh)  # no rank reads a checkpoint rank 0 still writes
                # steps_per_sec times the train loop: the next log's interval
                # starts here, not before the validation
                t_last = time.perf_counter()
                steps_at_last_log = step
        if profiler is not None:
            logger.warning("profiler window end %s was never reached; trace stopped at step %d",
                           profile_steps[1], step)
            self._stop_profiler(profiler)
        return state

    def _start_profiler(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.model.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        profiler.stop()
        path = os.path.join(self.workdir, "profile", "trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        profiler.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
        return None

    # -------------------------------------------------------------- validate
    def _eval_image_cache(self, dataset, params):
        """The eval image-feature cache of ``dataset`` under the current
        tower: one tower pass per (dataset, tower weights), kept across the
        validations of a fit. The key fingerprints the tower by a leaf's
        sum; the entry holds the dataset, so its id() is not reused."""
        leaf = _first_leaf(params["clip"]["visual"])
        key = (id(dataset), float(leaf.float().sum()))
        if key not in self._eval_img_caches:
            if len(self._eval_img_caches) > 4:
                self._eval_img_caches.clear()
            self._eval_img_caches[key] = (dataset,
                                          *self.build_image_feature_cache(dataset, params))
        return self._eval_img_caches[key][1:]

    def validate(self, state: TrainState, loader: Optional[BucketedLoader] = None,
                 epoch: int = 0, split: str = "dev") -> Dict[str, float]:
        """Losses (``val_*``, means over the full batches) and recall@k
        audio -> image, image -> audio and their mean over ``loader`` (the
        ``split``'s eval loader when None)."""
        if loader is None:
            loader = self.build_eval_loader(split)
        batch_size = loader.batch_size
        if int(batch_size) % self.n_data != 0:
            raise ValueError(
                f"eval batch size {batch_size} must be divisible by the "
                f"data-mesh size {self.n_data} (set data.eval_batch_size / "
                "data.dev_batch_size to a multiple of the device count)"
            )
        outputs: List[Dict] = []
        agg: Dict[str, List[float]] = {}
        ragged_metrics: Dict[str, float] = {}
        img_cache = id2row = None
        if self._cache_image_features():
            img_cache, id2row = self._eval_image_cache(loader.dataset, state.params)

        def prepared():
            for batch in loader:
                if img_cache is not None:
                    batch = _inject_cached_image_feats(batch, img_cache, id2row)
                padded, n_valid = _pad_batch(batch, batch_size)
                yield to_device(shard_batch(padded, self.mesh), self.model.device), n_valid, batch

        for dev_batch, n_valid, batch in staged(prepared()):
            out = self._eval_step(state, dev_batch)
            rec = {k: out[k][:n_valid] for k in ("id", "audio_feat", "image_feat")}
            if "keywords" in out:
                rec["keywords"] = out["keywords"][:n_valid]
                if "text" in batch and self.tokenizer is not None:
                    rec["gold_text"] = [self._gold_text(row) for row in batch["text"][:n_valid]]
            outputs.append(rec)
            host = {k: float(v) for k, v in out["metrics"].items()}
            if n_valid == batch_size:
                # padded rows would bias the loss means: full batches only
                for k, v in host.items():
                    agg.setdefault(k, []).append(v)
            else:
                ragged_metrics = host
        if not agg and ragged_metrics:
            logger.warning("every eval batch was ragged: loss metrics come from a padded batch "
                           "and include dummy-row contamination (features and retrieval "
                           "metrics are trimmed and unaffected)")
            agg = {k: [v] for k, v in ragged_metrics.items()}
        collected = collect_validation_outputs(outputs)
        recall_ab, recall_ba, recall_mean = retrieval_metrics(collected, self.recall_at,
                                                              device=self.model.device)
        logger.info("val_recall_AI %s", recall_ab)
        logger.info("val_recall_IA %s", recall_ba)
        logger.info("val_recall_mean %s", recall_mean)
        metrics: Dict[str, float] = {k: float(np.mean(v)) for k, v in agg.items()}
        metrics.update({f"val_recall_AI/{k}": v for k, v in recall_ab.items()})
        metrics.update({f"val_recall_IA/{k}": v for k, v in recall_ba.items()})
        metrics.update({f"val_recall_mean/{k}": v for k, v in recall_mean.items()})
        if "recall@10" in recall_mean:
            metrics["val_recall_mean_10"] = recall_mean["recall@10"]
        if "recall@1" in recall_mean:
            metrics["val_recall_mean_1"] = recall_mean["recall@1"]
        every_n = int(self.config.get_path("log_setting.log_detokenize_results_every_n_epoch", 1))
        if (self.rank0 and self.config.get_path("log_setting.log_detokenize_results", True)
                and self.model.use_cascaded and self.tokenizer is not None
                and "keywords" in collected and epoch % max(every_n, 1) == 0):
            t0 = time.perf_counter()
            hits = run_keyword_diagnostics(
                self.model, collected, state.params["clip"]["text"]["token_embedding"],
                self.tokenizer,
                os.path.join(self.workdir, "detokenizeText"), epoch,
                self.config.get_path("model_settings.cascaded_branch.keyword"))
            self.loop_stats.setdefault("diagnostics", []).append(
                (epoch, time.perf_counter() - t0))
            if hits:
                metrics["kw_hit_rate"] = hits
        return metrics

    def _gold_text(self, row) -> str:
        """A tokenized caption row [SOT, ids..., EOT, 0...] -> its text: cut
        at the EOT, a leading SOT dropped (id 0 is the real token '!', so
        the pad is not told apart by value)."""
        toks = [int(t) for t in row]
        eot = self.tokenizer.eot_id
        end = toks.index(eot) if eot in toks else len(toks)
        start = 1 if toks and toks[0] == self.tokenizer.sot_id else 0
        return self.tokenizer.decode(toks[start:end])
