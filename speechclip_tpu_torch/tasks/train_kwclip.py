"""Train and evaluate SpeechCLIP (port of
speechclip_tpu/tasks/train_kwclip.py): the config tree (a YAML file and
``--override``s for a fresh run; the ``config.yaml`` beside the checkpoint
for ``--resume``, with the CLI's settings applied again), then
``Trainer.fit`` (``--train``) or ``Trainer.validate`` on the dev split
(``--eval``) or the test split (``--test``) from ``--ckpt`` / ``--resume``.
The trainer gets the CLIP tokenizer where ``default_bpe_path`` finds the
merges file (``data.dataset.tokenizeText`` and the keyword diagnostics use
it); without the file the run warns and goes on without them.

Checkpoints are the port's own run directories or a reference Lightning
``.ckpt`` (``--ckpt`` / ``--resume``), converted by
``convert/reference_ckpt.py``: its pickled config, with an explicit
``--config`` merged over it, builds the run; ``--train`` warm-starts from
its weights (a fresh optimizer: Lightning's optimizer state is not
carried), ``--eval`` / ``--test`` validate them.

Data parallelism: ``--devices N`` (N > 1) spawns N ranks (the ``spawn``
start method, a ``file://`` rendezvous) on ``cuda:0 .. N-1`` under NCCL,
or on the CPU under gloo with ``--platform cpu``; each rank runs the task
over its ``DataMesh`` and rank 0 writes the run directory (the parent
returns None). Started inside a ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) the task joins that world
instead, and ends the group it made when it is done. ``--devices N`` above
the cards found raises.
"""

from __future__ import annotations

import logging
import random

import numpy as np
import torch
import torch.distributed as dist

from ..config import load_config, parse_override_value
from ..convert.reference_ckpt import load_reference_checkpoint
from ..models.tokenizer import CLIPTokenizer
from ..parallel.mesh import default_backend, join_env_world, make_mesh, spawn
from ..training.checkpoint import load_config_from_checkpoint
from ..training.logging import set_logging
from ..training.train_step import place_state
from ..training.trainer import Trainer
from .base_task import BaseTask

logger = logging.getLogger(__name__)


def _seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _build_tokenizer():
    """The CLIP tokenizer over the merges file ``default_bpe_path`` finds;
    None, with JAX's warning, where there is none."""
    try:
        return CLIPTokenizer()
    except FileNotFoundError:
        logger.warning("CLIP BPE merges file not found (SPEECHCLIP_BPE_PATH); text "
                       "tokenization and keyword diagnostics disabled")
        return None


def _rank_task(rank: int, args) -> None:
    """One rank of ``--devices N``: the task over the spawned world."""
    runner = TrainKWClip_GeneralTransformer()
    runner.args = args
    runner.run()


class TrainKWClip_GeneralTransformer(BaseTask):
    def run(self):
        """Fit (returns the final ``TrainState``) or validate (returns the
        metrics); the trainer stays on ``self.trainer``. With ``--devices
        N > 1`` the ranks run in spawned processes and this returns None."""
        args = self.args
        platform = "cpu" if args.platform == "cpu" else "cuda"
        made = join_env_world(default_backend(platform))
        try:
            if dist.is_initialized():
                world = dist.get_world_size()
                if args.devices is not None and args.devices != world:
                    raise ValueError(f"--devices {args.devices} inside a world of {world} ranks")
                return self._run(make_mesh(devices=["cpu"] * world if platform == "cpu"
                                           else None))
            if args.devices is not None and args.devices > 1:
                return self._spawn(args.devices, platform)
            return self._run(None)
        finally:
            if made:
                dist.destroy_process_group()

    def _spawn(self, n: int, platform: str) -> None:
        if platform == "cuda":
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n > found:
                raise RuntimeError(f"--devices {n}: {found} CUDA device(s) found "
                                   "(--platform cpu runs the ranks on the CPU)")
            from ..kernels import _build

            _build.build()  # once, before the ranks load it
        spawn(_rank_task, n, default_backend(platform), args=(self.args,))

    def _run(self, mesh):
        args = self.args
        ckpt_arg = args.resume or args.ckpt
        set_logging(args.log_level)
        _seed_everything(args.seed)
        device = "cpu" if args.platform == "cpu" else "cuda"

        reference_state = None
        if ckpt_arg and ckpt_arg.endswith(".ckpt"):
            params, model_state, config = load_reference_checkpoint(ckpt_arg)
            reference_state = (params, model_state)
            if args.config:  # an explicit YAML wins over the pickled config
                config.merge_(load_config(args.config, overrides=args.override))
        elif args.resume:
            config = load_config_from_checkpoint(args.resume)
        else:
            if not args.config:
                raise ValueError("--config required for fresh runs")
            config = load_config(args.config, overrides=args.override)
        if args.dataset_root:
            config.set_path("data.dataset.dataset_root", args.dataset_root)
        if args.save_path:
            config.set_path("trainer.default_root_dir", args.save_path)
        config["seed"] = args.seed
        for ov in args.override:
            key, _, value = ov.partition("=")
            config.set_path(key.strip(), parse_override_value(value.strip()))

        trainer = self.trainer = Trainer(config, tokenizer=_build_tokenizer(), device=device,
                                         mesh=mesh)
        self.config = config

        if args.train:
            if reference_state is not None:
                params, model_state = reference_state
                return trainer.fit(initial_params=params, initial_model_state=model_state)
            return trainer.fit(resume=args.resume)
        if args.eval or args.test:
            if reference_state is not None:
                state = trainer.create_state(*reference_state)
            else:
                state = trainer.create_state()
                if ckpt_arg:
                    state = trainer.restore(ckpt_arg, state)
            # --test evaluates the test split, --eval the dev/val split
            split = "test" if args.test else "dev"
            metrics = trainer.validate(place_state(state, trainer.mesh), split=split)
            logger.info("validation metrics (%s): %s", split, metrics)
            return metrics
        raise ValueError("specify one of --train / --eval / --test")
