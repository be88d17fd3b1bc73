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
"""

from __future__ import annotations

import logging
import random

import numpy as np
import torch

from ..config import DDP_ITEM, load_config, parse_override_value
from ..convert.reference_ckpt import load_reference_checkpoint
from ..models.tokenizer import CLIPTokenizer
from ..training.checkpoint import load_config_from_checkpoint
from ..training.logging import set_logging
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


class TrainKWClip_GeneralTransformer(BaseTask):
    def run(self):
        """Fit (returns the final ``TrainState``) or validate (returns the
        metrics); the trainer stays on ``self.trainer``."""
        args = self.args
        if args.devices is not None and args.devices > 1:
            raise NotImplementedError(f"--devices {args.devices}: {DDP_ITEM}")
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

        trainer = self.trainer = Trainer(config, tokenizer=_build_tokenizer(), device=device)
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
            metrics = trainer.validate(state, split=split)
            logger.info("validation metrics (%s): %s", split, metrics)
            return metrics
        raise ValueError("specify one of --train / --eval / --test")
