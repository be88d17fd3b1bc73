"""The task base class and the shared CLI flags (port of
speechclip_tpu/tasks/base_task.py)."""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


class BaseTask:
    def __init__(self):
        self.args = None
        self.config = None

    def add_args(self, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        parser.add_argument("--config", type=str, default=None, help="config yaml")
        parser.add_argument("--save_path", type=str, default=None)
        parser.add_argument("--train", action="store_true")
        parser.add_argument("--eval", action="store_true")
        parser.add_argument("--test", action="store_true")
        parser.add_argument("--ckpt", type=str, default=None)
        parser.add_argument("--resume", type=str, default=None)
        parser.add_argument("--njobs", type=int, default=8)
        parser.add_argument("--seed", type=int, default=7122)
        parser.add_argument("--dataset_root", type=str, default=None)
        parser.add_argument("--log_level", type=str, default="INFO")
        parser.add_argument("--override", nargs="*", default=[],
                            help="config overrides: key.path=value")
        parser.add_argument("--devices", type=int, default=None,
                            help="data-parallel ranks: N > 1 spawns N processes, one a card "
                                 "(or on the CPU with --platform cpu)")
        parser.add_argument("--platform", type=str, default=None, choices=("cpu", "cuda", "gpu"),
                            help="cpu runs the port on the CPU; the default is the card")
        return parser

    def parse_args(self, parser: argparse.ArgumentParser,
                   argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
        self.args = parser.parse_args(argv)
        return self.args

    def run(self):
        raise NotImplementedError
