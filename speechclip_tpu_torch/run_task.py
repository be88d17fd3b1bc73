"""The port's CLI:

    python -m speechclip_tpu_torch.run_task TrainKWClip_GeneralTransformer \
        --config configs/base/spchclp_p.yaml --train [--platform cpu]

The task name comes first (the root ``run_task.py``'s contract, which runs
the JAX package). ``main(argv)`` returns the task runner, whose ``trainer``
holds the run.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(prog="python -m speechclip_tpu_torch.run_task",
                                     add_help=False)
    parser.add_argument("task", type=str, help="task class name")
    args, _ = parser.parse_known_args(argv)

    from . import tasks

    runner_cls = getattr(tasks, args.task, None) if args.task in tasks.__all__ else None
    if runner_cls is None:
        # with flags first, argparse binds a flag's value to `task`
        # (`--config cfg.yaml Task` -> task='cfg.yaml'): a usage error
        valid = ", ".join(n for n in tasks.__all__ if n != "BaseTask")
        parser.error(f"unknown task {args.task!r} — the task name must come first: "
                     f"run_task TASK [--flags]; available tasks: {valid}")
    runner = runner_cls()
    task_parser = argparse.ArgumentParser(prog=parser.prog)
    task_parser.add_argument("task", type=str)
    runner.add_args(task_parser)
    runner.parse_args(task_parser, argv)
    runner.result = runner.run()
    return runner


if __name__ == "__main__":
    main()
