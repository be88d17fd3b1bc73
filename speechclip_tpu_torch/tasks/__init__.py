"""The task layer (port of speechclip_tpu/tasks): a task parses the shared
flags, assembles the run's config tree (the YAML file and overrides, or the
one beside a checkpoint), builds the ``Trainer`` and runs fit or
validation."""

from .base_task import BaseTask
from .train_kwclip import TrainKWClip_GeneralTransformer

__all__ = ["BaseTask", "TrainKWClip_GeneralTransformer"]
