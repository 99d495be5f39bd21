"""Counterparts of the JAX repo's timing, diagnostic and quality tools
(``tools/``), run as ``python -m atmonr_tpu_torch.tools.<name>``.

Every tool that trains steps a ``Trainer`` (``tool_trainer``) with
``Trainer.step`` on the rows ``batches`` draws: the step users and the
benchmark run."""

import contextlib
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def repo_path(path: str | Path) -> Path:
    """A config path as the tools name it: relative to the repo root."""
    return REPO / path if not Path(path).is_absolute() else Path(path)


@contextlib.contextmanager
def tool_trainer(block: dict, dataset, pipeline, name: str, seed: int = 0, **over):
    """A ``Trainer`` of ``pipeline`` on ``dataset``, on the pipeline's
    device: the trainer block ``block`` (a config's) with the keys of
    ``over`` over it, seeded by ``seed``, its logs in a temporary directory
    that goes, with the logger, when the ``with`` block ends."""
    from atmonr_tpu_torch import Trainer

    with tempfile.TemporaryDirectory(prefix=f"{name}-") as root:
        tr = Trainer({**block, **over}, dataset, pipeline, name, data_root=root, seed=seed,
                     device=pipeline.device)
        try:
            yield tr
        finally:
            tr.logger.close()


def batches(trainer):
    """The rows of the Trainer's steps as ``Trainer.iterate`` draws them,
    without end: a permutation from its ``perm`` stream every
    ``steps_per_epoch`` steps."""
    from atmonr_tpu_torch.data.batching import epoch_permutation

    b = trainer.rank_batch
    while True:
        perm = epoch_permutation(trainer.generators["perm"], trainer.rank_rays, b)
        for i in range(trainer.steps_per_epoch):
            yield perm[i * b : (i + 1) * b]
