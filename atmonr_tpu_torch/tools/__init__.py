"""Counterparts of the JAX repo's timing, diagnostic and quality tools
(``tools/``), run as ``python -m atmonr_tpu_torch.tools.<name>``."""

from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent


def repo_path(path: str | Path) -> Path:
    """A config path as the tools name it: relative to the repo root."""
    return REPO / path if not Path(path).is_absolute() else Path(path)
