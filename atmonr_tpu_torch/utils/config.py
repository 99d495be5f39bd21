"""Config loading: the JSON schema of ``configs/`` unchanged, with the same
case fixes as the JAX package's ``utils/config.py``."""

from __future__ import annotations

import json
from pathlib import Path


def load_config(config_path: str | Path) -> dict:
    """Load a config file and fix some common mistakes."""
    with open(config_path) as f:
        config = json.load(f)
    if config["pipeline"]["type"].lower() == "nerf":
        config["pipeline"]["type"] = "NeRF"
    if config["pipeline"]["type"].lower() == "instantngp":
        config["pipeline"]["type"] = "InstantNGP"
    if config["dataset"]["type"].lower() == "harp2":
        config["dataset"]["type"] = "HARP2"
    return config
