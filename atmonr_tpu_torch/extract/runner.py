"""Batched extinction-field query of a pipeline (counterpart of the JAX
package's ``extract/runner.py``, single device): the points stream through
``pipeline.extract`` in fixed-size batches on the pipeline's device, and
the densities are rescaled to m^-1 by ``1/scale``."""

from __future__ import annotations

import numpy as np
import torch


@torch.no_grad()
def run_extraction(
    pipeline,
    points,
    batch_size: int = 32768,
) -> np.ndarray:
    """Query ``pipeline.extract`` over ECEF points.

    ``points`` is an (N, 3) float64 array of ECEF coordinates in meters, or
    an object holding one as ``.xyz`` (an extraction grid). Returns sigma
    (N, num_density_outputs) in m^-1 as a float32 numpy array.
    """
    scale = pipeline.scale
    offset = np.asarray(pipeline.offset, np.float64)
    xyz = np.asarray(getattr(points, "xyz", points), np.float64)
    n = xyz.shape[0]
    nb = -(-n // batch_size)
    pts_all = torch.from_numpy(((xyz - offset[None]) / scale).astype(np.float32))
    pts_all = pts_all.to(pipeline.device)

    out = [
        pipeline.extract(pts_all[i * batch_size : (i + 1) * batch_size]) / scale
        for i in range(nb)
    ]
    return torch.cat(out, dim=0).cpu().numpy()
