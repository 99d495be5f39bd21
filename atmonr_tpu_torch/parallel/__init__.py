"""Several devices over ``torch.distributed``: the (data, sample) mesh, ray
sharding, the sample-axis compositor and the sharded train step."""

from atmonr_tpu_torch.parallel import data, mesh, sharding, train

__all__ = ["data", "mesh", "sharding", "train"]
