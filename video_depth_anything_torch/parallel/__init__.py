"""Data-parallel serving and training over ``torch.distributed``."""
from . import distributed  # noqa: F401
from .mesh import (broadcast_, data_size, make_mesh, mesh_device,  # noqa: F401
                   require_data_only, shard_batch, shard_params)
