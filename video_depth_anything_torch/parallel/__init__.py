"""Data- and tensor-parallel serving and training over ``torch.distributed``."""
from . import distributed  # noqa: F401
from .mesh import (broadcast_, data_rank, data_size, gather_model, gather_params,  # noqa: F401
                   make_mesh, mesh_device, model_axis, model_rank, model_size, shard_batch, shard_params,
                   split_params, split_specs)
from .tensor import ModelAxis, copy_to_model, max_over_model, reduce_from_model  # noqa: F401
