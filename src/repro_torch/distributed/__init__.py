"""The data mesh of the tile path (``repro/distributed``'s counterpart for
the extraction workload): `Mesh`, `data_mesh`, `dp_axes`, row slices, the
runner that puts each slice on its own device, and `one_device`."""
from repro_torch.distributed.sharding import (  # noqa: F401
    Mesh, MeshRunner, Sharded, data_mesh, dp_axes, one_device, shard,
    split_rows,
)
