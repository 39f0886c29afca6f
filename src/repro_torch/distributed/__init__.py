"""``repro/distributed``'s counterpart: the data mesh of the extraction
workload (`Mesh`, `data_mesh`, `dp_axes`, row slices, the runner that puts
each slice on its own device, `one_device`) and the LM substrate's named
mesh of ranks (`LMMesh`), its parameter rules and activation specs
(`sharding`) and its spec builders (`specs`)."""
from repro_torch.distributed.sharding import (  # noqa: F401
    LMMesh, Mesh, MeshRunner, P, Sharded, data_mesh, dp_axes, one_device,
    shard, split_rows, use_mesh,
)
