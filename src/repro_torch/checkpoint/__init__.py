from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager, flatten_state,
)
