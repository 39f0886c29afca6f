from repro_torch.optim.adamw import AdamW, clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
from repro_torch.optim.compression import compress_decompress  # noqa: F401
