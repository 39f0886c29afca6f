from repro_torch.data.landsat import synthetic_scene, synthetic_scene_rgba  # noqa: F401
from repro_torch.data.tokens import synthetic_lm_batch, token_stream  # noqa: F401
