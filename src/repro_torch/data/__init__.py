from repro_torch.data.landsat import synthetic_scene, synthetic_scene_rgba  # noqa: F401
