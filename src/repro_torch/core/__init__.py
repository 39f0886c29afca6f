"""DIFET core: distributed local-feature extraction over tile bundles (the
paper's map/reduce), on PyTorch tensors."""
from repro_torch.core.bundle import TileBundle, BundleStore, tile_scene, bundle_scenes  # noqa: F401
from repro_torch.core.engine import (  # noqa: F401
    ALGORITHMS, extract_features, extract_features_multi,
    extract_request_features,
)
