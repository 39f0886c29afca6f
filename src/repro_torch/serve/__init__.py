"""DIFET's feature-extraction service on the card (port of ``repro.serve``).

``FeatureService`` is the facade: request/response model in ``api.py``,
continuous-batching scheduler in ``scheduler.py``, shape buckets + the
per-(bucket, algorithm-set) program cache in ``buckets.py`` (one CUDA
graph per pair on the card), the content-hash result caches (in-process
LRU + shared disk tier) in ``cache.py``, and the synthetic trace
generator in ``trace.py``.  One service is one replica; the reference's
fleet (``router.py``, ``fleet.py``, ``proc.py``, ``transport.py``,
``chaos.py``) comes with the port of the fleet.
"""
from repro_torch.serve.api import (FeatureService, ServeConfig,  # noqa: F401
                                   ExtractResponse, ResponseHandle,
                                   ServiceOverloaded, tile_digest,
                                   config_digest, encode_tile, decode_tile)
from repro_torch.serve.buckets import (BucketTable, CompileCache,  # noqa: F401
                                       EagerStep, ServeGraph, warmup)
from repro_torch.serve.cache import (ResultCache, DiskCacheTier,  # noqa: F401
                                     TieredResultCache)
from repro_torch.serve.scheduler import (BatchScheduler, WorkItem,  # noqa: F401
                                         ServiceClosed, ReplicaDied)
from repro_torch.serve.trace import (TraceConfig, TraceEvent,  # noqa: F401
                                     make_trace, tile_pool, scene_key)
