"""DIFET's feature-extraction service on the card (port of ``repro.serve``).

``FeatureService`` is the facade: request/response model in ``api.py``,
continuous-batching scheduler in ``scheduler.py``, shape buckets + the
per-(bucket, algorithm-set) program cache in ``buckets.py`` (one CUDA
graph per pair on the card, on a stream of the service's own), and the
content-hash result caches (in-process LRU + shared disk tier) in
``cache.py``.  The fleet layer replicates the service: consistent-hash
router with admission control in ``router.py``, replica pool + lifecycle
+ SLO-driven autoscaling in ``fleet.py``, and the shared synthetic trace
generator in ``trace.py``.  Cross-process replicas live in ``proc.py``
(worker + parent-side client) over the spooled-file transport in
``transport.py``; deterministic fault injection for both tests and
launch drivers in ``chaos.py``.  The LM-substrate serving helpers
(prefill, single-token decode, greedy generation) live in ``serve/lm.py``;
``serve/api.py`` is the DIFET service.
"""
from repro_torch.serve.api import (FeatureService, ServeConfig,  # noqa: F401
                                   ExtractResponse, ResponseHandle,
                                   ServiceOverloaded, tile_digest,
                                   config_digest, encode_tile, decode_tile)
from repro_torch.serve.buckets import (BucketTable, CompileCache,  # noqa: F401
                                       EagerStep, ServeGraph, warmup)
from repro_torch.serve.cache import (ResultCache, DiskCacheTier,  # noqa: F401
                                     TieredResultCache)
from repro_torch.serve.chaos import (ChaosPlan, cache_partition,  # noqa: F401
                                     sigkill, tear_file)
from repro_torch.serve.fleet import Fleet, FleetConfig  # noqa: F401
from repro_torch.serve.proc import ProcReplicaClient, ProcHandle  # noqa: F401
from repro_torch.serve.router import (Router, RouterConfig, Shed,  # noqa: F401
                                      FleetHandle, HashRing, TokenBucket)
from repro_torch.serve.scheduler import (BatchScheduler, WorkItem,  # noqa: F401
                                         ServiceClosed, ReplicaDied)
from repro_torch.serve.trace import (TraceConfig, TraceEvent,  # noqa: F401
                                     make_trace, tile_pool, scene_key)
from repro_torch.serve.transport import WorkerMailbox  # noqa: F401
