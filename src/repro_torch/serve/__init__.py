"""repro_torch.serve: the serving slice of the port — the dense reference
path (engine), the paged KV cache and the continuous-batching scheduler."""
from .engine import (  # noqa: F401
    build_serve_step, greedy_generate, grow_caches, scale_specs_multipod,
    serve_cache_specs, serve_param_specs,
)
from .paged_cache import (  # noqa: F401
    NULL_PAGE, PageAllocator, PagedCacheConfig, init_paged_pools,
    paged_pool_shapes, paged_pool_specs,
)
from .scheduler import (  # noqa: F401
    ContinuousBatchingEngine, Request, build_paged_serve_step, poisson_load,
    run_fixed_batch, summarize,
)
