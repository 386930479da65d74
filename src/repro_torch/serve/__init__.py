"""repro_torch.serve — continuous batching over a DFXP-packed KV-cache pool,
slot-major or paged."""
from .engine import EngineOptions, Request, RequestStatus, ServeEngine  # noqa: F401
from .kv_pool import (  # noqa: F401
    CacheQuantConfig,
    KVPool,
    PackedKVCodec,
    insert,
    make_kv_pool,
    make_pool,
    overflow_summary,
    slot_overflow_rates,
    slot_totals,
)
from .metrics import RequestTrace, ServeMetrics  # noqa: F401
from .paged import PageAllocator, PagedKVCodec, PageExhausted  # noqa: F401
from .sampler import SamplerConfig, guard_logits, sample  # noqa: F401
