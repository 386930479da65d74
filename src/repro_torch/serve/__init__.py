"""repro_torch.serve — continuous batching over a DFXP-packed KV-cache pool,
slot-major or paged."""
from .engine import EngineOptions, Request, RequestStatus, ServeEngine  # noqa: F401
from .faults import (  # noqa: F401
    AdmitDelay,
    FaultHarness,
    KVBitFlip,
    LogitNaN,
    PageSqueeze,
    chaos_plan,
)
from .kv_pool import (  # noqa: F401
    CacheQuantConfig,
    KVPool,
    PackedKVCodec,
    insert,
    make_kv_pool,
    make_pool,
    numerics_snapshot,
    overflow_summary,
    slot_overflow_rates,
    slot_totals,
)
from .metrics import RequestTrace, ServeMetrics  # noqa: F401
from .paged import PageAllocator, PagedKVCodec, PageExhausted  # noqa: F401
from .sampler import SamplerConfig, guard_logits, request_key, sample  # noqa: F401
