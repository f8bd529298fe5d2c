"""Online serving: continuous decode over a paged KV pool."""

from parallax_tpu_torch.common.config import ServeConfig
from parallax_tpu_torch.serve.adapters import (CausalLMDecodeProgram,
                                               MoeLMDecodeProgram,
                                               NMTDecodeProgram,
                                               standalone_greedy)
from parallax_tpu_torch.serve.batcher import (DeadlineExceeded,
                                              ReplicaUnavailable, Request,
                                              RequestQueue, ServeClosed,
                                              ServeError, ServeOverloaded,
                                              TenantQuotaExceeded)
from parallax_tpu_torch.serve.continuous import (ContinuousScheduler,
                                                 DecodeProgram)
from parallax_tpu_torch.serve.paging import (PageAllocator,
                                             PagePoolExhausted, pages_for)
from parallax_tpu_torch.serve.session import ServeSession

__all__ = [
    "ServeSession", "ServeConfig", "Request", "RequestQueue",
    "ContinuousScheduler", "DecodeProgram", "NMTDecodeProgram",
    "CausalLMDecodeProgram", "MoeLMDecodeProgram", "standalone_greedy",
    "PageAllocator", "PagePoolExhausted", "pages_for", "ServeError",
    "ServeOverloaded", "DeadlineExceeded", "ServeClosed",
    "ReplicaUnavailable", "TenantQuotaExceeded",
]
