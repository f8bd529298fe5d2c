"""Online serving: continuous decode over a paged KV pool, with chunked
prefill, speculative decoding and prefix reuse."""

from parallax_tpu_torch.common.config import ServeConfig
from parallax_tpu_torch.serve.adapters import (AdapterSpec,
                                               CausalLMDecodeProgram,
                                               LM1BDecodeProgram,
                                               MoeLMDecodeProgram,
                                               NMTDecodeProgram,
                                               layer_skip_draft,
                                               register_adapter,
                                               registered_adapters,
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
from parallax_tpu_torch.serve.prefixcache import (CacheEntry,
                                                  RadixPrefixCache)
from parallax_tpu_torch.serve.session import ServeSession

__all__ = [
    "ServeSession", "ServeConfig", "Request", "RequestQueue",
    "ContinuousScheduler", "DecodeProgram", "NMTDecodeProgram",
    "CausalLMDecodeProgram", "MoeLMDecodeProgram", "LM1BDecodeProgram",
    "standalone_greedy", "layer_skip_draft", "AdapterSpec",
    "register_adapter", "registered_adapters", "PageAllocator",
    "PagePoolExhausted", "pages_for", "RadixPrefixCache", "CacheEntry",
    "ServeError", "ServeOverloaded", "DeadlineExceeded", "ServeClosed",
    "ReplicaUnavailable", "TenantQuotaExceeded",
]
