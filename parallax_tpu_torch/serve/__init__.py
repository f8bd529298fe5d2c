"""Online serving: one-shot micro-batched inference, continuous decode
over a paged KV pool (with chunked prefill, speculative decoding and
prefix reuse), and the fault-tolerant tier above single sessions — the
replica fleet (router, fault injection, failover, weight hot-swap,
autoscaler) and disaggregated prefill/decode."""

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
                                              MicroBatcher,
                                              ReplicaUnavailable, Request,
                                              RequestQueue, ServeClosed,
                                              ServeError, ServeOverloaded,
                                              TenantQuotaExceeded)
from parallax_tpu_torch.serve.continuous import (ContinuousScheduler,
                                                 DecodeProgram)
from parallax_tpu_torch.serve.disagg import (DisaggFleet, export_prefill,
                                             import_prefill)
from parallax_tpu_torch.serve.faults import (FaultInjector, InjectedFault,
                                             ReplicaCrash)
from parallax_tpu_torch.serve.fleet import (FleetConfig, FleetRequest,
                                            ServeFleet)
from parallax_tpu_torch.serve.paging import (PageAllocator,
                                             PagePoolExhausted, pages_for)
from parallax_tpu_torch.serve.prefixcache import (CacheEntry,
                                                  RadixPrefixCache)
from parallax_tpu_torch.serve.router import (HealthPolicy, ReplicaHandle,
                                             Router)
from parallax_tpu_torch.serve.session import ServeSession

__all__ = [
    "ServeSession", "ServeConfig", "Request", "RequestQueue",
    "MicroBatcher", "ContinuousScheduler", "DecodeProgram",
    "NMTDecodeProgram", "CausalLMDecodeProgram", "MoeLMDecodeProgram",
    "LM1BDecodeProgram", "AdapterSpec", "register_adapter",
    "registered_adapters", "standalone_greedy", "layer_skip_draft",
    "PageAllocator", "PagePoolExhausted", "pages_for", "ServeError",
    "ServeOverloaded", "DeadlineExceeded", "ServeClosed",
    "ReplicaUnavailable", "ServeFleet", "FleetConfig", "FleetRequest",
    "DisaggFleet", "export_prefill", "import_prefill", "Router",
    "ReplicaHandle", "HealthPolicy", "FaultInjector", "InjectedFault",
    "ReplicaCrash", "TenantQuotaExceeded", "RadixPrefixCache",
    "CacheEntry",
]
