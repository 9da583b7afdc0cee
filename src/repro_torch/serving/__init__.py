"""Serving: weight compression to index form, the paged KV-cache allocator,
the batched inference engine (contiguous or paged cache) with its
dense/codebook/lut matmul backends and speculative decoding, the
virtual-clock request scheduler and server over its step-level API, the
telemetry registry, and the multi-replica fleet behind its router."""

from repro_torch.serving.compress import index_dtype_for, to_codebook_params
from repro_torch.serving.engine import SchedState, ServeEngine, SwapBlob
from repro_torch.serving.fleet import Fleet, ReplicaProbe
from repro_torch.serving.kvcache import (Admission, PagePool, PoolStats,
                                         SharedPrefixTier, chain_keys)
from repro_torch.serving.router import FleetRouter
from repro_torch.serving.scheduler import (AsyncScheduler, RequestHandle,
                                           StepCosts, VirtualClock)
from repro_torch.serving.server import (CONTENDED_ENGINE_KW, Server,
                                        ServerReport, contended_trace,
                                        iter_trace, load_trace,
                                        poisson_trace, poisson_trace_iter,
                                        save_trace)
from repro_torch.serving.spec import SpecConfig, SpecStats, filter_logits
from repro_torch.serving.telemetry import NULL_TELEMETRY, Telemetry
