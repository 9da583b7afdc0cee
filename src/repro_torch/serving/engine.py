"""Batched serving engine over the contiguous or the paged KV cache (the
port's copy of the single-device ``ServeEngine`` of
``repro/serving/engine.py``), for the KV-cache families ``dense`` and
``moe``.  In a ``moe`` model every row of a forward competes for the
experts' capacity, so what the engine feeds its padding and its free or
retired slots (the prompt bucket's zero tokens, the zero tail of a prefill
chunk, a free slot's last token and position, a paged speculative round's
zero proposals outside the active slots) changes the active requests'
tokens: each is the reference's.

* **Prefill** runs the whole right-padded prompt batch in one forward;
  prompt lengths are bucketed to powers of two (at least 8), logits come
  from each row's last real position, and the K/V planes are padded to
  ``max_len``.
* **Decode** is the reference's jitted ``_loop_fn`` (a ``lax.while_loop``)
  as a Python loop over one step a token.  The loop's carry (last token,
  active flags, tokens generated, stop lengths, the out buffer, positions,
  the page table and the cache) lives in static device buffers
  (``_Slots``), one set per batch shape and cache kind.  On the card each
  step is one CUDA graph replay, captured once per set: at temperature 0
  the graph holds the forward, the argmax and the bookkeeping; above it
  the forward only, and sampling and bookkeeping follow the replay.  A
  step then reads one small tensor back (the step's ids, the active flags
  and the counts), and the host copies nothing to the card; host writes
  happen at admission and harvest.  On the CPU the same step runs
  eagerly.  Per-request stop lengths retire rows in place; retired rows
  keep decoding into their own clamped cache slot until the loop exits.
* **Continuous batching** (``serve``): the batch is a pool of ``max_batch``
  slots.  Each request prefills alone and is spliced into a free slot at its
  own position offset; the loop exits when some request finishes, the slot
  is harvested, the next request admitted, and decoding resumes.
* **Speculative** (``spec=SpecConfig(...)``, ``serve``): each loop
  iteration is a round — a draft (the n-gram self-draft, or a second
  model under its own backend) proposes ``k`` tokens, the target scores
  all ``k + 1`` in one ``verify`` forward, and ``spec_accept`` keeps the
  accepted prefix plus one token, the counterpart of the reference's
  jitted ``_spec_loop_fn``.  The round's carry extends the loop's static
  buffers (``_SpecSlots``: the token history the n-gram draft reads, the
  draft's cache, the acceptance counters).  At temperature 0 a round is
  one CUDA graph replay on the card: proposal, verify, argmax acceptance,
  splices and counters.  Above it the random parts stay outside graphs:
  each draft step replays a captured draft forward and samples eagerly,
  and the verify replays a captured forward, then ``spec_accept`` runs
  eagerly.
* **Paged** (``paged=True``: ``serve`` and the step API): requests are
  admitted when the page pool (``serving/kvcache.PagePool``) can supply
  their pages, not when a slot is free; prompts stream through
  page-sized prefill chunks, shared prompt pages come from the prefix
  cache, and decode gathers each slot's pages through
  ``kernels.ops.gather_pages_many``.  With ``spec`` the rounds run on the
  pool (the model draft keeps a contiguous cache): before each the host
  ``extend``s every active slot's pages over the span the verify writes,
  after it ``truncate``s them back to the tokens kept, each edit an
  in-place write into the static page table a captured round reads.  ``generate`` stays on the contiguous cache.
* **Step-level scheduling** (``sched_*``, ``serve_step``): the control
  flow ``serve`` owns is handed to an external scheduler
  (``serving/scheduler.AsyncScheduler``): ``sched_state`` opens a session
  on the same static state ``serve`` runs, ``sched_admit`` prefills one
  request into one slot, ``serve_step`` decodes a bounded quantum of
  tokens a slot through the same decode loop, and
  ``sched_swap_out``/``sched_swap_in`` move a preempted request's K/V
  (its pages, gathered by one ``page_gather`` launch, or its slot's rows)
  to a host ``SwapBlob`` and back, bit-exact.  The engine reads no clock.

The matmul backend (``dense`` | ``codebook`` | ``lut``) is a field of the
engine, passed down to every layer as a ``kernels.dispatch.BackendSpec``.
``codebook``/``lut`` need index-form params (``to_codebook_params``).

* **Tensor parallelism** (``mesh=``, a ``launch/mesh.Mesh``): every rank
  of the mesh's ``model`` axis builds the engine on the same params and
  runs the same host loop on the same requests.  ``_shard_params`` keeps
  this rank's slice of each block matmul (``distributed/sharding.
  serve_param_specs``: column-parallel wq/wk/wv/w1/w3, row-parallel wo/w2;
  in index form only the integer ids shard), everything else whole; the
  lut grid is the full fan-in's, fixed before the cut.  The contiguous
  cache keeps this rank's S/tp rows of every plane (a prefill computes
  whole planes and each rank keeps its rows), and decode and verify join
  the ranks' partial softmax over it (``attention._decode_cached_
  sharded``).  The page pool keeps this rank's in-page slice of every
  page (``PagePool(shards=tp)``: page / tp rows; the allocator, page
  tables and prefix cache are whole and identical on every rank), and
  the paged prefill chunks, decode and verify join the ranks' partials
  over it (``attention._paged_flash_sharded``).  A ``moe`` model's
  experts are cut by ``models/moe.moe_param_specs`` (EP when the experts
  divide over tp, else each expert's hidden dim).  Each collective hands
  every rank the same bytes, so the ranks' decisions agree.  Under a
  mesh the decode step is eager on the card: a CUDA graph cannot capture
  a gloo collective (every kernel still runs on the card).

  Everything the engine serves runs under a mesh; it refuses there only
  what the reference refuses.  The step-level API (and the scheduler,
  server and fleet above it) reads no clock, so every rank's host loop
  makes the same decisions.  A contiguous swap copies out and writes
  back this rank's rows below the request's position, a paged one this
  rank's in-page slice of its pages (one ``page_gather`` launch); a blob
  is a rank's, its ``pos`` and ``n_pages`` global, its bytes counted over
  all ranks (``SwapBlob.nbytes``).  A model draft runs unsharded on
  every rank: its params stay whole (only ``params`` is cut), its cache
  holds all ``max_len`` rows and its backend has no mesh.  The numerics
  probes record each rank's part (``kernels/probes``: the taps of the
  reference's shard_map bodies, the sharded attention and the MoE, record
  nothing), and ``numerics()`` combines them; the static index audit
  reads the whole tree, before the cut.

* **Numerics probes** (``probes=True``): the engine owns one probe state
  (``kernels/probes.init_state``), static f32 device buffers made before
  any capture.  Each instrumented forward (the contiguous prefills of
  ``generate``, ``serve`` and ``sched_admit``, every chunked prefill, and
  the decode forward a step's graph holds) gets it injected for the call
  as ``{**cache, "probes": state}`` and adds into it in place; a replay
  adds again, with no host read.  No cache the engine keeps (the pool,
  a ``_Slots`` cache, a ``SwapBlob``) ever holds the key.  ``numerics()``
  reads the state in one copy; ``reset_probes()`` zeroes the buffers in
  place.  Probes are refused with ``spec``, as in the reference.

``telemetry`` takes a registry of ``serving/telemetry.py``: the engine
counts its decode rounds, tokens and blocked admissions there.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch, ops
from repro_torch.models.model_zoo import Model
from repro_torch.serving import probes as nprobes
from repro_torch.serving.kvcache import PagePool
from repro_torch.serving.spec import (SpecConfig, SpecStats, filter_logits,
                                      ngram_propose, spec_accept,
                                      target_dist)
from repro_torch.serving.telemetry import NULL_TELEMETRY

__all__ = ["ServeEngine", "SchedState", "SwapBlob"]

_ENGINE_FAMILIES = ("dense", "moe")


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _splice_rows(buf, toks, start, m):
    """buf[b, start[b] + i] = toks[b, i] for i < m[b]: a per-row append of
    variable length as a full-row select (a scatter at clipped columns
    would collide at the buffer's edge).  Returns the new buffer."""
    W = buf.shape[1]
    rel = torch.arange(W, device=buf.device)[None] - start[:, None]
    pick = (rel >= 0) & (rel < m[:, None])
    vals = torch.gather(toks, 1, torch.clamp(rel, 0, toks.shape[1] - 1))
    return torch.where(pick, vals, buf)


def _index_form_stats(params):
    """(found_any, max fan-in over w_idx leaves, concatenated codebooks).

    As in the reference, the fan-in is the largest ``shape[-2]`` over *all*
    ``w_idx`` leaves, the embedding's (padded_vocab, d) included, so the lut
    scale is sized for the vocabulary rather than the widest matmul.
    """
    fan_in, books = 0, []

    def walk(node):
        nonlocal fan_in
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif name == "w_idx" and leaf.ndim >= 2:
                fan_in = max(fan_in, int(leaf.shape[-2]))
            elif name == "codebook":
                b = leaf[0] if leaf.ndim == 2 else leaf
                books.append(b.detach().to(torch.float32).cpu().numpy())

    walk(params)
    book = np.concatenate(books) if books else None
    return fan_in > 0, fan_in, book


class _Slots:
    """The decode loop's carry for one batch shape and cache kind, in static
    device buffers (the state the reference's ``_loop_fn`` threads through
    its ``while_loop``): a CUDA graph captured on them replays one step.

    ``cache`` holds the K/V planes (contiguous) or the page pool with the
    slots' ``page_table``, and ``pos``; ``last`` (B,) the last token,
    ``active`` (B,) the live slots, ``n_gen`` (B,) tokens generated,
    ``stops`` (B,) stop lengths, ``out`` (B, width) the tokens, ``cap``
    the out column a step writes at most (the call's cap − 1, a tensor so
    that no cap captures anew).  ``report`` (3, B) is what a step reads
    back: the step's ids, the active flags and ``n_gen``; ``h_active``
    and ``h_n_gen`` are its host copies.  ``graphs`` maps what a graph
    holds (``"step"``) to (CUDAGraph, its output) once captured;
    ``logits`` are the last step's.
    """

    def __init__(self, cache: dict, width: int):
        pos = cache["pos"]
        B, dev = pos.shape[0], pos.device
        i64 = dict(dtype=torch.int64, device=dev)
        self.cache = cache
        self.last = torch.zeros((B,), **i64)
        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.n_gen = torch.zeros((B,), **i64)
        self.stops = torch.ones((B,), **i64)
        self.out = torch.zeros((B, width), **i64)
        self.cap = torch.full((), width - 1, **i64)
        self.rows = torch.arange(B, device=dev)
        self.report = torch.zeros((3, B), **i64)
        self.h_active = np.zeros((B,), bool)
        self.h_n_gen = np.zeros((B,), np.int64)
        self.graphs: dict = {}
        self.logits = None

    def state(self) -> dict:
        """The tensors a step reads and writes besides the K/V planes."""
        return {"last": self.last, "active": self.active,
                "n_gen": self.n_gen, "stops": self.stops, "out": self.out,
                "cap": self.cap, "pos": self.cache["pos"]}

    def reset(self) -> None:
        """Every slot empty, at position 0 (the page table all trash)."""
        for t in self.state().values():
            t.zero_()
        self.stops.fill_(1)
        if "page_table" in self.cache:
            self.cache["page_table"].zero_()
        self.h_active[:] = False
        self.h_n_gen[:] = 0

    def start(self, first: torch.Tensor, stops) -> None:
        """Every slot starts a request at once (``generate``): first
        tokens ``first`` (B,) on the device, stop lengths ``stops`` (B,)
        host ints.  Positions are the cache's."""
        stops = np.asarray(stops, np.int64)
        self.last.copy_(first)
        self.out.zero_()
        self.out[:, 0] = first
        self.n_gen.fill_(1)
        self.stops.copy_(torch.from_numpy(stops))
        self.active.copy_(torch.from_numpy(stops > 1))
        self.h_active = stops > 1
        self.h_n_gen = np.ones_like(stops)

    def admit(self, b: int, first: int, stop: int) -> None:
        """Slot ``b`` starts a request whose first token is ``first``; the
        prefill sample is token #1, so a stop of 1 is done on arrival."""
        self.last[b] = first
        self.active[b] = stop > 1
        self.n_gen[b] = 1
        self.stops[b] = stop
        self.out[b] = 0
        self.out[b, 0] = first
        self.h_active[b] = stop > 1
        self.h_n_gen[b] = 1


class _SpecSlots(_Slots):
    """The speculative loop's carry (the state the reference's
    ``_spec_loop_fn`` threads through its ``while_loop``) in static device
    buffers: ``_Slots``' plus ``ctx`` (B, width) each slot's token history
    (prompt, then emitted tokens) and ``ctx_len`` (B,) its length, which
    the n-gram draft reads; ``dcache`` the model draft's cache with its
    ``pos`` (None for the n-gram draft); ``stats`` (4,) the rounds,
    proposed, accepted and emitted counters; ``vtokens`` (B, k + 1) the
    verify forward's input and ``dlast`` (B,) a draft step's.  A round's
    graphs are ``"round"`` (temperature 0) or ``"draft"`` and ``"verify"``
    (the forwards alone, above it)."""

    def __init__(self, cache: dict, width: int, k: int, dcache=None):
        super().__init__(cache, width)
        B, dev = self.last.shape[0], self.last.device
        i64 = dict(dtype=torch.int64, device=dev)
        self.ctx = torch.zeros((B, width), **i64)
        self.ctx_len = torch.zeros((B,), **i64)
        self.dcache = dcache
        self.stats = torch.zeros((4,), **i64)
        self.vtokens = torch.zeros((B, k + 1), **i64)
        self.dlast = torch.zeros((B,), **i64)

    def state(self) -> dict:
        s = {**super().state(), "ctx": self.ctx, "ctx_len": self.ctx_len,
             "stats": self.stats, "vtokens": self.vtokens,
             "dlast": self.dlast}
        if self.dcache is not None:
            s["dpos"] = self.dcache["pos"]
        return s

    def admit(self, b: int, first: int, stop: int, prompt) -> None:
        """``_Slots.admit``, and the slot's history: ``prompt`` then
        ``first``."""
        super().admit(b, first, stop)
        n = len(prompt)
        self.ctx[b] = 0
        self.ctx[b, :n] = torch.as_tensor(list(prompt), dtype=torch.int64)
        self.ctx[b, n] = first
        self.ctx_len[b] = n + 1


@dataclasses.dataclass
class SchedState:
    """One scheduler session's slot-pool state for the step-level API
    (``sched_*``, ``serve_step``); callers treat it as opaque.

    The per-slot vectors are host numpy mirrors of the decode loop's
    carry: admissions, releases and swaps edit one slot at a time there,
    ``serve_step`` copies them into the engine's static loop state
    ``loop`` (the ``_Slots`` that ``serve`` runs) before a round and reads
    them back after it.  ``pos`` are the slots' positions; a paged
    engine also keeps the page-table mirror ``pt_np`` and each slot's
    ``Admission`` (the pool lives on the engine)."""

    live: np.ndarray                 # (B,) bool: slot occupied
    last: np.ndarray                 # (B,) last sampled token
    n_gen: np.ndarray                # (B,) tokens emitted
    stops: np.ndarray                # (B,) stop lengths
    out: np.ndarray                  # (B, max_len) the emitted tokens
    pos: np.ndarray                  # (B,) positions
    loop: _Slots                     # the static loop state
    pt_np: np.ndarray | None = None  # paged: (B, P) page-table mirror
    adm: list | None = None          # paged: each slot's Admission


@dataclasses.dataclass
class SwapBlob:
    """Host image of one preempted request's serving state: what
    ``sched_swap_out`` copies out and ``sched_swap_in`` writes back
    verbatim (no recompute, no requantization).

    ``data`` maps cache plane names to host tensors: the request's pages
    with data (L, n_pages, page, ...) when paged, its slot's cache rows
    (L, pos, ...) when contiguous; under a mesh this rank's part of them
    (page / tp rows of each page, or its rows below ``pos``).  ``nbytes``
    are the whole request's bytes, every rank's parts together.
    ``reserve`` is the page reservation ``swap_in`` claims again."""

    paged: bool
    pos: int                         # tokens whose K/V are written
    stop: int                        # the request's stop length
    n_gen: int                       # tokens emitted so far
    last: int                        # last sampled token
    reserve: int                     # paged: pages to claim again
    n_pages: int                     # pages of data (the swap-cost unit)
    out_row: np.ndarray              # the emitted tokens
    data: dict                       # plane name -> host tensor
    nbytes: int = 0                  # bytes of data over all ranks


@dataclasses.dataclass
class ServeEngine:
    """Continuous-batching inference engine over one model + param set.

    max_batch:   slot-pool width for ``serve``.
    max_len:     cache capacity; prompt_len + max_new must fit.
    temperature: 0 = greedy argmax; >0 = categorical sampling through the
                 top-k / top-p filters.
    backend:     'dense' | 'codebook' | 'lut'.
    lut_levels / lut_range: activation grid of the 'lut' backend.
    paged:       serve() through the paged KV cache: chunked prefill,
                 per-slot page tables, admission gated on free pages.
    page_size:   tokens per page (paged mode).
    kv_dtype:    'bf16' — pages in the cache float dtype (f32 for f32
                 models); 'int8' — quantized pages + bf16 scales.
    prefix_cache: share full prompt pages across requests and serve()
                 calls (the pool persists on the engine).
    n_pages:     pool size; 0 → 1 trash page + max_batch × ⌈max_len /
                 page_size⌉ (the contiguous slab's capacity).
    device:      where the engine runs; None = the GPU (raises without one).
    seed:        seed of the sampling generator (temperature > 0).
    telemetry:   the telemetry registry (``serving/telemetry.py``); None
                 = the null registry.  A scheduler attaches its own.
    spec:        speculative decoding (``SpecConfig``) for ``serve``, on the
                 contiguous cache or (``paged=True``) the page pool.
    probes:      in-graph numerics probes: per-layer discretization
                 counters, collected in prefill and decode (``numerics()``).
    mesh:        a ``launch/mesh.Mesh`` with a ``model`` axis makes the
                 engine tensor-parallel (see the module docstring); needs
                 ``max_len % tp == 0``, paged ``page_size % tp == 0`` and,
                 with ``spec``, ``max_len / tp ≥ k + 1``.

    ``n_forwards`` counts model forwards run (prefill calls + decode
    steps, replayed or eager); ``n_captures`` the decode steps captured
    into a CUDA graph and ``n_replays`` the steps run by replay, so that
    the kernels' wrappers are called for ``n_forwards − n_replays +
    n_captures`` forwards.  A speculative round counts its verify forward
    there and its model draft's forwards (prefills, k + 1 decode steps a
    round) in ``n_draft_forwards``, ``n_draft_captures`` and
    ``n_draft_replays``; ``spec_stats`` accumulates the acceptance
    counters.  On the card decode takes the graph route; the private
    ``_graphs`` switch turns it off (the eager route, for holding one
    against the other).
    """

    model: Model
    params: dict
    max_len: int = 256
    temperature: float = 0.0
    backend: str = "dense"
    max_batch: int = 8
    lut_levels: int = 4096
    lut_range: tuple = (-16.0, 16.0)
    paged: bool = False
    page_size: int = 16
    kv_dtype: str = "bf16"
    prefix_cache: bool = True
    n_pages: int = 0
    top_k: int = 0
    top_p: float = 1.0
    device: object = None
    seed: int = 0
    spec: SpecConfig | None = None
    telemetry: object = None
    probes: bool = False
    mesh: object = None

    def __post_init__(self):
        if self.telemetry is None:
            self.telemetry = NULL_TELEMETRY
        cfg = self.model.cfg
        if cfg.family not in _ENGINE_FAMILIES:
            raise NotImplementedError(
                f"ServeEngine serves KV-cache token LMs {_ENGINE_FAMILIES}; "
                f"got family {cfg.family!r}")
        if self.backend not in dispatch.BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in "
                             f"{dispatch.BACKENDS}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype {self.kv_dtype!r} not in "
                             "('bf16', 'int8')")
        self.device = resolve_device(self.device)
        has_idx, fan_in, book = _index_form_stats(self.params)
        lut_spec = None
        if self.backend != "dense":
            if not has_idx:
                raise ValueError(
                    f"backend {self.backend!r} needs codebook-index params "
                    "(run serving.to_codebook_params first)")
            if self.backend == "lut":
                lut_spec = dispatch.make_lut_spec(
                    book, fan_in, levels=self.lut_levels,
                    a_range=self.lut_range)
                # the §4 tables are built once here, not in every layer call
                self.params = dispatch.attach_lut_tables(self.params, lut_spec)
        if self.mesh is not None:
            self._check_mesh()
        self._ps = {}
        self._probe_audit = {}
        if self.probes:
            if self.spec is not None:
                raise NotImplementedError(
                    "numerics probes instrument the plain decode loops; "
                    "speculative serve() is not instrumented — build the "
                    "engine with probes=False or spec=None")
            self._ps = nprobes.init_state(cfg.n_layers, self.device)
            # w_idx never changes at run time: audited once, here, on the
            # whole tree (before a mesh cuts it)
            self._probe_audit = nprobes.static_index_audit(self.params)
        if self.mesh is not None:
            self.params = self._shard_params(self.params)
        self.bk = dispatch.BackendSpec(self.backend, lut_spec, self.mesh)
        self._cache_dtype = (torch.float32 if cfg.dtype == "float32"
                             else torch.bfloat16)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self.n_forwards = self.n_captures = self.n_replays = 0
        self.n_draft_forwards = self.n_draft_captures = 0
        self.n_draft_replays = 0
        self.spec_stats = SpecStats()
        self._draft_bk = None
        if self.spec is not None:
            self._init_spec()
        self._pool: PagePool | None = None
        self._slot_sets: dict = {}
        # a CUDA graph cannot capture a gloo collective: eager under a mesh
        self._graphs = self.device.type == "cuda" and self.mesh is None
        self._graph_pool = None

    def _init_spec(self):
        """Validate ``spec``; for a model draft, its backend (a second
        ``BackendSpec``: the lut grid from the draft params' own
        codebooks and fan-in, the embedding's included, with its tables
        attached to the draft params)."""
        sp = self.spec
        if sp.draft not in ("ngram", "model"):
            raise ValueError(f"spec.draft {sp.draft!r} not in "
                             "('ngram', 'model')")
        if sp.k < 1:
            raise ValueError(f"spec.k must be >= 1, got {sp.k}")
        if sp.draft != "model":
            return
        if sp.draft_params is None:
            raise ValueError("spec.draft='model' needs spec.draft_params")
        if sp.draft_backend not in dispatch.BACKENDS:
            raise ValueError(f"draft backend {sp.draft_backend!r} not in "
                             f"{dispatch.BACKENDS}")
        dlut = None
        if sp.draft_backend != "dense":
            has_idx, fan_in, book = _index_form_stats(sp.draft_params)
            if not has_idx:
                raise ValueError(f"draft backend {sp.draft_backend!r} needs "
                                 "codebook-index draft_params")
            if sp.draft_backend == "lut":
                dlut = dispatch.make_lut_spec(book, fan_in,
                                              levels=sp.lut_levels,
                                              a_range=sp.lut_range)
                self.spec = dataclasses.replace(
                    sp, draft_params=dispatch.attach_lut_tables(
                        sp.draft_params, dlut))
        self._draft_bk = dispatch.BackendSpec(sp.draft_backend, dlut)

    @property
    def lut_spec(self):
        return self.bk.lut_spec

    # --- tensor parallelism -------------------------------------------------

    def _check_mesh(self) -> None:
        """The reference's checks of a mesh (its exception types and
        texts)."""
        mesh = self.mesh
        if "model" not in mesh.axis_names:
            raise ValueError("ServeEngine mesh needs a 'model' axis "
                             "(launch.mesh.make_local_mesh)")
        tp = mesh.shape["model"]
        if self.max_len % tp:
            raise ValueError(
                f"max_len {self.max_len} must be a multiple of the TP "
                f"degree {tp} (the cache shards its sequence axis over "
                "`model`)")
        if self.paged and self.page_size % tp:
            raise ValueError(
                f"page_size {self.page_size} must be a multiple of the "
                f"TP degree {tp} (each shard owns an S-slice of every "
                "page)")
        if self.spec is not None and self.max_len // tp < self.spec.k + 1:
            raise ValueError(
                f"max_len/tp = {self.max_len // tp} cannot hold the "
                f"k+1 = {self.spec.k + 1} verify rows of one shard")

    def _shard_params(self, params):
        """This rank's params under ``serve_param_specs``: its slice of each
        block matmul's ``w``/``w_idx`` (a copy; the whole leaf is
        dropped), every other leaf as it is; a moe model's expert weights
        cut by ``moe_param_specs``.  The reference's ``serve_param_specs``
        replicates the experts and its ``moe_apply`` cuts them on every
        call (its shard_map's in_specs); here they are cut once."""
        from repro_torch.distributed.sharding import (local_slice,
                                                      serve_param_specs)
        from repro_torch.models.moe import moe_param_specs
        from repro_torch.models.transformer import moe_cfg

        specs = serve_param_specs(params)
        if "moe" in params["blocks"]:
            mspecs = moe_param_specs(moe_cfg(self.model.cfg),
                                     self.mesh.shape["model"])
            for k in ("w1", "w3", "w2"):
                specs["blocks"]["moe"][k] = (None,) + mspecs[k]

        def walk(node, spec, path):
            if isinstance(node, dict):
                return {k: walk(v, spec[k], path + [k])
                        for k, v in node.items()}
            try:
                return local_slice(node, spec, self.mesh)
            except ValueError as e:
                raise ValueError(f"{'/'.join(path)} {tuple(node.shape)}: "
                                 f"{e}") from None

        return walk(params, specs, [])

    # --- numerics probes ---------------------------------------------------

    def _with_probes(self, cache: dict) -> dict:
        """``cache`` with the probe state injected for one forward (the
        same static buffers every call, so a captured forward adds into
        them on every replay); ``cache`` itself when probes are off."""
        return {**cache, "probes": self._ps} if self.probes else cache

    def numerics(self) -> dict:
        """The canonical numerics snapshot: per-layer saturation,
        headroom and KV error, and the static index audit (empty when
        probes are off); one read of the state.  The telemetry
        ``numerics`` provider.  Under a mesh every rank calls it at the
        same point of its host loop: the ranks' parts are combined here
        (``_mesh_counters``), and nowhere inside a step."""
        if not self.probes:
            return {}
        return nprobes.summarize(self._mesh_counters(),
                                 audit=self._probe_audit,
                                 backend=self.backend)

    def _mesh_counters(self) -> dict:
        """The probe state, under a mesh combined over the ``model``
        group (``kernels/probes``): ``act_sat`` and ``act_total`` summed
        (each rank counted its slices, replicated inputs on rank 0 only),
        ``acc_max`` the max over the ranks (a column shard's high-water
        mark is one rank's), the rest as they are (the same on every
        rank; ``kv_err_*`` 0 but for a contiguous prefill's int8 planes,
        which every rank computes whole).  Two collectives."""
        tp = self.mesh.tp if self.mesh is not None else 1
        if tp == 1:
            return self._ps
        from repro_torch.distributed import collectives
        st = dict(self._ps)
        sums = collectives.psum(torch.stack([st["act_sat"],
                                             st["act_total"]]), self.mesh)
        st["act_sat"], st["act_total"] = sums[0], sums[1]
        st["acc_max"] = collectives.pmax(st["acc_max"].clone(), self.mesh)
        return st

    def reset_probes(self) -> None:
        """Zero the counters (a fresh measurement window), in place: the
        captured graphs keep writing into the same buffers."""
        for t in self._ps.values():
            t.zero_()

    # --- forwards --------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, tokens, lengths):
        self.n_forwards += 1
        return self.model.prefill(
            self.params, self._with_probes({"tokens": tokens,
                                            "lengths": lengths}), self.bk)

    @torch.no_grad()
    def _draft_prefill(self, tokens, lengths):
        self.n_draft_forwards += 1
        return self.model.prefill(self.spec.draft_params,
                                  {"tokens": tokens, "lengths": lengths},
                                  self._draft_bk)

    @torch.no_grad()
    def _decode(self, last, cache):
        """The model's decode forward on ``cache`` for tokens ``last`` (B,):
        a device tensor (the loop's static ``last``) or host ids, copied
        to the card."""
        tokens = torch.as_tensor(last, device=self.device)[:, None]
        return self.model.decode(self.params, tokens, cache, self.bk)

    @torch.no_grad()
    def _prefill_chunk(self, tokens, page_row, start: int, length: int,
                       write_pid: int):
        self.n_forwards += 1
        logits, _ = self.model.prefill_chunk(
            self.params, {"tokens": tokens, "start": start, "length": length,
                          "page_row": page_row, "write_pid": write_pid},
            self._with_probes(self.pool.cache), self.bk)
        return logits

    def _sample(self, logits) -> torch.Tensor:
        """Greedy argmax, or temperature sampling through the filters."""
        lg = logits[:, -1, :self.model.cfg.vocab].to(torch.float32)
        if self.temperature > 0:
            lg = filter_logits(lg / self.temperature, self.top_k, self.top_p)
            probs = torch.softmax(lg, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(lg, dim=-1)

    # --- the decode loop ---------------------------------------------------

    def _slots(self, batch: int, paged: bool = False) -> _Slots:
        """The engine's static loop state for ``batch`` slots on the
        contiguous cache (``max_len`` long) or the page pool, made once."""
        key = (batch, paged)
        st = self._slot_sets.get(key)
        if st is None:
            cache = (self._paged_slot_cache(batch) if paged
                     else self._contiguous_cache(batch))
            st = self._slot_sets[key] = _Slots(cache, self.max_len)
        return st

    def _contiguous_cache(self, batch: int, whole: bool = False) -> dict:
        """A zeroed contiguous cache for ``batch`` slots: ``max_len`` rows,
        this rank's ``max_len / tp`` under a mesh (all of them for a
        ``whole`` one: the model draft's)."""
        tp = self.mesh.tp if self.mesh is not None and not whole else 1
        return self.model.init_cache(batch, self.max_len // tp,
                                     dtype=self._cache_dtype,
                                     device=self.device)

    def _paged_slot_cache(self, batch: int) -> dict:
        """The pool's planes with a static all-trash ``page_table`` (batch,
        pages a slot) and zero ``pos`` (batch,) of their own."""
        pool = self.pool
        return {**pool.cache,
                "page_table": torch.zeros((batch, pool.pages_per_slot),
                                          dtype=torch.int32,
                                          device=self.device),
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=self.device)}

    def _advance(self, st: _Slots, nxt: torch.Tensor) -> None:
        """The body of ``_loop_fn`` after the forward, on ``st`` in place:
        the sampled ids ``nxt`` (B,) enter the active slots and the out
        buffer, counts grow, slots at their stop retire, and the report
        takes the ids, the active flags and the counts."""
        nxt = torch.where(st.active, nxt, st.last)
        col = torch.minimum(torch.clamp(st.n_gen, min=0), st.cap)
        st.out[st.rows, col] = torch.where(st.active, nxt, st.out[st.rows, col])
        st.last.copy_(nxt)
        st.n_gen += st.active
        st.active &= st.n_gen < st.stops
        st.report[0].copy_(nxt)
        st.report[1].copy_(st.active)
        st.report[2].copy_(st.n_gen)

    def _forward(self, st: _Slots) -> torch.Tensor:
        """What a graph of ``st`` holds: the decode forward on the static
        cache, ``pos + 1`` copied back into the static ``pos``, and at
        temperature 0 the argmax and the bookkeeping.  With probes on, the
        forward adds into the engine's probe buffers.  Returns logits."""
        logits, cache = self._decode(st.last, self._with_probes(st.cache))
        st.cache["pos"].copy_(cache["pos"])
        if self.temperature == 0:
            self._advance(st, self._sample(logits))
        return logits

    def _capture(self, fn):
        """The first run of ``fn`` on the graph route: eagerly on a side
        stream (the warm-up: it builds and loads the kernels, opts them
        into their shared memory, and makes the cached constants, plans
        and scratch a capture must not make), then captured into the
        engine's graph memory pool.  Returns (the eager run's output,
        (CUDAGraph, the captured run's output)).  A capture that fails
        raises."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn()
        cur.wait_stream(side)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._graph_pool):
            captured = fn()
        return out, (graph, captured)

    def _graph_run(self, st: _Slots, key: str, fn, fwd: tuple = (1, 0)):
        """``fn``, which runs ``fwd`` = (target, draft) forwards on the
        static state ``st``: the replay of ``st.graphs[key]`` on the card
        (``_capture`` the first time), eagerly where ``_graphs`` is off.
        Counts the forwards, captures and replays.  Returns ``fn``'s
        output (on a replay, the graph's)."""
        t, d = fwd
        self.n_forwards += t
        self.n_draft_forwards += d
        if not self._graphs:
            return fn()
        g = st.graphs.get(key)
        if g is None:
            out, st.graphs[key] = self._capture(fn)
            self.n_captures += t
            self.n_draft_captures += d
            return out
        g[0].replay()
        self.n_replays += t
        self.n_draft_replays += d
        return g[1]

    @staticmethod
    def _read_report(st: _Slots) -> None:
        """The step's one read: the report into ``st.h_active`` and
        ``st.h_n_gen``."""
        report = st.report.to("cpu", copy=True).numpy()
        st.h_active = report[1].astype(bool)
        st.h_n_gen = report[2]

    @torch.no_grad()
    def _step(self, st: _Slots) -> None:
        """One decode step for every slot of ``st``: one graph replay on
        the card, the eager ``_forward`` where ``_graphs`` is off
        (``_graph_run``); then, at temperature > 0, the sample and the
        bookkeeping; then the one read of the report."""
        st.logits = self._graph_run(st, "step", lambda: self._forward(st))
        if self.temperature > 0:
            self._advance(st, self._sample(st.logits))
        self._read_report(st)

    # --- speculative rounds -----------------------------------------------

    def _new_spec_slots(self, batch: int, paged: bool = False) -> _SpecSlots:
        """A fresh speculative loop state for ``batch`` slots: the
        target's zeroed contiguous cache or, paged, the pool with a page
        table of its own (``_paged_slot_cache``); for a model draft, the
        draft's zeroed contiguous cache (on either target cache)."""
        target = (self._paged_slot_cache(batch) if paged
                  else self._contiguous_cache(batch))
        draft = (self._contiguous_cache(batch, whole=True)
                 if self.spec.draft == "model" else None)
        return _SpecSlots(target, self.max_len, self.spec.k, draft)

    def _spec_slots(self, batch: int, paged: bool = False) -> _SpecSlots:
        """The engine's static speculative loop state for ``batch`` slots
        on the contiguous cache or the pool (``_new_spec_slots``), made
        once."""
        key = (batch, paged, "spec")
        st = self._slot_sets.get(key)
        if st is None:
            st = self._slot_sets[key] = self._new_spec_slots(batch, paged)
        return st

    def _draft_forward(self, st: _SpecSlots) -> torch.Tensor:
        """One draft decode step on ``st.dcache`` for tokens ``st.dlast``,
        ``pos + 1`` copied back into its static ``pos``.  Returns
        logits."""
        logits, dc = self.model.decode(self.spec.draft_params,
                                       st.dlast[:, None], st.dcache,
                                       self._draft_bk)
        st.dcache["pos"].copy_(dc["pos"])
        return logits

    def _verify_forward(self, st: _SpecSlots) -> torch.Tensor:
        """The target's verify forward on ``st.vtokens``.  Returns logits
        (B, k + 1, V)."""
        return self.model.verify(self.params, st.vtokens, st.cache,
                                 self.bk)[0]

    def _propose(self, st: _SpecSlots):
        """The draft's k proposals (B, k), also written into
        ``st.vtokens`` behind each slot's last token, and, at temperature
        > 0 for a model draft, its distributions (B, k, V) (else None).

        A model draft runs k + 1 decode steps from each slot's last token:
        the last writes the final proposal's K/V (its own token is
        dropped), so after a round whose every proposal is accepted the
        draft cache holds every emitted token but the pending one.  At
        temperature 0 the steps are eager ops (inside the round's graph on
        the card); above it each step replays the captured draft forward
        and samples eagerly from the engine's generator."""
        sp = self.spec
        st.vtokens[:, 0].copy_(st.last)
        if sp.draft == "ngram":
            d_toks = ngram_propose(st.ctx, st.ctx_len, k=sp.k, n=sp.ngram)
            if "page_table" in st.cache:
                # the reference's paged round proposes on the host for the
                # active slots only, zeros elsewhere
                d_toks = torch.where(st.active[:, None], d_toks,
                                     torch.zeros_like(d_toks))
            st.vtokens[:, 1:].copy_(d_toks)
            return d_toks, None
        V = self.model.cfg.vocab
        st.dlast.copy_(st.last)
        toks, dists = [], []
        for _ in range(sp.k + 1):
            if self.temperature == 0:
                lg = self._draft_forward(st)[:, -1, :V].to(torch.float32)
                nxt = torch.argmax(lg, dim=-1)
            else:
                lg = self._graph_run(st, "draft",
                                     lambda: self._draft_forward(st), (0, 1))
                probs = target_dist(lg[:, -1, :V].to(torch.float32),
                                    self.temperature, self.top_k, self.top_p)
                nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
                dists.append(probs)
            st.dlast.copy_(nxt)
            toks.append(nxt)
        d_toks = torch.stack(toks[:sp.k], dim=1)
        st.vtokens[:, 1:].copy_(d_toks)
        return d_toks, torch.stack(dists[:sp.k], dim=1) if dists else None

    def _settle(self, st: _SpecSlots, n_acc, toks) -> None:
        """The round after acceptance, on ``st`` in place (the body of the
        reference's ``_spec_loop_fn``): each active slot emits ``m`` =
        min(n_acc + 1, tokens left) tokens into the out buffer and its
        history, its last token and positions advance by ``m`` (the
        rejected rows above ``pos`` are fenced by the valid length), the
        draft's ``pos`` rolls back to ``ctx_len − 1``, the counters grow,
        slots at their stop retire, and the report is written."""
        act = st.active
        remaining = torch.clamp(st.stops - st.n_gen, min=0)
        m = torch.where(act, torch.minimum(n_acc + 1, remaining),
                        torch.zeros_like(remaining))
        st.out.copy_(_splice_rows(st.out, toks, st.n_gen, m))
        st.ctx.copy_(_splice_rows(st.ctx, toks, st.ctx_len, m))
        emitted = toks[st.rows, torch.clamp(m - 1, min=0)]
        st.last.copy_(torch.where(act, emitted, st.last))
        st.cache["pos"] += m.to(st.cache["pos"].dtype)
        st.ctx_len += m
        st.n_gen += m
        if st.dcache is not None:
            st.dcache["pos"].copy_(torch.clamp(st.ctx_len - 1, min=0))
        st.stats += torch.stack([act.any().to(torch.int64),
                                 act.to(torch.int64).sum() * self.spec.k,
                                 torch.minimum(n_acc, m).sum(), m.sum()])
        st.active &= st.n_gen < st.stops
        st.report[0].copy_(st.last)
        st.report[1].copy_(st.active)
        st.report[2].copy_(st.n_gen)

    def _greedy_round(self, st: _SpecSlots) -> torch.Tensor:
        """What the round's graph holds at temperature 0: proposal,
        verify, argmax acceptance and ``_settle``.  Returns the verify
        logits."""
        d_toks, _ = self._propose(st)
        logits = self._verify_forward(st)
        lg = logits[..., :self.model.cfg.vocab].to(torch.float32)
        n_acc, toks = spec_accept(lg, d_toks, None, temperature=0.0)
        self._settle(st, n_acc, toks)
        return logits

    @torch.no_grad()
    def _spec_step(self, st: _SpecSlots) -> None:
        """One speculative round for every slot of ``st``, then the one
        read of the report.  Temperature 0: the whole round one graph
        replay (``_greedy_round``).  Above it: ``_propose``, the verify
        forward as a replay, then ``spec_accept`` from the engine's
        generator and ``_settle``, eagerly."""
        if self.temperature == 0:
            n_draft = self.spec.k + 1 if self.spec.draft == "model" else 0
            st.logits = self._graph_run(st, "round",
                                        lambda: self._greedy_round(st),
                                        (1, n_draft))
        else:
            d_toks, q = self._propose(st)
            st.logits = self._graph_run(st, "verify",
                                        lambda: self._verify_forward(st))
            lg = st.logits[..., :self.model.cfg.vocab].to(torch.float32)
            n_acc, toks = spec_accept(
                lg, d_toks, q, temperature=self.temperature,
                top_k=self.top_k, top_p=self.top_p, generator=self._gen)
            self._settle(st, n_acc, toks)
        self._read_report(st)

    def _decode_loop(self, st: _Slots, cap: int, *, stop_on_event: bool,
                     step=None):
        """One iteration == one ``step`` (``_step``, a token for every slot
        of ``st``; or ``_spec_step``, a round).

        Exits when every slot is retired, ``cap`` iterations are done, or
        (stop_on_event) some slot hits its stop length.  Writes at most
        column ``cap − 1`` of the out buffer, as the reference's buffer
        of width ``cap``.
        """
        step = step or self._step
        st.cap.fill_(cap - 1)
        steps = 0
        while st.h_active.any() and steps < cap:
            before = st.h_active
            step(st)
            steps += 1
            if stop_on_event and (before & ~st.h_active).any():
                break

    def _own_rows(self, S: int, S_loc: int) -> tuple:
        """(first, count) of a plane's first S rows that this rank's
        ``S_loc`` cache rows (global rows start = rank · S_loc on) hold:
        all of them without a mesh."""
        start = self.mesh.coords["model"] * S_loc if self.mesh else 0
        return start, max(0, min(S - start, S_loc))

    def _grow(self, cache):
        """Copy prefill-emitted K/V planes (S = prompt bucket) into the
        static cache of their batch size, zeros beyond S, with their
        positions; returns that cache.  Under a mesh this rank keeps its
        rows of the planes (the reference's ``_place_kv``)."""
        st = self._slots(cache["pos"].shape[0])
        for name, plane in cache["kv"].items():
            dst = st.cache["kv"][name]
            a, n = self._own_rows(plane.shape[2], dst.shape[2])
            dst[:, :, :n] = plane[:, :, a:a + n]
            dst[:, :, n:] = 0
        st.cache["pos"].copy_(cache["pos"])
        return st.cache

    def _splice(self, cache, c1, slot: int, whole: bool = False):
        """Copy a batch-1 prefill cache into slot ``slot`` (in place; this
        rank's rows of it under a mesh, all of them into a ``whole`` cache:
        the model draft's)."""
        for name, src in c1["kv"].items():
            dst = cache["kv"][name]
            a, n = ((0, min(src.shape[2], dst.shape[2])) if whole
                    else self._own_rows(src.shape[2], dst.shape[2]))
            dst[:, slot, :n] = src[:, 0, a:a + n].to(dst.dtype)
        cache["pos"][slot] = c1["pos"][0]
        return cache

    # --- prompt plumbing -------------------------------------------------

    def _pad_prompts(self, prompts):
        lens = [len(p) for p in prompts]
        if min(lens) < 1:
            raise ValueError("empty prompt")
        pb = _bucket(max(lens))
        if pb > self.max_len:
            raise ValueError(f"prompt bucket {pb} exceeds max_len "
                             f"{self.max_len}")
        toks = np.zeros((len(prompts), pb), np.int64)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
        return (torch.from_numpy(toks).to(self.device),
                torch.tensor(lens, dtype=torch.int32, device=self.device))

    # --- paged KV cache ---------------------------------------------------

    @property
    def pool(self) -> PagePool:
        """The engine's page pool (created on first use; persists across
        serve() calls so the prefix cache keeps earning hits)."""
        if self._pool is None:
            pps = -(-self.max_len // self.page_size)
            n_pages = self.n_pages or 1 + self.max_batch * pps
            dtype = (torch.int8 if self.kv_dtype == "int8"
                     else self._cache_dtype)
            self._pool = PagePool(
                self.model, n_pages=n_pages, page_size=self.page_size,
                pages_per_slot=pps, kv_dtype=dtype,
                prefix_cache=self.prefix_cache, device=self.device,
                shards=self.mesh.tp if self.mesh is not None else 1)
        return self._pool

    def dense_cache_bytes(self) -> int:
        """Device bytes of the contiguous K/V slab at this engine's shape
        (every leaf ``init_cache`` builds: int8 planes and their scales for
        ``cfg.kv_quant``): the baseline the paged pool is compared
        against."""
        cache = self.model.init_cache(self.max_batch, self.max_len,
                                      dtype=self._cache_dtype, device="meta")
        return sum(t.numel() * t.element_size() for t in cache["kv"].values())

    def _chunked_prefill(self, pool, prompt, adm):
        """Stream one admitted prompt through page-sized chunks; returns the
        logits of its last real position."""
        page = self.page_size
        row = torch.tensor(adm.pids + [0] * (pool.pages_per_slot
                                             - len(adm.pids)),
                           dtype=torch.int32, device=self.device)
        logits = None
        for ci, c in enumerate(range(adm.compute_from, adm.n_chunks)):
            toks = np.zeros((1, page), np.int64)
            chunk = prompt[c * page:(c + 1) * page]
            toks[0, :len(chunk)] = chunk
            logits = self._prefill_chunk(
                torch.from_numpy(toks).to(self.device), row, c * page,
                len(chunk), adm.write_pids[ci])
        return logits

    def _paged_admit(self, prompt, stop):
        """One request's paged admission: pool admission, chunked prefill,
        prefix registration, copy-on-write of a shared tail page, first
        token.  Returns (adm, first token), or (None, None) when the pool
        cannot admit it yet."""
        pool = self.pool
        adm = pool.admit(list(prompt), stop)
        if adm is None:
            return None, None
        logits = self._chunked_prefill(pool, list(prompt), adm)
        pool.register_prefill(adm)
        pool.cow(adm)     # shared tail page → private before decode writes
        return adm, int(self._sample(logits)[0])

    def _check_fits(self, prompts, stops_req) -> None:
        """Raise for a request whose pages can never fit the pool."""
        pool = self.pool
        for p, s in zip(prompts, stops_req):
            if pool.pages_needed(len(p), s) > pool.usable_pages:
                raise ValueError(
                    f"request (prompt {len(p)} + {s} new) can never fit the "
                    f"{pool.usable_pages}-page pool")

    @staticmethod
    def _set_row(pt, b: int, adm) -> None:
        """Row ``b`` of the static page table ``pt`` := ``adm``'s pages
        (trash beyond them; all trash for None), written in place."""
        row = [0] * pt.shape[1]
        if adm is not None:
            row[:len(adm.pids)] = adm.pids
        pt[b] = torch.tensor(row, dtype=torch.int32)

    def _serve_paged(self, prompts, stops_req):
        pool = self.pool
        self._check_fits(prompts, stops_req)
        n = len(prompts)
        B, cap = self.max_batch, max(stops_req)
        st = self._slots(B, paged=True)
        st.reset()                          # all-trash page-table rows
        pt, pos = st.cache["page_table"], st.cache["pos"]

        queue = deque(range(n))
        slot_rid: list[int | None] = [None] * B
        slot_adm: list = [None] * B
        results: dict[int, list[int]] = {}
        while queue or any(r is not None for r in slot_rid):
            # admission waits on free pages: a free slot with a short pool
            # stays empty until a retirement frees pages
            for b in [b for b in range(B) if slot_rid[b] is None]:
                if not queue:
                    break
                rid = queue[0]
                adm, first = self._paged_admit(prompts[rid], stops_req[rid])
                if adm is None:
                    break
                queue.popleft()
                self._set_row(pt, b, adm)
                pos[b] = len(prompts[rid])
                st.admit(b, first, stops_req[rid])
                slot_rid[b], slot_adm[b] = rid, adm
            if queue and all(r is None for r in slot_rid):
                raise RuntimeError(
                    "paged admission deadlock: no request in flight and the "
                    "pool cannot admit the next one")
            self._decode_loop(st, cap, stop_on_event=True)
            for b in range(B):            # harvest retired slots
                rid = slot_rid[b]
                if rid is not None and not st.h_active[b]:
                    results[rid] = (list(prompts[rid])
                                    + st.out[b, :st.h_n_gen[b]].tolist())
                    pool.retire(slot_adm[b])
                    pt[b] = 0                         # retired → trash page
                    pos[b] = 0
                    slot_rid[b], slot_adm[b] = None, None
        return [results[i] for i in range(n)]

    def _serve_paged_spec(self, prompts, stops_req):
        """Paged continuous batching with speculative rounds (the
        counterpart of the reference's ``_serve_paged_spec``), on the
        static state ``_spec_slots(B, paged=True)``.  Admission releases
        the worst-case tail (``truncate`` to the prompt); before each round
        every active slot ``extend``s its live pages over the span the
        verify writes (pos + k + 1), and after it ``truncate`` returns the
        emptied tail pages (kept reserved for the request, so the next
        extend cannot deadlock).  Each page-table edit is an in-place write
        into the static table a captured round reads.  A slot's position
        is known on the host: prompt length + tokens generated − 1.  The
        round itself is ``_spec_step``: at temperature 0 one replay of
        proposal, paged verify, acceptance and bookkeeping.  The model
        draft keeps its contiguous cache."""
        pool = self.pool
        self._check_fits(prompts, stops_req)
        n = len(prompts)
        B, K1 = self.max_batch, self.spec.k + 1
        st = self._spec_slots(B, paged=True)
        st.reset()                          # all-trash page-table rows
        if st.dcache is not None:
            for plane in st.dcache["kv"].values():
                plane.zero_()
        pt, pos = st.cache["page_table"], st.cache["pos"]

        queue = deque(range(n))
        slot_rid: list[int | None] = [None] * B
        slot_adm: list = [None] * B
        rows: list = [None] * B             # each slot's row as last written
        results: dict[int, list[int]] = {}

        def set_row(b):
            adm = slot_adm[b]
            row = None if adm is None else tuple(adm.pids)
            if row != rows[b]:
                self._set_row(pt, b, adm)
                rows[b] = row

        def at(b):                          # the slot's position
            return len(prompts[slot_rid[b]]) + int(st.h_n_gen[b]) - 1

        while queue or any(r is not None for r in slot_rid):
            for b in [b for b in range(B) if slot_rid[b] is None]:
                if not queue:
                    break
                rid = queue[0]
                adm, first = self._paged_admit(prompts[rid], stops_req[rid])
                if adm is None:
                    break
                queue.popleft()
                plen = len(prompts[rid])
                slot_rid[b], slot_adm[b] = rid, adm
                # release the worst-case tail: rounds extend it back page
                # by page as speculation needs it
                pool.truncate(adm, plen)
                set_row(b)
                pos[b] = plen
                st.admit(b, first, stops_req[rid], prompts[rid])
                if st.dcache is not None:
                    toks1, len1 = self._pad_prompts([prompts[rid]])
                    self._splice(st.dcache,
                                 self._draft_prefill(toks1, len1)[1], b,
                                 whole=True)
            if queue and all(r is None for r in slot_rid):
                raise RuntimeError(
                    "paged admission deadlock: no request in flight and the "
                    "pool cannot admit the next one")
            act = [b for b in range(B)
                   if slot_rid[b] is not None and st.h_active[b]]
            if act:
                for b in act:
                    pool.extend(slot_adm[b], at(b) + K1)
                    set_row(b)
                self._spec_step(st)
                for b in act:               # rollback: emptied tail pages
                    pool.truncate(slot_adm[b], at(b))
                    set_row(b)
            for b in range(B):              # harvest retired slots
                rid = slot_rid[b]
                if rid is not None and not st.h_active[b]:
                    results[rid] = (list(prompts[rid])
                                    + st.out[b, :st.h_n_gen[b]].tolist())
                    pool.retire(slot_adm[b])
                    slot_rid[b], slot_adm[b] = None, None
                    set_row(b)              # retired → trash page
                    pos[b] = 0
                    # no history: the draft's next rollback puts the slot
                    # at position 0, as the reference's does
                    st.ctx_len[b] = 0
        self.spec_stats.add(*st.stats.tolist())
        return [results[i] for i in range(n)]

    # --- step-level scheduling API ------------------------------------------

    def sched_check(self, prompt, stop: int) -> None:
        """Raise for a request this engine could never admit (a scheduler
        calls this at submission, so that it fails there and not in the
        queue)."""
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if stop < 1:
            raise ValueError("max_new must be >= 1")
        if len(prompt) + stop > self.max_len:
            raise ValueError("prompt + max_new exceeds max_len")
        if self.paged:
            pool = self.pool
            needed = pool.pages_needed(len(prompt), stop)
            if needed > min(pool.pages_per_slot, pool.usable_pages):
                raise ValueError(
                    f"request needs {needed} pages but the slot holds "
                    f"{pool.pages_per_slot} and the pool "
                    f"{pool.usable_pages}")

    def sched_state(self) -> SchedState:
        """A scheduler session's state on the engine's static loop state
        ``_slots(max_batch, paged)``, reset (and, contiguous, its cache
        zeroed, as ``serve`` does): a ``serve`` call and a session may
        follow each other on one engine.  The pool lives on the engine, so
        its prefix cache persists across sessions as across serves."""
        if self.spec is not None:
            raise NotImplementedError(
                "the step-level API drives plain decode rounds; speculative "
                "serve() remains a batch mode")
        B = self.max_batch
        loop = self._slots(B, self.paged)
        loop.reset()
        if not self.paged:
            for plane in loop.cache["kv"].values():
                plane.zero_()
        st = SchedState(
            live=np.zeros((B,), bool), last=np.zeros((B,), np.int64),
            n_gen=np.zeros((B,), np.int64), stops=np.ones((B,), np.int64),
            out=np.zeros((B, self.max_len), np.int64),
            pos=np.zeros((B,), np.int64), loop=loop)
        if self.paged:
            st.pt_np = np.zeros((B, self.pool.pages_per_slot), np.int32)
            st.adm = [None] * B
        return st

    @staticmethod
    def _start_slot(st: SchedState, slot: int, pos: int, stop: int,
                    out_row) -> None:
        """Slot ``slot``'s mirrors: a request at ``pos`` with stop length
        ``stop`` that has emitted ``out_row``; then it is live."""
        st.pos[slot] = pos
        st.stops[slot] = stop
        st.n_gen[slot] = len(out_row)
        st.last[slot] = out_row[-1]
        st.out[slot] = 0
        st.out[slot, :len(out_row)] = out_row
        st.live[slot] = True

    def sched_admit(self, st: SchedState, slot: int, prompt,
                    stop: int) -> int | None:
        """Prefill one request into free slot ``slot``.  Returns its first
        sampled token, or None when the pool cannot supply its page
        reservation yet (nothing is allocated then)."""
        prompt = list(prompt)
        if self.paged:
            adm, first = self._paged_admit(prompt, stop)
            if adm is None:
                self.telemetry.count("engine.admit_blocked")
                return None
            st.adm[slot] = adm
            st.pt_np[slot] = 0
            st.pt_np[slot, :len(adm.pids)] = adm.pids
        else:
            toks1, len1 = self._pad_prompts([prompt])
            lg1, c1 = self._prefill(toks1, len1)
            first = int(self._sample(lg1)[0])
            self._splice(st.loop.cache, c1, slot)
        self._start_slot(st, slot, len(prompt), stop, [first])
        return first

    def _load(self, st: SchedState, active, stops) -> None:
        """The mirrors into the static loop state, before a round: every
        buffer a step reads, so that nothing of an earlier round or
        ``serve`` survives into the replay."""
        loop = st.loop
        for dst, src in ((loop.last, st.last), (loop.n_gen, st.n_gen),
                         (loop.stops, stops), (loop.out, st.out),
                         (loop.active, active), (loop.cache["pos"], st.pos)):
            dst.copy_(torch.from_numpy(src))
        if self.paged:
            loop.cache["page_table"].copy_(torch.from_numpy(st.pt_np))
        loop.h_active = active.copy()
        loop.h_n_gen = st.n_gen.copy()

    def serve_step(self, st: SchedState, quantum: int = 1):
        """One bounded decode round: every live, unfinished slot emits up
        to ``quantum`` tokens in lockstep (``serve``'s decode loop on the
        same static state, with per-round stop lengths; one CUDA graph
        replay a step on the card), then one read brings the round's
        tokens, counts and positions back to the mirrors.

        Returns ``(tokens, finished)``: the new tokens per slot, and the
        slots whose requests reached their stop (the caller harvests and
        ``sched_release``s them)."""
        act = st.live & (st.n_gen < st.stops)
        if not act.any():
            return {}, []
        prev = st.n_gen.copy()
        self._load(st, act, np.minimum(st.stops, st.n_gen + quantum))
        loop = st.loop
        self._decode_loop(loop, self.max_len, stop_on_event=False)
        B = len(act)
        back = torch.cat([loop.last, loop.n_gen,
                          loop.cache["pos"].to(torch.int64),
                          loop.out.reshape(-1)]).to("cpu").numpy()
        st.last, st.n_gen = back[:B].copy(), back[B:2 * B].copy()
        st.pos, st.out = back[2 * B:3 * B].copy(), \
            back[3 * B:].reshape(B, -1).copy()
        toks, done = {}, []
        for b in range(B):
            if not st.live[b]:
                continue
            if st.n_gen[b] > prev[b]:
                toks[b] = st.out[b, prev[b]:st.n_gen[b]].tolist()
            if st.n_gen[b] >= st.stops[b]:
                done.append(b)
        tel = self.telemetry
        if tel.enabled and toks:
            tel.count("engine.steps")
            tel.count("engine.tokens", sum(len(t) for t in toks.values()))
            tel.observe("engine.batch_occupancy", len(toks))
            tel.count("engine.stops_finished", len(done))
            tel.count("engine.stops_quantum", len(toks) - len(done))
        return toks, done

    def sched_release(self, st: SchedState, slot: int) -> None:
        """Retire a finished slot.  Paged: the request's pages go back to
        the pool (its prefix registration included, as in ``serve``);
        contiguous: the next admission's splice overwrites its rows."""
        if self.paged:
            self.pool.retire(st.adm[slot])
            st.adm[slot] = None
            st.pt_np[slot] = 0
        st.pos[slot] = 0
        st.live[slot] = False

    def _gather_pages(self, pids) -> dict:
        """Every plane's pages ``pids`` of every layer, on the host: one
        ``ops.gather_pages_many`` launch for the whole request, each
        (L, n_pages, page, ...) plane viewed as an (L·n_pages, page, ...)
        pool and gathered with an (L, len(pids)) table of ``pid + l ·
        n_pages``.  The copy to the host is a blocking one: it has
        completed when this returns."""
        cache = self.pool.cache
        planes = list(cache.values())
        L, n_pages = planes[0].shape[:2]
        table = (torch.as_tensor(pids, dtype=torch.int32)[None]
                 + n_pages * torch.arange(L, dtype=torch.int32)[:, None])
        got = ops.gather_pages_many(
            [p.reshape((L * n_pages,) + tuple(p.shape[2:])) for p in planes],
            table.to(self.device))
        return {k: g.to("cpu") for k, g in zip(cache, got)}

    def sched_swap_out(self, st: SchedState, slot: int) -> SwapBlob:
        """Preempt slot ``slot``: copy its K/V to a host blob, then release
        its device resources (paged: page references drop, prefix-cache
        entries survive: ``PagePool.swap_out``).  The copy completes
        before the release, since a released page can be allocated and
        written by the next admission at once."""
        gen, stop = int(st.n_gen[slot]), int(st.stops[slot])
        last, pos = int(st.last[slot]), int(st.pos[slot])
        out_row = st.out[slot, :gen].copy()
        n_data = -(-pos // self.page_size)
        tp = self.mesh.tp if self.mesh is not None else 1
        if self.paged:
            adm = st.adm[slot]
            reserve = adm.reserve
            data = self._gather_pages(adm.pids[:n_data])
            self.pool.swap_out(adm)
            st.adm[slot] = None
            st.pt_np[slot] = 0
            nbytes = tp * sum(int(d.nbytes) for d in data.values())
        else:
            reserve = 0
            kv = st.loop.cache["kv"]
            # this rank's rows below pos (all of them without a mesh)
            data = {k: v[:, slot, :self._own_rows(pos, v.shape[2])[1]].to(
                        "cpu", copy=True) for k, v in kv.items()}
            nbytes = sum(v[:, slot, :1].nbytes * pos for v in kv.values())
        st.pos[slot] = 0
        st.live[slot] = False
        return SwapBlob(paged=self.paged, pos=pos, stop=stop, n_gen=gen,
                        last=last, reserve=reserve, n_pages=n_data,
                        out_row=out_row, data=data, nbytes=nbytes)

    def sched_swap_in(self, st: SchedState, slot: int,
                      blob: SwapBlob) -> bool:
        """Restore a swapped-out request into free slot ``slot``, bit-exact
        (its pages or rows written back verbatim, in place), so that its
        continuation equals a run that was never preempted.  Returns False
        when the pool cannot supply its reservation yet.  The blob may come
        from another engine of the same cache layout; a plane whose layout
        does not match raises."""
        if self.paged:
            pool = self.pool
            for k, v in pool.cache.items():
                d = blob.data.get(k)
                if d is None or tuple(d.shape[2:]) != tuple(v.shape[2:]) \
                        or d.shape[0] != v.shape[0]:
                    raise ValueError(
                        f"swap-in blob plane {k!r} does not match this "
                        "engine's cache layout: migration needs identically "
                        "shaped replicas")
            adm = pool.swap_in(blob.reserve)
            if adm is None:
                self.telemetry.count("engine.swap_in_blocked")
                return False
            pids = torch.as_tensor(adm.pids[:blob.n_pages],
                                   device=self.device)
            for k, v in pool.cache.items():
                v[:, pids] = blob.data[k].to(self.device, v.dtype)
            st.adm[slot] = adm
            st.pt_np[slot] = 0
            st.pt_np[slot, :len(adm.pids)] = adm.pids
        else:
            for k, v in st.loop.cache["kv"].items():
                n = self._own_rows(blob.pos, v.shape[2])[1]
                v[:, slot] = 0
                v[:, slot, :n] = blob.data[k].to(self.device, v.dtype)
        self._start_slot(st, slot, blob.pos, blob.stop, blob.out_row)
        return True

    # --- public API --------------------------------------------------------

    def generate(self, prompts: list[list[int]],
                 max_new: int = 32) -> list[list[int]]:
        """Continuation for a fixed batch of prompts: one prefill, then the
        decode loop until every row has ``max_new`` tokens."""
        B = len(prompts)
        toks, lengths = self._pad_prompts(prompts)
        if int(lengths.max()) + max_new > self.max_len:
            raise ValueError("prompt + max_new exceeds max_len")
        logits, cache = self._prefill(toks, lengths)
        self._grow(cache)
        st = self._slots(B)
        st.start(self._sample(logits), [max_new] * B)
        self._decode_loop(st, max_new, stop_on_event=False)
        return [list(p) + row
                for p, row in zip(prompts, st.out[:, :max_new].tolist())]

    def serve(self, prompts: list[list[int]], max_new=32) -> list[list[int]]:
        """Continuous batching over a queue of requests.

        ``max_new`` is an int or a per-request list.  Requests beyond
        ``max_batch`` wait; whenever one in flight finishes, its slot is
        harvested and the next queued request joins between decode steps.
        With ``spec`` set, decode runs in speculative rounds (k drafted
        tokens verified a forward); at temperature 0 the output equals the
        baseline serve's, token for token.  Returns prompt + continuation
        per request, in submission order.
        """
        n = len(prompts)
        stops_req = ([max_new] * n if isinstance(max_new, int)
                     else list(max_new))
        for p, s in zip(prompts, stops_req):
            if len(p) < 1:
                raise ValueError("empty prompt")
            if len(p) + s > self.max_len:
                raise ValueError("prompt + max_new exceeds max_len")
            if s < 1:
                raise ValueError("max_new must be >= 1")
            if self.spec is not None and len(p) + s + self.spec.k \
                    > self.max_len:
                raise ValueError(
                    "prompt + max_new + spec.k exceeds max_len (the verify "
                    "forward needs k rows of speculative headroom)")
        if self.paged:
            if self.spec is not None:
                return self._serve_paged_spec(prompts, stops_req)
            return self._serve_paged(prompts, stops_req)
        B, cap = self.max_batch, max(stops_req)
        spec = self.spec is not None
        st = self._spec_slots(B) if spec else self._slots(B)
        st.reset()
        caches = [st.cache] + ([st.dcache] if spec and st.dcache else [])
        for c in caches:                        # a fresh cache, as the
            for plane in c["kv"].values():      # reference's init_cache
                plane.zero_()

        queue = deque(range(n))
        slot_rid: list[int | None] = [None] * B
        results: dict[int, list[int]] = {}
        while queue or any(r is not None for r in slot_rid):
            for b in range(B):            # admit into every free slot
                if slot_rid[b] is not None or not queue:
                    continue
                rid = queue.popleft()
                toks1, len1 = self._pad_prompts([prompts[rid]])
                lg1, c1 = self._prefill(toks1, len1)
                first = int(self._sample(lg1)[0])
                self._splice(st.cache, c1, b)
                if not spec:
                    st.admit(b, first, stops_req[rid])
                else:
                    if st.dcache is not None:
                        self._splice(st.dcache,
                                     self._draft_prefill(toks1, len1)[1], b,
                                     whole=True)
                    st.admit(b, first, stops_req[rid], prompts[rid])
                slot_rid[b] = rid
            self._decode_loop(st, cap, stop_on_event=True,
                              step=self._spec_step if spec else self._step)
            for b in range(B):            # harvest retired slots
                rid = slot_rid[b]
                if rid is not None and not st.h_active[b]:
                    results[rid] = (list(prompts[rid])
                                    + st.out[b, :st.h_n_gen[b]].tolist())
                    slot_rid[b] = None
        if spec:
            self.spec_stats.add(*st.stats.tolist())
        return [results[i] for i in range(n)]
