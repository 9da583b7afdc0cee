"""Batched serving engine over the contiguous KV cache (the port's copy of
the contiguous ``ServeEngine`` of ``repro/serving/engine.py``).

* **Prefill** runs the whole right-padded prompt batch in one forward;
  prompt lengths are bucketed to powers of two (at least 8), logits come
  from each row's last real position, and the K/V planes are padded to
  ``max_len``.
* **Decode** is a Python loop over ``decode_step`` (the reference's
  ``lax.while_loop``).  Per-request stop lengths retire rows in place;
  retired rows keep decoding into their own clamped cache slot until the
  loop exits.
* **Continuous batching** (``serve``): the batch is a pool of ``max_batch``
  slots.  Each request prefills alone and is spliced into a free slot at its
  own position offset; the loop exits when some request finishes, the slot
  is harvested, the next request admitted, and decoding resumes.

The matmul backend (``dense`` | ``codebook`` | ``lut``) is a field of the
engine, passed down to every layer as a ``kernels.dispatch.BackendSpec``.
``codebook``/``lut`` need index-form params (``to_codebook_params``).
Paged KV, speculative decoding, tensor parallelism, probes, telemetry and
the step-level scheduling API are not ported yet.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch
from repro_torch.models.model_zoo import Model
from repro_torch.serving.spec import filter_logits

__all__ = ["ServeEngine"]

_ENGINE_FAMILIES = ("dense",)


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


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


@dataclasses.dataclass
class ServeEngine:
    """Continuous-batching inference engine over one model + param set.

    max_batch:   slot-pool width for ``serve``.
    max_len:     cache capacity; prompt_len + max_new must fit.
    temperature: 0 = greedy argmax; >0 = categorical sampling through the
                 top-k / top-p filters.
    backend:     'dense' | 'codebook' | 'lut'.
    lut_levels / lut_range: activation grid of the 'lut' backend.
    device:      where the engine runs; None = the GPU (raises without one).
    seed:        seed of the sampling generator (temperature > 0).

    ``n_forwards`` counts model forwards (prefill calls + decode steps).
    """

    model: Model
    params: dict
    max_len: int = 256
    temperature: float = 0.0
    backend: str = "dense"
    max_batch: int = 8
    lut_levels: int = 4096
    lut_range: tuple = (-16.0, 16.0)
    top_k: int = 0
    top_p: float = 1.0
    device: object = None
    seed: int = 0

    def __post_init__(self):
        cfg = self.model.cfg
        if cfg.family not in _ENGINE_FAMILIES:
            raise NotImplementedError(
                f"ServeEngine serves {_ENGINE_FAMILIES}; got {cfg.family!r}")
        if self.backend not in dispatch.BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in "
                             f"{dispatch.BACKENDS}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
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
        self.bk = dispatch.BackendSpec(self.backend, lut_spec)
        self._cache_dtype = (torch.float32 if cfg.dtype == "float32"
                             else torch.bfloat16)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self.n_forwards = 0

    @property
    def lut_spec(self):
        return self.bk.lut_spec

    # --- forwards --------------------------------------------------------

    @torch.no_grad()
    def _prefill(self, tokens, lengths):
        self.n_forwards += 1
        return self.model.prefill(self.params, {"tokens": tokens,
                                                "lengths": lengths}, self.bk)

    @torch.no_grad()
    def _decode(self, last: np.ndarray, cache):
        self.n_forwards += 1
        tokens = torch.from_numpy(last).to(self.device)[:, None]
        return self.model.decode(self.params, tokens, cache, self.bk)

    def _sample(self, logits) -> torch.Tensor:
        """Greedy argmax, or temperature sampling through the filters."""
        lg = logits[:, -1, :self.model.cfg.vocab].to(torch.float32)
        if self.temperature > 0:
            lg = filter_logits(lg / self.temperature, self.top_k, self.top_p)
            probs = torch.softmax(lg, dim=-1)
            return torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.argmax(lg, dim=-1)

    def _grow(self, cache):
        """Pad prefill-emitted K/V planes (S = prompt bucket) to max_len."""
        kv = {}
        for name, plane in cache["kv"].items():
            L, B, S = plane.shape[:3]
            full = plane.new_zeros((L, B, self.max_len) + plane.shape[3:])
            full[:, :, :S] = plane
            kv[name] = full
        return {**cache, "kv": kv}

    def _decode_loop(self, cache, last, active, n_gen, stops, out, *,
                     stop_on_event: bool):
        """One iteration == one token for every slot.

        ``last``/``active``/``n_gen``/``stops``/``out`` are host numpy
        arrays updated in place; the sampled ids are the one device→host
        copy per step.  Exits when every slot is retired, the out buffer
        is full, or (stop_on_event) some slot hits its stop length.
        Returns the cache.
        """
        B, cap = out.shape
        rows = np.arange(B)
        steps = 0
        while active.any() and steps < cap:
            logits, cache = self._decode(last, cache)
            nxt = self._sample(logits).cpu().numpy()
            last[:] = np.where(active, nxt, last)
            col = np.clip(n_gen, 0, cap - 1)
            out[rows, col] = np.where(active, last, out[rows, col])
            n_gen += active
            newly = active & (n_gen >= stops)
            active &= ~newly
            steps += 1
            if stop_on_event and newly.any():
                break
        return cache

    def _splice(self, cache, c1, slot: int):
        """Copy a batch-1 prefill cache into slot ``slot`` (in place)."""
        for name, src in c1["kv"].items():
            dst = cache["kv"][name]
            dst[:, slot, :src.shape[2]] = src[:, 0].to(dst.dtype)
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
        cache = self._grow(cache)
        first = self._sample(logits).cpu().numpy()
        stops = np.full((B,), max_new, np.int64)
        n_gen = np.ones((B,), np.int64)
        active = n_gen < stops
        out = np.zeros((B, max_new), np.int64)
        out[:, 0] = first
        self._decode_loop(cache, first, active, n_gen, stops, out,
                          stop_on_event=False)
        return [list(p) + out[i, :max_new].tolist()
                for i, p in enumerate(prompts)]

    def serve(self, prompts: list[list[int]], max_new=32) -> list[list[int]]:
        """Continuous batching over a queue of requests.

        ``max_new`` is an int or a per-request list.  Requests beyond
        ``max_batch`` wait; whenever one in flight finishes, its slot is
        harvested and the next queued request joins between decode steps.
        Returns prompt + continuation per request, in submission order.
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
        B, cap = self.max_batch, max(stops_req)
        cache = self.model.init_cache(B, self.max_len, dtype=self._cache_dtype,
                                      device=self.device)
        last = np.zeros((B,), np.int64)
        active = np.zeros((B,), bool)
        n_gen = np.zeros((B,), np.int64)
        stops = np.ones((B,), np.int64)
        out = np.zeros((B, cap), np.int64)

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
                cache = self._splice(cache, c1, b)
                last[b] = first
                # the prefill sample is token #1: a stop of 1 is done on
                # arrival
                active[b] = stops_req[rid] > 1
                n_gen[b] = 1
                stops[b] = stops_req[rid]
                out[b] = 0
                out[b, 0] = first
                slot_rid[b] = rid
            cache = self._decode_loop(cache, last, active, n_gen, stops, out,
                                      stop_on_event=True)
            for b in range(B):            # harvest retired slots
                rid = slot_rid[b]
                if rid is not None and not active[b]:
                    results[rid] = (list(prompts[rid])
                                    + out[b, :n_gen[b]].tolist())
                    slot_rid[b] = None
        return [results[i] for i in range(n)]
