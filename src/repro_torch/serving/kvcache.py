"""Paged KV-cache allocator (the port's copy of ``repro/serving/kvcache.py``).

The cache is a global pool of fixed-size pages, int8 with per-token-per-head
scales or plain floats, allocated on demand: concurrency is a function of
the tokens in flight, not of ``max_batch × max_len``.

* **Device**: the pool tensors ``(L, n_pages, page, KV, hd)`` [+ scales]
  (``transformer.init_paged_cache``), with per-slot page tables and
  positions threaded through ``prefill_chunk`` and the paged
  ``decode_step``.  Page 0 is the **trash page**: never allocated, the
  write target of retired slots and of recomputed shared chunks.
* **Host** (``PagePool``, this module): free-list allocation, per-page
  refcounts, the content-addressed prefix cache with LRU eviction,
  copy-on-write, speculative ``truncate``/``extend``, preemption
  ``swap_out``/``swap_in``, and the fleet's ``SharedPrefixTier``.  All host
  structures are O(n_pages) ints.  Every decision is the reference's, in
  the same order, so the same calls give the same page ids.

Prefix caching is content-addressed by hash chains: page c of a prompt is
keyed by a BLAKE2b digest of ``(key(c−1), tokens of page c as int64)``, so a
page is shared only when the whole prefix matches.  The digests are the
reference's bytes: the same prompt gets the same keys in both packages.

The page movers ``_copy_page``/``_write_page`` copy over the page axis of
every pool tensor in place.

Under tensor parallelism (``shards`` = tp) every rank keeps the whole host
side, identical on every rank (the same calls in the same order give the
same page ids, so the ranks decide alike by construction), and a device
pool of its own in-page slice: page / tp rows of every page.  A
copy-on-write copies the rank's slice; the byte counts (``bytes_per_page``,
``bytes_total``, ``bytes_in_use``) are a rank's, but the shared tier's
(``SharedPrefixTier.bytes``), which count whole pages.
"""

from __future__ import annotations

import dataclasses
import hashlib

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["PagePool", "PoolStats", "Admission", "SharedPrefixTier",
           "chain_keys"]

# hash-chain seed for page 0 of every prompt
_ROOT = hashlib.blake2b(b"repro.kv.chain-root", digest_size=16).digest()


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _page_key(prev: bytes, page_tokens) -> bytes:
    """Next link of the rolling chain: BLAKE2b-128 of the previous key
    concatenated with the page's tokens as int64 bytes."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.asarray(page_tokens, np.int64).tobytes())
    return h.digest()


def chain_keys(tokens, page_size: int) -> tuple[list, bytes | None]:
    """The prompt's content-addressed prefix chain: one key per FULL page
    (page c keyed by a digest of ``key(c−1)`` and the page's tokens) plus
    the partial tail page's key when the prompt is not page-aligned, else
    None.

    Keys are rolling 16-byte BLAKE2b digests: page c's key hashes the
    previous key (itself a digest of the whole prior chain) with page c's
    tokens, so equality certifies that the *entire* prefix matches.
    Digests (unlike salted ``hash()``) are identical across processes,
    machines and the two packages.  ``PagePool.admit`` plans with them and
    ``SharedPrefixTier`` stores pages under them, so a tier-served hit is
    exactly an admit-time hit."""
    page = int(page_size)
    toks = np.asarray(tokens, np.int64)
    n_full = len(toks) // page
    keys, key = [], _ROOT
    for c in range(n_full):
        key = _page_key(key, toks[c * page:(c + 1) * page])
        keys.append(key)
    partial = None
    if len(toks) % page:
        partial = _page_key(key, toks[n_full * page:])
    return keys, partial


@dataclasses.dataclass
class PoolStats:
    """Cumulative pool counters (benchmarks read these)."""

    hit_pages: int = 0           # prompt pages reused from the prefix cache
    miss_pages: int = 0          # prompt pages computed fresh
    # pages materialized from the fleet's shared tier instead of computed
    # (each also lands in hit_pages via the admission plan that follows —
    # miss_pages alone remains "true recomputations")
    shared_hit_pages: int = 0
    cow_copies: int = 0
    evictions: int = 0
    peak_pages_in_use: int = 0
    peak_page_refs: int = 0      # refcount high-water across all pages
    truncated_pages: int = 0     # pages returned by speculative rollback
    # Swap counters count page *references* released/re-acquired by the
    # pool (the full reservation), not data pages moved.
    swapped_out_pages: int = 0   # page refs released by scheduler preemption
    swapped_in_pages: int = 0    # page refs re-acquired by swap-in

    @property
    def hit_rate(self) -> float:
        total = self.hit_pages + self.miss_pages
        return self.hit_pages / total if total else 0.0


@dataclasses.dataclass
class Admission:
    """One admitted request's page plan (host-side bookkeeping handle).

    pids:         physical page per logical page, length = worst-case pages
                  for prompt + stop tokens (decode never allocates mid-loop).
    n_chunks:     logical prompt pages (= prefill chunks).
    compute_from: first chunk index to run through ``prefill_chunk`` (earlier
                  chunks are full-page prefix-cache hits; the chunk holding
                  the last prompt token is always computed — its logits seed
                  sampling).
    write_pids:   per computed chunk, the physical page receiving its K/V —
                  0 (trash) for shared pages recomputed only for logits.
    full_keys:    (chunk_idx, chain_key) of every full prompt page, for
                  registration after prefill.
    partial_key:  chain key of a non-aligned prompt's tail page (registered
                  at retirement), else None.
    cow_tail:     logical index of a *shared* tail page the request must
                  copy-on-write before decode writes into it, else None.
    reserve:      admission-time worst-case page count — the request's
                  standing claim on the pool even while ``truncate`` has
                  released some of its pages (speculative rollback).
    n_live:       leading pids currently allocated; pids beyond it are 0
                  (trash) placeholders until ``extend`` re-grows the span.
    """

    pids: list
    n_chunks: int
    compute_from: int
    write_pids: list
    full_keys: list
    partial_key: bytes | None
    cow_tail: int | None
    reserve: int = 0
    n_live: int = 0


def _copy_page(cache, src, dst):
    """cache[:, dst] = cache[:, src] for every pool tensor (all layers), in
    place.  Returns the cache."""
    for arr in cache.values():
        arr[:, dst] = arr[:, src]
    return cache


def _write_page(cache, dst, page):
    """cache[:, dst] = page for every pool tensor (all layers), in place:
    the scatter that materializes a shared-tier host page into this pool.
    Returns the cache."""
    for name, arr in cache.items():
        arr[:, dst] = torch.as_tensor(page[name]).to(arr.device, arr.dtype)
    return cache


class SharedPrefixTier:
    """Fleet-level content-addressed read-only page store (DESIGN.md §15).

    Keyed by the same rolling-digest chains ``chain_keys`` builds, so tier
    keying agrees bit-for-bit with admit-time planning and router probes.
    Values are host copies of FULL, immutable prompt pages — one
    ``(L, page, ...)`` array per cache plane — captured at registration
    time, right after prefill and before any decode write can land, so
    scattering a tier page into another replica's pool reproduces the
    exact bytes prefill would have written.  Partial tail pages (polluted
    beyond the prompt by decode, registered only at retirement) never
    enter the tier.

    LRU-bounded by ``capacity_bytes`` (None = unbounded).  Everything is
    a plain host dict mutated in the fleet's sorted-replica step order,
    so replays with a shared tier stay byte-identical and replica-order
    independent.

    Under tensor parallelism each rank's tier holds its in-page slice of
    every page, and counts the whole page's bytes (``put``'s
    ``shards``), so that ``bytes`` and the evictions they drive are the
    same on every rank and at every degree."""

    def __init__(self, capacity_bytes: int | None = None):
        self.capacity_bytes = capacity_bytes
        self.table: OrderedDict[bytes, dict] = OrderedDict()
        self.sizes: dict[bytes, int] = {}             # key -> counted bytes
        self.bytes = 0
        self.hits = 0            # pages materialized into a pool from here
        self.misses = 0          # chain walks stopped by a key held nowhere
        self.puts = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self.table)

    def __contains__(self, key) -> bool:
        return key in self.table

    def get(self, key):
        pages = self.table.get(key)
        if pages is not None:
            self.table.move_to_end(key)               # LRU touch
        return pages

    def put(self, key, pages: dict, shards: int = 1) -> None:
        """Hold ``pages`` under ``key``: one of ``shards`` in-page slices
        of the page, counted as the whole page."""
        if key in self.table:
            return
        self.table[key] = pages
        self.sizes[key] = shards * sum(int(a.nbytes) for a in pages.values())
        self.bytes += self.sizes[key]
        self.puts += 1
        if self.capacity_bytes is not None:
            while self.bytes > self.capacity_bytes and len(self.table) > 1:
                old, _ = self.table.popitem(last=False)
                self.bytes -= self.sizes.pop(old)
                self.evictions += 1

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "puts": self.puts, "evictions": self.evictions,
                "bytes": self.bytes, "entries": len(self.table)}


class PagePool:
    """Block-pool page allocator + content-addressed prefix cache.

    Refcount protocol: allocation gives the requesting slot one reference;
    registration in the prefix cache adds one held by the cache; each
    sharer adds one.  Retirement drops the request's references — pages
    reaching zero return to the free list, registered pages survive at
    refcount 1 (cache-only) and are the LRU *eviction* pool when the free
    list runs dry.
    """

    def __init__(self, model, *, n_pages: int, page_size: int,
                 pages_per_slot: int, kv_dtype=torch.bfloat16,
                 prefix_cache: bool = True, device=None, shards: int = 1):
        if n_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is the trash "
                             "page)")
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.pages_per_slot = int(pages_per_slot)
        self.prefix_enabled = bool(prefix_cache)
        self.device = resolve_device(device)
        self.shards = int(shards)
        # one rank's in-page slice of every page when shards > 1
        self.cache = model.init_paged_cache(n_pages, page_size, kv_dtype,
                                            self.device, tp=self.shards)
        self.free: list[int] = list(range(n_pages - 1, 0, -1))
        self.ref = np.zeros(n_pages, np.int64)
        self.table: OrderedDict[bytes, int] = OrderedDict()  # key -> pid
        self.key_of: dict[int, bytes] = {}                   # pid -> key
        # fleet-level shared prefix tier (attached by Fleet.add_replica;
        # None = per-replica caching only, the pre-§15 behavior)
        self.shared_tier: SharedPrefixTier | None = None
        self.stats = PoolStats()
        # pages released by truncate() but still owed to their in-flight
        # request's reservation: invisible to new admissions so extend()
        # back up to the reserve can never deadlock (DESIGN.md §9)
        self.reserved_extra = 0

    # --- capacity -------------------------------------------------------------

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1                       # minus the trash page

    def pages_in_use(self) -> int:
        return int((self.ref > 0).sum())

    def _evictable(self, exclude=()) -> int:
        """Cache-only pages reclaimable by eviction.  ``exclude``: pages an
        admission plan is about to share — taking a reference pins them, so
        they must not be counted as reclaimable supply for that same plan."""
        return sum(1 for pid in self.key_of
                   if self.ref[pid] == 1 and pid not in exclude)

    def can_admit(self, n_new: int, exclude=()) -> bool:
        return (len(self.free) + self._evictable(exclude)
                - self.reserved_extra >= n_new)

    def bytes_per_page(self) -> int:
        """Device bytes of a page (this rank's slice of it when the pool
        is one of ``shards`` > 1)."""
        return sum(int(a.nbytes) for a in self.cache.values()) // self.n_pages

    def bytes_total(self) -> int:
        return sum(int(a.nbytes) for a in self.cache.values())

    def bytes_in_use(self) -> int:
        return self.pages_in_use() * self.bytes_per_page()

    def utilization(self) -> float:
        return self.pages_in_use() / self.usable_pages

    def pages_needed(self, prompt_len: int, stop: int) -> int:
        """Worst-case pages for a request: prompt + stop generated tokens
        (K/V written up to position prompt_len + stop − 2; no mid-loop
        allocation, so the whole span is reserved at admission)."""
        last = max(prompt_len, prompt_len + stop - 1)
        return max(_ceil_div(prompt_len, self.page_size),
                   _ceil_div(last, self.page_size))

    def free_claimable(self) -> int:
        """Pages a new admission could claim right now: the free list plus
        cache-only evictables, minus the rollback pages still owed to
        in-flight reservations (DESIGN.md §11)."""
        return len(self.free) + self._evictable() - self.reserved_extra

    def pressure(self) -> float:
        """Fraction of usable capacity NOT claimable by a new admission —
        0.0 is an idle pool, 1.0 means admission is fully blocked until an
        in-flight request retires or is preempted."""
        return 1.0 - self.free_claimable() / self.usable_pages

    # --- allocator ------------------------------------------------------------

    def _note_usage(self):
        used = self.pages_in_use()
        if used > self.stats.peak_pages_in_use:
            self.stats.peak_pages_in_use = used
        top = int(self.ref.max()) if self.ref.size else 0
        if top > self.stats.peak_page_refs:
            self.stats.peak_page_refs = top

    def _alloc(self) -> int:
        if not self.free:
            self._evict_one()
        pid = self.free.pop()
        self.ref[pid] = 1
        return pid

    def _evict_one(self):
        for key, pid in self.table.items():           # LRU order: front first
            if self.ref[pid] == 1:                    # cache-only holder
                del self.table[key]
                del self.key_of[pid]
                self._release(pid)
                self.stats.evictions += 1
                return
        raise RuntimeError("page pool exhausted: every page is referenced "
                           "by an in-flight request")

    def _release(self, pid: int):
        self.ref[pid] -= 1
        assert self.ref[pid] >= 0, f"refcount underflow on page {pid}"
        if self.ref[pid] == 0:
            self.free.append(pid)

    # --- prefix cache ---------------------------------------------------------

    def _lookup(self, key):
        pid = self.table.get(key)
        if pid is not None:
            self.table.move_to_end(key)               # LRU touch
        return pid

    def prefix_match_pages(self, tokens) -> int:
        """How many leading prompt pages this pool already holds: full
        pages matched along the hash chain, plus the partial tail when
        every full page before it matched — the same count ``admit``
        would share.  Read-only: no LRU touch, no refcount change, so a
        router may probe every replica's pool without perturbing any
        pool's eviction order (serving/router.py)."""
        if not self.prefix_enabled:
            return 0
        keys, partial = chain_keys(tokens, self.page_size)
        matched = 0
        for key in keys:
            if key not in self.table:
                return matched
            matched += 1
        if partial is not None and partial in self.table:
            matched += 1
        return matched

    def _register(self, key, pid: int):
        if key in self.table or pid in self.key_of:
            return                                    # racer already cached it
        self.table[key] = pid
        self.key_of[pid] = key
        self.ref[pid] += 1
        self._note_usage()

    def _adopt_shared(self, keys) -> None:
        """Promote shared-tier pages this pool lacks (DESIGN.md §15).

        Walks the prompt's full-page chain in order; each key missing
        locally but held by the fleet's shared tier is materialized as a
        local cache-only page (alloc → scatter → register), so the
        planning pass right after finds an ordinary local hit.  The walk
        stops at the first key neither store holds — chain keying means no
        later page can hit either.  Each promotion is guarded by
        ``can_admit(1)``; a promoted page is cache-only (refcount 1) and
        immediately evictable, so a promotion outliving a failed admission
        costs nothing."""
        tier = self.shared_tier
        for key in keys:
            if key in self.table:
                continue
            pages = tier.get(key)
            if pages is None:
                tier.misses += 1
                return
            if not self.can_admit(1):
                return
            pid = self._alloc()
            self.cache = _write_page(self.cache, pid, pages)
            self._register(key, pid)
            self._release(pid)     # drop the alloc ref; the cache's keeps it
            tier.hits += 1
            self.stats.shared_hit_pages += 1

    # --- request lifecycle ----------------------------------------------------

    def admit(self, tokens: list[int], stop: int) -> Admission | None:
        """Plan + allocate one request's pages, or None when the pool cannot
        supply them yet (admission waits on free pages, not free slots).

        Demand accounting: sharing a page pins it (its reference makes it
        unevictable for this very plan), and a shared partial tail still
        costs one private page — the engine copies-on-write before decode.
        When the sharing plan is unaffordable, the request is re-planned
        without prefix hits (eviction may then reclaim the cache-only pages
        it would have shared) before admission is deferred."""
        page = self.page_size
        plen = len(tokens)
        n_chunks = _ceil_div(plen, page)
        needed = self.pages_needed(plen, stop)
        if needed > self.pages_per_slot or needed > self.usable_pages:
            raise ValueError(
                f"request needs {needed} pages (prompt {plen} + {stop} new, "
                f"page {page}) but the slot holds {self.pages_per_slot} and "
                f"the pool {self.usable_pages}")

        n_full = plen // page
        rem = plen % page
        keys, partial_key = chain_keys(tokens, page)
        if self.prefix_enabled and self.shared_tier is not None and n_full:
            self._adopt_shared(keys)

        for use_prefix in ((True, False) if self.prefix_enabled else
                           (False,)):
            matched, hit_pids, partial_pid = 0, [], None
            if use_prefix:
                for c in range(n_full):
                    pid = self._lookup(keys[c])
                    if pid is None:
                        break
                    hit_pids.append(pid)
                    matched += 1
                if rem and matched == n_full:
                    partial_pid = self._lookup(partial_key)
            n_shared = matched + (1 if partial_pid is not None else 0)
            # + 1: the CoW page the engine allocates for a shared tail
            demand = (needed - n_shared
                      + (1 if partial_pid is not None else 0))
            pinned = set(hit_pids)
            if partial_pid is not None:
                pinned.add(partial_pid)
            if self.can_admit(demand, exclude=pinned):
                break
        else:
            return None

        pids = []
        for c in range(needed):
            if c < matched:
                pid = hit_pids[c]
                self.ref[pid] += 1
            elif c == n_chunks - 1 and partial_pid is not None:
                pid = partial_pid
                self.ref[pid] += 1
            else:
                pid = self._alloc()
            pids.append(pid)
        self._note_usage()

        shared = set(range(matched))
        if partial_pid is not None:
            shared.add(n_chunks - 1)
        compute_from = min(matched, n_chunks - 1)
        write_pids = [0 if c in shared else pids[c]
                      for c in range(compute_from, n_chunks)]
        self.stats.hit_pages += len(shared)
        self.stats.miss_pages += n_chunks - len(shared)
        return Admission(
            pids=pids, n_chunks=n_chunks, compute_from=compute_from,
            write_pids=write_pids,
            full_keys=[(c, keys[c]) for c in range(n_full)],
            partial_key=partial_key,
            cow_tail=(n_chunks - 1) if partial_pid is not None else None,
            reserve=needed, n_live=needed)

    def register_prefill(self, adm: Admission):
        """Register the request's full prompt pages (immutable once written;
        concurrent requests may share them immediately).  With a shared
        tier attached, pages the tier lacks are published fleet-wide too —
        captured now, while still decode-untouched, so tier bytes are
        bit-exact by construction."""
        if not self.prefix_enabled:
            return
        for c, key in adm.full_keys:
            self._register(key, adm.pids[c])
        if self.shared_tier is not None:
            for c, key in adm.full_keys:
                if key not in self.shared_tier:
                    self.shared_tier.put(
                        key, {name: arr[:, adm.pids[c]].to("cpu", copy=True)
                              for name, arr in self.cache.items()},
                        self.shards)

    def cow(self, adm: Admission) -> int | None:
        """Copy-on-write the shared tail page before decode writes into it.

        Allocates a private page, copies the shared page's contents across
        all layers (in place), swaps it into the
        admission, and drops the request's reference on the shared page.
        Returns the logical index rewritten (for the engine's page table),
        or None when no CoW is due.  The shared page is never written.
        """
        if adm.cow_tail is None:
            return None
        c = adm.cow_tail
        old = adm.pids[c]
        new = self._alloc()
        self.cache = _copy_page(self.cache, old, new)
        self._release(old)
        adm.pids[c] = new
        adm.cow_tail = None
        self.stats.cow_copies += 1
        self._note_usage()
        return c

    # --- speculative rollback (DESIGN.md §9) ----------------------------------

    def truncate(self, adm: Admission, n_tokens: int) -> int:
        """Roll a request's live page span back to ``n_tokens`` tokens.

        Speculative rejection empties tail pages; they return to the free
        list immediately (the pool pays for tokens actually alive, not for
        speculation that lost) but stay **reserved** for this request
        (``reserved_extra``): new admissions cannot claim them, so a later
        ``extend`` back up to the admission-time worst case never
        deadlocks.  The new boundary page — the one future decode/verify
        writes will land in — is copy-on-write split first when it is
        shared (refcount > 1: a prefix-cache registration or a concurrent
        sharer), so rollback can never scribble over bytes another holder
        still reads; its prefix-cache entry keeps pointing at the untouched
        original, hash intact.  Returns the number of pages released.
        Callers must rebuild their page-table row afterwards (both the CoW
        swap and the freed tail change the physical mapping).
        """
        keep = _ceil_div(max(n_tokens, 0), self.page_size)
        if keep > adm.n_live:
            raise ValueError(
                f"truncate to {n_tokens} tokens needs {keep} pages but only "
                f"{adm.n_live} are live — extend() first")
        if keep and n_tokens % self.page_size:
            c = keep - 1                     # partially-filled boundary page
            pid = adm.pids[c]
            if self.ref[pid] > 1:
                new = self._alloc()
                self.cache = _copy_page(self.cache, pid, new)
                self._release(pid)
                adm.pids[c] = new
                self.stats.cow_copies += 1
        freed = adm.n_live - keep
        for c in range(keep, adm.n_live):
            self._release(adm.pids[c])
            adm.pids[c] = 0
        adm.n_live = keep
        self.reserved_extra += freed
        self.stats.truncated_pages += freed
        return freed

    def extend(self, adm: Admission, n_tokens: int) -> None:
        """Re-grow a request's live span to cover ``n_tokens`` tokens,
        drawing back from the pages ``truncate`` released.  Capped at the
        admission-time reservation: speculative overshoot beyond it routes
        to the trash page instead — no page need exist for a token that is
        guaranteed to be clamped away."""
        need = min(_ceil_div(max(n_tokens, 0), self.page_size), adm.reserve)
        if need <= adm.n_live:
            return
        for c in range(adm.n_live, need):
            adm.pids[c] = self._alloc()
        self.reserved_extra -= need - adm.n_live
        adm.n_live = need
        self._note_usage()

    # --- scheduler preemption (DESIGN.md §11) ---------------------------------

    def swap_out(self, adm: Admission) -> int:
        """Drop a preempted request's page references.  The engine must have
        copied the live pages' contents to the host FIRST — released pages
        can be re-allocated and overwritten immediately.

        Prefix-cache state is untouched: pages this request registered (or
        shared) survive at the cache's own refcount, hash chains intact, so
        concurrent and future requests keep hitting them while the victim
        is swapped out.  Unlike ``retire``, the partial tail page is NOT
        registered — the request is coming back and will keep writing into
        its private copy.  The request's standing reservation is dropped
        too (``reserved_extra``): a swapped request holds no claim on the
        pool until ``swap_in`` re-admits it.  Returns the number of page
        references released."""
        n = adm.n_live
        for pid in adm.pids[:adm.n_live]:
            self._release(pid)
        self.reserved_extra -= adm.reserve - adm.n_live
        adm.pids = []
        adm.n_live = adm.reserve = 0
        self.stats.swapped_out_pages += n
        return n

    def swap_in(self, reserve_pages: int) -> Admission | None:
        """Re-admit a swapped-out request: allocate its full reservation
        again as fresh private pages (no prefix lookup — the host blob the
        engine scatters back is authoritative, and writing restored bytes
        into a shared page would corrupt other readers), or return None
        when the pool cannot supply it yet.  ``reserve_pages`` never
        exceeds the original admission's reservation, so a request that
        was admitted once can always be restored once enough pages drain."""
        if reserve_pages > self.pages_per_slot \
                or reserve_pages > self.usable_pages:
            raise ValueError(
                f"swap-in needs {reserve_pages} pages but the slot holds "
                f"{self.pages_per_slot} and the pool {self.usable_pages}")
        if not self.can_admit(reserve_pages):
            return None
        pids = [self._alloc() for _ in range(reserve_pages)]
        self._note_usage()
        self.stats.swapped_in_pages += reserve_pages
        return Admission(pids=pids, n_chunks=0, compute_from=0,
                         write_pids=[], full_keys=[], partial_key=None,
                         cow_tail=None, reserve=reserve_pages,
                         n_live=reserve_pages)

    def retire(self, adm: Admission):
        """Drop the retired request's page references.  A non-aligned
        prompt's tail page is registered first (decode pollution beyond the
        prompt is fenced by readers' valid-length masks and replaced under
        copy-on-write by any future sharer)."""
        if (self.prefix_enabled and adm.partial_key is not None
                and adm.n_chunks <= adm.n_live):
            self._register(adm.partial_key, adm.pids[adm.n_chunks - 1])
        for pid in adm.pids[:adm.n_live]:
            self._release(pid)
        self.reserved_extra -= adm.reserve - adm.n_live
        adm.n_live = adm.reserve = 0

    def reset_stats(self):
        self.stats = PoolStats()
