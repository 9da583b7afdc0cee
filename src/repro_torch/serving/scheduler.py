"""Arrival-driven request scheduler over the step-level ``ServeEngine``
API (the port's copy of ``repro/serving/scheduler.py``).

Requests arrive (each with an arrival time, a priority class and optional
SLOs), wait in an admission queue, stream their tokens through per-request
callbacks and handles as they are sampled, and are preemptible: when the
head of the queue cannot be placed, the scheduler swaps a victim's K/V out
to a host ``SwapBlob`` (paged: its page references released, prefix-cache
entries kept; contiguous: its slot's cache rows) and restores it bit-exact
once capacity drains, so that a preempted and restored request's tokens
equal an uncontended run's.

**Virtual-clock rule**: nothing under ``serving/`` reads the wall clock.
Time is injected through the ``clock`` handle, and every scheduling
decision is a pure function of (trace, cost model, pool state), so a
traffic trace replays identically: the same admissions, preemptions and
streams.  A deployment injects a wall clock from outside ``serving/``.

Policy, deterministic by construction:

* **Admission** is strict head-of-line in (priority desc, arrival, seq)
  order: the head is placed when a slot is free and (paged) the pool can
  supply its worst-case page reservation.  A blocked head waits; nothing
  behind it overtakes it.
* **Preemption**: when the head cannot be placed, a running victim of
  strictly lower priority is swapped out (lowest priority first; among
  equals the most recently admitted) and queued again under its original
  key.  Equal priorities never preempt each other, so under a draining
  trace the head is eventually placed.
* **Decode** runs in lockstep rounds of ``quantum`` tokens a slot
  (``ServeEngine.serve_step``); the clock advances by the injected cost
  model after every prefill, round and swap.

Sampling draws from the engine's own generator (``ServeEngine.seed``),
so the scheduler takes no random key.  ``telemetry`` takes a registry of
``serving/telemetry.py`` (None = the null registry): the scheduler owns
the clock, so it binds the registry to it and attaches the engine.
"""

from __future__ import annotations

import dataclasses
import heapq

from repro_torch.serving.telemetry import NULL_TELEMETRY

__all__ = ["AsyncScheduler", "RequestHandle", "StepCosts", "VirtualClock",
           "QUEUED", "RUNNING", "SWAPPED", "FINISHED"]

QUEUED, RUNNING, SWAPPED, FINISHED = ("queued", "running", "swapped",
                                      "finished")


class VirtualClock:
    """Injected time: ``now()`` reads it, ``advance()`` moves it.  The
    only clock the serving layer knows — simulation IS the production
    code path, just with a different instance plugged in."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"time cannot run backwards (dt={dt})")
        self._t += dt


@dataclasses.dataclass(frozen=True)
class StepCosts:
    """Deterministic virtual-time cost model (seconds per unit) — what
    the clock advances on each scheduling action.  The values are
    arbitrary but FIXED: simulated TTFT/TPOT are comparable across runs
    and replay exactly.  A wall-clock deployment ignores this (its clock
    advances itself)."""

    prefill_token: float = 1e-3      # per prompt token at admission
    decode_step: float = 2e-2        # per lockstep round token
    swap_page: float = 2e-3          # per page moved by swap-out/swap-in


def _blob_bytes(blob) -> int:
    """Bytes of a SwapBlob's KV payload (``nbytes``: a tensor-parallel
    request's over all its ranks).  Telemetry-only (the simulation
    suite's stub engines swap structureless blobs, so the field is
    optional here)."""
    return int(getattr(blob, "nbytes", 0))


class RequestHandle:
    """One submitted request's live view: state, streamed tokens, and
    per-request metrics (TTFT/TPOT in injected-clock seconds)."""

    def __init__(self, sched, rid, prompt, max_new, *, priority, arrival,
                 slo_ttft, slo_tpot, on_token):
        self._sched = sched
        self.rid = rid
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.priority = int(priority)
        self.arrival = float(arrival)
        self.slo_ttft = slo_ttft
        self.slo_tpot = slo_tpot
        self.on_token = on_token
        self.state = QUEUED
        self.tokens: list[int] = []          # generated tokens, streamed
        self.admitted_at = None              # first admission
        self.first_token_at = None
        self.finished_at = None
        self.n_preempt = 0
        # data pages moved to the host blob by preemption (swap-OUT
        # direction; the canonical direction-suffixed spelling shared with
        # PoolStats.swapped_out_pages and the telemetry registry — note
        # the pool counts released page *references*, this counts *data*
        # pages, so the two differ by the unfilled reservation tail)
        self.pages_swapped_out = 0
        self.slot = None
        self._admit_seq = -1                 # recency key for victim choice

    @property
    def ttft(self):
        """Time to first token (None until one streams)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    @property
    def tpot(self):
        """Mean time per output token after the first (None until
        finished; 0.0 for single-token requests)."""
        if self.finished_at is None:
            return None
        if len(self.tokens) < 2:
            return 0.0
        return ((self.finished_at - self.first_token_at)
                / (len(self.tokens) - 1))

    def slo_met(self) -> bool:
        """True when every SLO this request set is met (vacuously true
        for a finished request that set none)."""
        if self.state != FINISHED:
            return False
        if self.slo_ttft is not None and self.ttft > self.slo_ttft:
            return False
        if self.slo_tpot is not None and self.tpot > self.slo_tpot:
            return False
        return True

    def result(self) -> list[int]:
        """prompt + generated tokens (valid once finished)."""
        if self.state != FINISHED:
            raise RuntimeError(f"request {self.rid} is {self.state}")
        return self.prompt + self.tokens

    def stream(self):
        """Yield this request's generated tokens as they are produced,
        driving the owning scheduler between yields until it finishes."""
        i = 0
        while True:
            while i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            if self.state == FINISHED:
                return
            if not self._sched.step():
                raise RuntimeError(
                    f"scheduler idle but request {self.rid} is {self.state}")


class AsyncScheduler:
    """Request-level scheduler owning one ``ServeEngine`` session.

    ``submit()`` registers requests (future arrivals are held until the
    clock reaches them — trace replay); ``step()`` runs one scheduling
    round; ``run_until_idle()`` drains everything.  All decisions are
    logged to ``events`` — the deterministic replay record the simulation
    suite compares run-to-run."""

    def __init__(self, engine, *, clock=None, costs=None, quantum: int = 1,
                 preempt: bool = True, telemetry=None):
        if engine.spec is not None:
            raise NotImplementedError(
                "the scheduler drives plain decode rounds; speculative "
                "serve() remains a batch mode")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.engine = engine
        self.clock = VirtualClock() if clock is None else clock
        self.costs = StepCosts() if costs is None else costs
        self.quantum = int(quantum)
        self.preempt_enabled = bool(preempt)
        self.st = engine.sched_state()
        self.slots: list[RequestHandle | None] = [None] * engine.max_batch
        self.pending: list[tuple] = []       # (arrival, rid) future heap
        self.ready: list[tuple] = []         # (-priority, arrival, rid)
        self.blobs: dict[int, object] = {}   # rid -> SwapBlob (preempted)
        self.handles: dict[int, RequestHandle] = {}
        self.events: list[tuple] = []        # (t, kind, rid) replay log
        self.n_preemptions = 0
        self.n_pages_swapped_out = 0         # data pages preemption moved
        self.n_pages_swapped_in = 0          # data pages restore moved back
        self._seq = 0
        self._admits = 0
        # the telemetry registry; None = the null registry.  The engine's
        # counters always point at THIS session's registry (or the null
        # one), so a re-used engine never reports into an old session's
        self.telemetry = NULL_TELEMETRY if telemetry is None else telemetry
        engine.telemetry = self.telemetry
        if self.telemetry.enabled:
            self.telemetry.bind_clock(self.clock)
            self.telemetry.attach_engine(engine)

    # --- submission ----------------------------------------------------------

    def submit(self, prompt, max_new: int, *, priority: int = 0,
               arrival: float | None = None, slo_ttft: float | None = None,
               slo_tpot: float | None = None, on_token=None,
               allow_past_arrival: bool = False) -> RequestHandle:
        """Register one request.  ``arrival`` defaults to now; a future
        arrival is held back until the clock reaches it.  Raises
        immediately for a request that could never fit the engine.

        ``allow_past_arrival`` is the fleet-router path
        (``serving/fleet.py``): a router that routes a request the moment
        the clock reaches its arrival may hand it over slightly AFTER that
        instant (a replica's decode round advanced the shared clock
        first), and the handle must keep the ORIGINAL arrival so TTFT
        spans the routing delay.  A past
        arrival is harvested on the next round; for direct users it stays
        an error."""
        self.engine.sched_check(prompt, max_new)
        t = self.clock.now() if arrival is None else float(arrival)
        if t < self.clock.now() and not allow_past_arrival:
            raise ValueError(
                f"arrival {t} is in the past (now={self.clock.now()})")
        h = RequestHandle(self, self._seq, prompt, max_new,
                          priority=priority, arrival=t, slo_ttft=slo_ttft,
                          slo_tpot=slo_tpot, on_token=on_token)
        self._seq += 1
        self.handles[h.rid] = h
        heapq.heappush(self.pending, (t, h.rid))
        self._log("submit", h.rid)
        if self.telemetry.enabled:
            self.telemetry.count("sched.submitted")
            self.telemetry.instant("requests", h.rid, "submit")
        return h

    # --- internals -----------------------------------------------------------

    def _log(self, kind: str, rid: int) -> None:
        self.events.append((round(self.clock.now(), 9), kind, rid))

    def _harvest(self) -> None:
        now = self.clock.now()
        while self.pending and self.pending[0][0] <= now:
            _, rid = heapq.heappop(self.pending)
            h = self.handles[rid]
            heapq.heappush(self.ready, (-h.priority, h.arrival, rid))
            self._log("arrive", rid)
            if self.telemetry.enabled:
                self.telemetry.count("sched.arrivals")
                self.telemetry.instant("requests", rid, "arrive")
                self.telemetry.open_span("requests", rid, "queued")

    def next_arrival(self) -> float | None:
        return self.pending[0][0] if self.pending else None

    @property
    def running(self) -> list[RequestHandle]:
        return [h for h in self.slots if h is not None]

    def _free_slot(self) -> int | None:
        for b, h in enumerate(self.slots):
            if h is None:
                return b
        return None

    def _emit(self, h: RequestHandle, ts) -> None:
        now = self.clock.now()
        for t in ts:
            if h.first_token_at is None:
                h.first_token_at = now
            h.tokens.append(int(t))
            if h.on_token is not None:
                h.on_token(h, int(t), now)

    def _finish(self, slot: int) -> None:
        h = self.slots[slot]
        self.engine.sched_release(self.st, slot)
        self.slots[slot] = None
        h.slot = None
        h.state = FINISHED
        h.finished_at = self.clock.now()
        self._log("finish", h.rid)
        tel = self.telemetry
        if tel.enabled:
            tel.count("sched.finished")
            tel.close_span("requests", h.rid, "running")
            tel.instant("requests", h.rid, "finish")
            if h.slo_ttft is not None or h.slo_tpot is not None:
                tel.count("sched.slo_hits" if h.slo_met()
                          else "sched.slo_misses")

    # --- placement + preemption ----------------------------------------------

    def _place(self, h: RequestHandle, slot: int) -> bool:
        """Admit (fresh) or swap in (preempted) ``h`` into ``slot``."""
        eng = self.engine
        tel = self.telemetry
        if h.rid in self.blobs:
            blob = self.blobs[h.rid]
            t0 = self.clock.now()
            if not eng.sched_swap_in(self.st, slot, blob):
                return False
            del self.blobs[h.rid]
            self.clock.advance(self.costs.swap_page * blob.n_pages)
            self.n_pages_swapped_in += blob.n_pages
            self._log("resume", h.rid)
            if tel.enabled:
                tel.count("sched.resumes")
                tel.count("sched.pages_swapped_in", blob.n_pages)
                tel.count("sched.swap_bytes_in", _blob_bytes(blob))
                tel.span("slots", slot, "swap_in", t0, self.clock.now())
                tel.close_span("requests", h.rid, "swapped")
                tel.open_span("requests", h.rid, "running")
                tel.instant("requests", h.rid, "resume")
        else:
            t0 = self.clock.now()
            first = eng.sched_admit(self.st, slot, h.prompt, h.max_new)
            if first is None:
                return False
            self.clock.advance(self.costs.prefill_token * len(h.prompt))
            if h.admitted_at is None:
                h.admitted_at = self.clock.now()
            self._log("admit", h.rid)
            if tel.enabled:
                tel.count("sched.admissions")
                tel.span("slots", slot, "prefill", t0, self.clock.now())
                tel.close_span("requests", h.rid, "queued")
                tel.open_span("requests", h.rid, "running")
                tel.instant("requests", h.rid, "admit")
            self._emit(h, [first])           # prefill samples token #1
        h.state = RUNNING
        h.slot = slot
        h._admit_seq = self._admits
        self._admits += 1
        self.slots[slot] = h
        if len(h.tokens) >= h.max_new:       # max_new=1: done on arrival
            self._finish(slot)
        return True

    def _reclaim_reaches(self, h: RequestHandle) -> bool:
        """Upper-bound check before paged preemption: could evicting
        EVERY strictly-lower-priority victim possibly cover ``h``'s page
        reservation?  If not, swapping victims out is futile — the head
        waits instead of paying swap costs for nothing.  (Worst-case
        demand: prefix-cache hits can only lower it.)"""
        pool = self.engine.pool
        need = (self.blobs[h.rid].reserve if h.rid in self.blobs
                else pool.pages_needed(len(h.prompt), h.max_new))
        avail = pool.free_claimable() + sum(
            self.st.adm[v.slot].n_live for v in self.running
            if v.priority < h.priority)
        return avail >= need

    def _pick_victim(self, below_priority: int) -> RequestHandle | None:
        """Lowest-priority, most-recently-admitted running request
        strictly below ``below_priority`` — LIFO among equals preserves
        the oldest requests' progress."""
        cands = [h for h in self.running if h.priority < below_priority]
        if not cands:
            return None
        return min(cands, key=lambda h: (h.priority, -h._admit_seq))

    def _preempt(self, victim: RequestHandle) -> None:
        slot, t0 = victim.slot, self.clock.now()
        blob = self.engine.sched_swap_out(self.st, slot)
        self.clock.advance(self.costs.swap_page * blob.n_pages)
        self.blobs[victim.rid] = blob
        self.slots[slot] = None
        victim.slot = None
        victim.state = SWAPPED
        victim.n_preempt += 1
        victim.pages_swapped_out += blob.n_pages
        self.n_preemptions += 1
        self.n_pages_swapped_out += blob.n_pages
        heapq.heappush(self.ready,
                       (-victim.priority, victim.arrival, victim.rid))
        self._log("preempt", victim.rid)
        tel = self.telemetry
        if tel.enabled:
            tel.count("sched.preemptions")
            tel.count("sched.pages_swapped_out", blob.n_pages)
            tel.count("sched.swap_bytes_out", _blob_bytes(blob))
            tel.span("slots", slot, "swap_out", t0, self.clock.now())
            tel.close_span("requests", victim.rid, "running")
            tel.open_span("requests", victim.rid, "swapped")
            tel.instant("requests", victim.rid, "preempt")

    # --- cross-scheduler migration (DESIGN.md §15) ----------------------------

    def expel(self, rid: int):
        """Remove an unfinished request so a fleet can migrate it to a
        survivor replica at drain time.  Returns ``(handle, blob)``:

        * RUNNING — swapped out first (the same bit-exact blob path as
          preemption, billed at the same per-page cost), blob returned;
        * SWAPPED — hands over the blob it already has;
        * QUEUED — leaves empty-handed (``blob=None``; nothing placed yet,
          the target just admits it fresh).

        The handle keeps its identity — original arrival/priority (it
        re-queues on the target under its ORIGINAL key), streamed tokens,
        TTFT — and is re-homed with ``adopt``.  Not counted as a
        preemption: ``sched.pages_swapped_out`` and the handle's page
        counter do grow (data really moved), ``n_preemptions`` does not."""
        h = self.handles.pop(rid)
        if h.state == FINISHED:
            raise ValueError(f"request {rid} already finished")
        tel = self.telemetry
        blob = None
        if h.state == RUNNING:
            slot, t0 = h.slot, self.clock.now()
            blob = self.engine.sched_swap_out(self.st, slot)
            self.clock.advance(self.costs.swap_page * blob.n_pages)
            self.slots[slot] = None
            h.slot = None
            h.state = SWAPPED
            h.pages_swapped_out += blob.n_pages
            self.n_pages_swapped_out += blob.n_pages
            if tel.enabled:
                tel.count("sched.pages_swapped_out", blob.n_pages)
                tel.count("sched.swap_bytes_out", _blob_bytes(blob))
                tel.span("slots", slot, "swap_out", t0, self.clock.now())
                tel.close_span("requests", rid, "running")
        else:
            if h.state == SWAPPED:
                blob = self.blobs.pop(rid)
            # QUEUED and SWAPPED both sit in a queue heap — purge the rid
            # (SWAPPED was re-queued by _preempt under its original key)
            self.ready = [e for e in self.ready if e[2] != rid]
            heapq.heapify(self.ready)
            self.pending = [e for e in self.pending if e[1] != rid]
            heapq.heapify(self.pending)
            if tel.enabled:
                tel.close_span("requests", rid,
                               "swapped" if h.state == SWAPPED else "queued")
        self._log("expel", rid)
        if tel.enabled:
            tel.count("sched.expelled")
            tel.instant("requests", rid, "expel")
        return h, blob

    def adopt(self, h: RequestHandle, blob=None) -> RequestHandle:
        """Re-home an expelled request here (the other half of ``expel``).
        The handle gains a fresh local rid and queues under its original
        (priority, arrival) key; with a blob its next placement takes the
        bit-exact ``sched_swap_in`` path instead of a fresh prefill, so
        the remaining tokens are byte-identical to never having moved."""
        self.engine.sched_check(h.prompt, h.max_new)
        h._sched = self
        h.rid = self._seq
        self._seq += 1
        h.slot = None
        self.handles[h.rid] = h
        if blob is not None:
            h.state = SWAPPED
            self.blobs[h.rid] = blob
        else:
            h.state = QUEUED
        heapq.heappush(self.ready, (-h.priority, h.arrival, h.rid))
        self._log("adopt", h.rid)
        tel = self.telemetry
        if tel.enabled:
            tel.count("sched.adopted")
            tel.instant("requests", h.rid, "adopt")
            tel.open_span("requests", h.rid,
                          "swapped" if blob is not None else "queued")
        return h

    def _admit_ready(self) -> int:
        """Place queue heads until one blocks (strict head-of-line).
        A blocked head may preempt strictly-lower-priority victims, one
        at a time, until it fits or no victims remain."""
        placed = 0
        while self.ready:
            _, _, rid = self.ready[0]
            h = self.handles[rid]
            while True:
                slot = self._free_slot()
                if slot is not None and self._place(h, slot):
                    heapq.heappop(self.ready)
                    placed += 1
                    break
                victim = (self._pick_victim(h.priority)
                          if self.preempt_enabled else None)
                if victim is None:
                    return placed            # head-of-line wait
                if (slot is not None and self.engine.paged
                        and not self._reclaim_reaches(h)):
                    return placed            # pages blocked; eviction
                self._preempt(victim)        # can't reach — don't thrash
        return placed

    # --- the loop ------------------------------------------------------------

    def step(self, more_arrivals: bool = False) -> bool:
        """One scheduling round: harvest arrivals, admit (preempting if
        needed), decode one quantum, stream new tokens, harvest
        finishers.  Returns False once fully idle (nothing pending,
        queued, or in flight).

        ``more_arrivals``: the caller (a fleet, ``serving/fleet.py``) still
        has traffic or clock advances to inject from OUTSIDE this
        scheduler.  A round that makes no progress with a non-empty
        queue then returns False instead of raising — a higher-priority
        arrival may yet become the head and unblock placement — and the
        caller owns starvation detection once its traffic runs out."""
        tel = self.telemetry
        t_round0 = self.clock.now()
        self._harvest()
        placed = self._admit_ready()
        if tel.enabled:
            tel.observe("sched.queue_depth", len(self.ready))
            # counter-track samples (Perfetto "C" events): the load curves
            # beside the lifecycle spans, stamped by the virtual clock
            tel.counter("sched.queue_depth", len(self.ready))
            if getattr(self.engine, "paged", False):
                tel.counter("pool.pressure", self.engine.pool.pressure())
        t_dec0 = self.clock.now()
        toks, done = self.engine.serve_step(self.st, self.quantum)
        if toks:
            # a round is as long as its longest slot actually decoded —
            # slots can retire mid-quantum, and billing the full quantum
            # would inflate TPOT/makespan deterministically
            self.clock.advance(self.costs.decode_step
                               * max(len(t) for t in toks.values()))
            if tel.enabled:
                for slot in sorted(toks):
                    tel.span("slots", slot, "decode", t_dec0,
                             self.clock.now())
                tel.counter("engine.batch_occupancy", len(toks))
                if getattr(self.engine, "probes", False):
                    # §14 numerics as counter tracks — small (L,) device
                    # reads per round, sampled only when telemetry is on
                    num = self.engine.numerics()
                    if num.get("sat_rate"):
                        tel.counter("numerics.sat_rate_max",
                                    max(num["sat_rate"]))
                    if num.get("headroom_bits"):
                        tel.counter("numerics.headroom_bits_min",
                                    min(num["headroom_bits"]))
                    if num.get("kv_err_max"):
                        tel.counter("numerics.kv_err_max",
                                    max(num["kv_err_max"]))
            for slot in sorted(toks):
                self._emit(self.slots[slot], toks[slot])
        for slot in done:
            self._finish(slot)
        if placed or toks or done:
            if tel.enabled:
                tel.count("sched.rounds")
                tel.span("sched", 0, "round", t_round0, self.clock.now())
            return True
        nxt = self.next_arrival()
        if nxt is not None:                  # idle-jump to the next event
            self.clock.advance(nxt - self.clock.now())
            if tel.enabled:
                tel.instant("sched", 0, "idle_jump")
            return True
        if not (self.ready or self.running):
            return False
        if more_arrivals:
            return False                     # the caller has more to inject
        raise RuntimeError(
            "scheduler stalled: admission blocked with no request in "
            "flight and no future arrivals")

    def run_until_idle(self, max_rounds: int = 1_000_000) -> None:
        """Drive rounds until every submitted request has finished."""
        for _ in range(max_rounds):
            if not self.step():
                return
        raise RuntimeError(f"not idle after {max_rounds} rounds — "
                           "starvation or a stuck request")

    # --- introspection (the deterministic replay record) ---------------------

    @property
    def admission_order(self) -> list[int]:
        return [rid for _, kind, rid in self.events if kind == "admit"]

    @property
    def preemption_log(self) -> list[tuple]:
        return [(t, rid) for t, kind, rid in self.events
                if kind == "preempt"]
