"""Multi-replica fleet serving under one virtual clock (the port's copy of
``repro/serving/fleet.py``).

``Fleet`` runs N independent ``ServeEngine`` replicas, each with its own
``PagePool`` and ``AsyncScheduler``, behind a ``FleetRouter``
(``serving/router.py``) and ONE injected clock.  Requests are routed at
their arrival instant (prefix affinity scores the pools' live state),
replicas are stepped in sorted-id lockstep, and the result is the same
``ServerReport`` the single server gives.

Determinism: the same trace gives the same merged event log, per-request
streams and report, across runs and across replica *iteration order*:
every loop over replicas walks sorted ids, routing ties fall to the
smallest id, and the merged log's tie-break is (time, staged before
scheduler, replica id).  ``fleet(N=1)`` reduces exactly to
``Server.replay``.

Scale: ``replay()`` takes a streamed trace (a generator with
non-decreasing arrivals, ``poisson_trace_iter``) with one row of
lookahead, and ``retain=False`` drops finished handles and folds the event
log into a running SHA-256 digest, so a long trace runs in bounded memory.

Swap accounting: the report sums the schedulers' ``n_pages_swapped_out``
/ ``_in`` (*data* pages moved through host blobs) over replicas, never the
pools' ``swapped_out_pages`` (page *references* released).

Drain (``drain`` / ``schedule_drain``) stops routing to a replica; its
queued and running requests finish in place.  With
``migrate_on_drain=True`` the fleet instead expels every unfinished
request at drain time (running ones swap out to host blobs,
``AsyncScheduler.expel``: on the card one ``page_gather`` launch each) and
queues them again, so the next routing pass adopts them on survivors
(``AsyncScheduler.adopt``, which writes the blob into the survivor's pool
in place) and their streams continue as if never moved.  Scale-up
(``add_replica`` / ``schedule_scale``) makes a replica routable the
instant it joins.

When every replica is draining, due arrivals are deferred and route the
moment a scale-up lands; a fleet that can never deliver them raises.
``shed_policy``/``shed_threshold`` add admission backpressure
(``FleetRouter.decide``): shed requests are staged as ``shed`` events,
counted in ``ServerReport.n_shed`` and listed in ``Fleet.shed_rids``.

``shared_prefix_tier=True`` (or a ``SharedPrefixTier``) hangs one
fleet-level content-addressed page store under every paged replica's
pool: a local prefix miss consults the tier and scatters the host page
into the pool before recomputing it.

Per-replica telemetry goes to the shared registry through
``Telemetry.scoped`` (``r0.pool``, ``r1.sched.*``, per-replica Perfetto
tracks), beside the fleet's own ``fleet.*`` counters and the
``prefix_tier`` section.

Sampling draws from each engine's own generator (``ServeEngine.seed``),
so the fleet takes no random key.

Tensor-parallel replicas (``ServeEngine(mesh=)``) run on every rank of
their mesh, each rank this same fleet on the same trace: the host side
(routing on ``ReplicaProbe``'s page and slot counts, drains,
migrations, the tier's keys and whole-page bytes) is identical on every
rank, so a
migrated request's blob, a rank's slice on each rank, lands on the same
survivor everywhere.
"""

from __future__ import annotations

import hashlib
import heapq
import json

import numpy as np

from repro_torch.serving.kvcache import SharedPrefixTier
from repro_torch.serving.router import FleetRouter
from repro_torch.serving.scheduler import (FINISHED, AsyncScheduler,
                                           VirtualClock)
from repro_torch.serving.server import ServerReport
from repro_torch.serving.telemetry import NULL_TELEMETRY

__all__ = ["Fleet", "ReplicaProbe"]


class ReplicaProbe:
    """Router-facing view of one live replica (the probe protocol
    ``FleetRouter`` scores): unfinished load, claimable capacity,
    admission pressure, and the pool's prefix-chain match length.
    Read-only by construction."""

    def __init__(self, fleet: "Fleet", rep: str):
        self._fleet = fleet
        self.rep = rep

    def load(self) -> int:
        return self._fleet.inflight[self.rep]

    def free_pages(self) -> int:
        sched = self._fleet.replicas[self.rep]
        if getattr(sched.engine, "paged", False):
            return sched.engine.pool.free_claimable()
        return sum(1 for h in sched.slots if h is None)

    def pressure(self) -> float:
        """0.0 idle → 1.0 admission blocked: the pool's own pressure
        signal for paged replicas, busy-slot fraction otherwise — the
        quantity the router's shed gate thresholds."""
        sched = self._fleet.replicas[self.rep]
        if getattr(sched.engine, "paged", False):
            return sched.engine.pool.pressure()
        n = len(sched.slots)
        return (sum(1 for h in sched.slots if h is not None) / n
                if n else 1.0)

    def prefix_match_pages(self, tokens) -> int:
        sched = self._fleet.replicas[self.rep]
        if getattr(sched.engine, "paged", False):
            return sched.engine.pool.prefix_match_pages(tokens)
        return 0


class Fleet:
    """N replicas, one router, one clock — the fleet-shaped ``Server``.

    ``engines``: a list (ids ``r0..rN-1``) or an id→engine dict.  Every
    replica shares the fleet's clock/costs/quantum; each samples from its
    own engine's generator.  ``retain=False`` is
    the large-trace mode: finished handles are released and the merged
    event log lives only in ``event_digest()``.

    ``migrate_on_drain``: expel a draining replica's unfinished requests
    and re-route them to survivors (default False — drained replicas
    finish in place).  ``shared_prefix_tier``: True
    for a fresh fleet-level ``SharedPrefixTier``, or an existing tier
    instance to share beyond this fleet.  ``shed_policy`` /
    ``shed_threshold``: router admission backpressure (serving/router.py
    ``decide``)."""

    def __init__(self, engines, *, clock=None, costs=None, quantum: int = 1,
                 preempt: bool = True, telemetry=None,
                 policy: str = "prefix", retain: bool = True,
                 migrate_on_drain: bool = False, shared_prefix_tier=None,
                 shed_policy: str = "none", shed_threshold: float = 0.95):
        self.clock = VirtualClock() if clock is None else clock
        self.costs = costs
        self.quantum = int(quantum)
        self.preempt = bool(preempt)
        self.retain = bool(retain)
        self.migrate_on_drain = bool(migrate_on_drain)
        if shared_prefix_tier is True:
            self.tier = SharedPrefixTier()
        elif shared_prefix_tier is None or shared_prefix_tier is False:
            self.tier = None
        else:
            self.tier = shared_prefix_tier
        self.telemetry = NULL_TELEMETRY if telemetry is None else telemetry
        if self.telemetry.enabled:
            self.telemetry.bind_clock(self.clock)
            if self.tier is not None:
                self.telemetry.add_provider("prefix_tier", self.tier.stats)
        self.router = FleetRouter(policy=policy, shed_policy=shed_policy,
                                  shed_threshold=shed_threshold)
        self.replicas: dict[str, AsyncScheduler] = {}
        self.inflight: dict[str, int] = {}     # unfinished routed requests
        self.n_routed_to: dict[str, int] = {}
        self.migrated_from: dict[str, int] = {}
        self.handles: dict[int, object] = {}   # frid -> handle (retain mode)
        self.assigned: dict[int, tuple] = {}   # frid -> (rep, local rid)
        self._local2fleet: dict[str, dict] = {}
        self._rows: dict[int, dict] = {}       # frid -> row (until routed)
        self.pending: list[tuple] = []         # (arrival, frid) heap
        self._controls: list[tuple] = []       # (t, seq, kind, payload) heap
        self.n_migrated = 0                    # requests expelled at drain
        self.n_migrated_pages = 0              # blob data pages they carried
        self.n_shed = 0
        self.n_deferred = 0                    # arrivals deferred >= once
        self.shed_rids: list[int] = []
        self._deferred: set[int] = set()       # frids staged as deferred
        self._tier_sampled = None              # last (hits, bytes) sampled
        self._cseq = 0
        self._seq = 0
        self._staged: list[tuple] = []         # fleet events awaiting merge
        self.events: list[tuple] = []          # merged (t, rep, kind, frid)
        self._digest = hashlib.sha256()
        self._trace = None                     # streamed-replay iterator
        self._thead = None                     # its one-row lookahead
        self._agg = {"n": 0, "tokens": 0, "first_arrival": None,
                     "last_finish": None, "ttft": [], "tpot": [],
                     "slo_hit": 0, "slo_total": 0}
        items = (dict(engines) if isinstance(engines, dict)
                 else {f"r{i}": e for i, e in enumerate(engines)})
        for rep in sorted(items):            # canonical join order: a fleet
            self.add_replica(rep, items[rep])  # is a set, not a sequence
        if not self.replicas:
            raise ValueError("a fleet needs at least one replica")

    # --- membership ----------------------------------------------------------

    def add_replica(self, rep: str, engine) -> None:
        """Scale-up: build the replica's scheduler on the shared clock
        and make it routable immediately."""
        rep = str(rep)
        tel = self.telemetry
        sched = AsyncScheduler(
            engine, clock=self.clock, costs=self.costs,
            quantum=self.quantum, preempt=self.preempt,
            telemetry=tel.scoped(rep) if tel.enabled else None)
        self.replicas[rep] = sched
        self.inflight[rep] = 0
        self.n_routed_to[rep] = 0
        self.migrated_from[rep] = 0
        self._local2fleet[rep] = {}
        if self.tier is not None and getattr(engine, "paged", False):
            engine.pool.shared_tier = self.tier
        self.router.add(rep, ReplicaProbe(self, rep))
        self._stage("join", rep, -1)
        if tel.enabled:
            tel.count("fleet.replicas")
            tel.instant("fleet", 0, f"join:{rep}")

    def drain(self, rep: str) -> None:
        """Stop routing to ``rep``.  Default: it finishes its own queue
        in place.  With ``migrate_on_drain`` its unfinished requests are
        expelled (running ones as bit-exact swap blobs) and re-enqueued
        fleet-pending, so the next routing pass re-homes them on
        survivors — or defers them until a survivor exists."""
        self.router.drain(rep)
        self._stage("drain", rep, -1)
        if self.telemetry.enabled:
            self.telemetry.count("fleet.drains")
            self.telemetry.instant("fleet", 0, f"drain:{rep}")
        if self.migrate_on_drain:
            self._migrate_from(rep)

    def _migrate_from(self, rep: str) -> None:
        """Expel every unfinished request on ``rep`` (sorted fleet-id
        order — deterministic and replica-order independent) and push it
        back into the fleet's pending heap under its ORIGINAL arrival,
        carrying its live handle and, for started requests, the swap
        blob ``adopt`` will restore bit-exactly on the target."""
        sched = self.replicas[rep]
        tel = self.telemetry
        moved = sorted(
            (frid, lrid) for lrid, frid in self._local2fleet[rep].items()
            if lrid in sched.handles
            and sched.handles[lrid].state != FINISHED)
        for frid, lrid in moved:
            h, blob = sched.expel(lrid)
            self.inflight[rep] -= 1
            del self.assigned[frid]
            self._rows[frid] = {
                "arrival": h.arrival, "prompt": h.prompt,
                "max_new": h.max_new, "priority": h.priority,
                "slo_ttft": h.slo_ttft, "slo_tpot": h.slo_tpot,
                "handle": h, "blob": blob}
            heapq.heappush(self.pending, (h.arrival, frid))
            self.n_migrated += 1
            self.migrated_from[rep] += 1
            n_pg = blob.n_pages if blob is not None else 0
            self.n_migrated_pages += n_pg
            self._stage("migrate", rep, frid)
            if tel.enabled:
                tel.count("fleet.migrated")
                if n_pg:
                    tel.count("fleet.migrated_pages", n_pg)
                tel.instant("fleet", 0, f"migrate:{rep}")
        if moved and tel.enabled:
            tel.counter("fleet.migrated_pages", self.n_migrated_pages)

    def schedule_drain(self, t: float, rep: str) -> None:
        """Drain ``rep`` once the virtual clock reaches ``t``."""
        heapq.heappush(self._controls, (float(t), self._cseq, "drain", rep))
        self._cseq += 1

    def schedule_scale(self, t: float, rep: str, engine) -> None:
        """Add replica ``rep`` once the clock reaches ``t``.  ``engine``
        may be an engine or a zero-argument factory (deferring device
        allocation to join time)."""
        heapq.heappush(self._controls,
                       (float(t), self._cseq, "scale", (str(rep), engine)))
        self._cseq += 1

    # --- submission ----------------------------------------------------------

    def submit(self, prompt, max_new: int, *, priority: int = 0,
               arrival: float | None = None, slo_ttft: float | None = None,
               slo_tpot: float | None = None) -> int:
        """Register one request with the fleet; returns its fleet-wide
        request id.  Routing happens when the clock reaches the arrival
        (prefix affinity must see the pools as they are THEN)."""
        t = self.clock.now() if arrival is None else float(arrival)
        if t < self.clock.now():
            raise ValueError(
                f"arrival {t} is in the past (now={self.clock.now()})")
        return self._enqueue({
            "arrival": t, "prompt": list(prompt), "max_new": int(max_new),
            "priority": int(priority), "slo_ttft": slo_ttft,
            "slo_tpot": slo_tpot})

    def _enqueue(self, row: dict) -> int:
        frid = self._seq
        self._seq += 1
        self._rows[frid] = row
        heapq.heappush(self.pending, (row["arrival"], frid))
        a = self._agg
        if a["first_arrival"] is None or row["arrival"] < a["first_arrival"]:
            a["first_arrival"] = row["arrival"]
        if self.telemetry.enabled:
            self.telemetry.count("fleet.submitted")
        return frid

    # --- internals -----------------------------------------------------------

    def _stage(self, kind: str, rep: str, frid: int) -> None:
        self._staged.append((round(self.clock.now(), 9), rep, kind, frid))

    def _apply_controls(self) -> None:
        now = self.clock.now()
        while self._controls and self._controls[0][0] <= now:
            _, _, kind, payload = heapq.heappop(self._controls)
            if kind == "drain":
                self.drain(payload)
            else:
                rep, eng = payload
                self.add_replica(rep, eng() if callable(eng) else eng)

    def _pull_trace(self) -> None:
        if self._thead is None:
            return
        now = self.clock.now()
        while self._thead is not None and self._thead["arrival"] <= now:
            r = self._thead
            self._enqueue({
                "arrival": float(r["arrival"]), "prompt": r["prompt"],
                "max_new": r["max_new"],
                "priority": r.get("priority", 0),
                "slo_ttft": r.get("slo_ttft"),
                "slo_tpot": r.get("slo_tpot")})
            self._thead = next(self._trace, None)
            if (self._thead is not None
                    and self._thead["arrival"] < r["arrival"]):
                raise ValueError("streamed trace arrivals must be "
                                 "non-decreasing")

    def _route_due(self) -> bool:
        """Route due arrivals through the router's admission decision.
        A deferred head stays in ``pending`` (head-of-line, original
        order) and is retried next round — this is what lets a mid-trace
        arrival survive an all-drained window until a scale-up lands,
        and what backpressure's "defer" class waits on.  Returns True
        when anything was routed or shed (the round made progress)."""
        now = self.clock.now()
        tel = self.telemetry
        acted = False
        while self.pending and self.pending[0][0] <= now:
            _, frid = self.pending[0]
            row = self._rows[frid]
            kind, rep = self.router.decide(
                row["prompt"],
                has_slo=(row["slo_ttft"] is not None
                         or row["slo_tpot"] is not None))
            if kind == "defer":
                if frid not in self._deferred:   # stage + count ONCE
                    self._deferred.add(frid)
                    self.n_deferred += 1
                    self._stage("defer", "-", frid)
                    if tel.enabled:
                        tel.count("fleet.deferred")
                        tel.instant("fleet", 0, "defer")
                break
            heapq.heappop(self.pending)
            self._deferred.discard(frid)
            if kind == "shed":
                self._rows.pop(frid)
                self.n_shed += 1
                self.shed_rids.append(frid)
                self._stage("shed", "-", frid)
                if tel.enabled:
                    tel.count("fleet.shed")
                    tel.counter("fleet.shed", self.n_shed)
                    tel.instant("fleet", 0, "shed")
                acted = True
                continue
            self._route(frid, rep)
            acted = True
        return acted

    def _route(self, frid: int, rep: str) -> None:
        row = self._rows.pop(frid)
        sched = self.replicas[rep]
        h = row.get("handle")
        if h is not None:              # drain-time migration handover
            h = sched.adopt(h, blob=row.get("blob"))
        else:
            h = sched.submit(row["prompt"], row["max_new"],
                             priority=row["priority"],
                             arrival=row["arrival"],
                             slo_ttft=row["slo_ttft"],
                             slo_tpot=row["slo_tpot"],
                             allow_past_arrival=True)
        self._local2fleet[rep][h.rid] = frid
        self.assigned[frid] = (rep, h.rid)
        self.inflight[rep] += 1
        self.n_routed_to[rep] += 1
        if self.retain:
            self.handles[frid] = h
        self._stage("route", rep, frid)
        if self.telemetry.enabled:
            self.telemetry.count("fleet.routed")
            self.telemetry.instant("fleet", 0, f"route:{rep}")

    def _drain_events(self) -> None:
        """Merge this round's staged fleet events and every replica's
        scheduler events into the fleet log: stable-sorted by time (the
        only cross-replica ordering that exists), staged-first then
        sorted-replica order among equal times.  The merged rows feed
        the running digest; ``retain`` decides whether they are kept."""
        batch = self._staged
        self._staged = []
        for rep in sorted(self.replicas):
            sched = self.replicas[rep]
            if not sched.events:
                continue
            local = self._local2fleet[rep]
            batch.extend((t, rep, kind, local[rid])
                         for t, kind, rid in sched.events)
            sched.events.clear()
        if not batch:
            return
        batch.sort(key=lambda ev: ev[0])
        for ev in batch:
            self._digest.update(
                json.dumps(list(ev), separators=(",", ":")).encode())
            self._digest.update(b"\n")
            if ev[2] == "finish":
                self._on_finish(ev[1], ev[3])
        if self.retain:
            self.events.extend(batch)

    def _on_finish(self, rep: str, frid: int) -> None:
        sched = self.replicas[rep]
        _, lrid = self.assigned[frid]
        h = sched.handles[lrid]
        a = self._agg
        a["n"] += 1
        a["tokens"] += len(h.tokens)
        a["ttft"].append(h.ttft)
        a["tpot"].append(h.tpot)
        if a["last_finish"] is None or h.finished_at > a["last_finish"]:
            a["last_finish"] = h.finished_at
        if h.slo_ttft is not None or h.slo_tpot is not None:
            a["slo_total"] += 1
            a["slo_hit"] += int(h.slo_met())
        self.inflight[rep] -= 1
        if not self.retain:                   # large-trace mode: release
            del sched.handles[lrid]
            del self._local2fleet[rep][lrid]
            del self.assigned[frid]

    def _next_time(self):
        cands = []
        if self.pending:
            cands.append(self.pending[0][0])
        if self._controls:
            cands.append(self._controls[0][0])
        if self._thead is not None:
            cands.append(float(self._thead["arrival"]))
        return min(cands) if cands else None

    # --- the loop ------------------------------------------------------------

    def step(self) -> bool:
        """One fleet round: apply due controls, pull + route due
        arrivals, step every busy replica in sorted-id order, merge
        event logs.  Returns False once the whole fleet is idle."""
        self._apply_controls()
        self._pull_trace()
        progress = self._route_due()
        more = bool(self.pending or self._controls
                    or self._thead is not None)
        for rep in sorted(self.replicas):
            sched = self.replicas[rep]
            if sched.pending or sched.ready or sched.running:
                progress = sched.step(more_arrivals=more) or progress
        self._drain_events()
        tel = self.telemetry
        if tel.enabled and self.tier is not None:
            sample = (self.tier.hits, self.tier.bytes)
            if sample != self._tier_sampled:   # counter tracks on change
                self._tier_sampled = sample
                tel.counter("prefix_tier.hits", sample[0])
                tel.counter("prefix_tier.bytes", sample[1])
        if progress:
            return True
        nxt = self._next_time()
        if nxt is not None and nxt > self.clock.now():
            self.clock.advance(nxt - self.clock.now())  # idle-jump
            if tel.enabled:
                tel.instant("fleet", 0, "idle_jump")
            return True
        if nxt is not None:
            # the head arrival is due but deferred and no replica can
            # move — only a scheduled control (scale-up) can resolve it;
            # jump straight to the next one, or fail loudly
            if self._controls:
                self.clock.advance(self._controls[0][0] - self.clock.now())
                if tel.enabled:
                    tel.instant("fleet", 0, "idle_jump")
                return True
            raise RuntimeError(
                "fleet stalled: arrivals due but deferred with no "
                "admitting progress and no scale-up scheduled (all "
                "replicas draining, or shed threshold never clears)")
        if any(s.ready or s.running or s.pending
               for s in self.replicas.values()):
            raise RuntimeError(
                "fleet stalled: a replica is blocked with no traffic left")
        return False

    def run_until_idle(self, max_rounds: int = 10_000_000) -> None:
        for _ in range(max_rounds):
            if not self.step():
                return
        raise RuntimeError(f"fleet not idle after {max_rounds} rounds — "
                           "starvation or a stuck request")

    def replay(self, trace, *, drain_at=(), scale_at=(),
               max_rounds: int = 10_000_000) -> ServerReport:
        """Feed a trace (list, or generator with non-decreasing arrivals
        streamed with one row of lookahead) and drain the fleet.
        ``drain_at``: iterable of ``(t, rep)``; ``scale_at``: iterable of
        ``(t, rep, engine_or_factory)`` — both applied at virtual ``t``,
        before any routing at that instant."""
        for t, rep in drain_at:
            self.schedule_drain(t, rep)
        for t, rep, eng in scale_at:
            self.schedule_scale(t, rep, eng)
        if hasattr(trace, "__len__"):
            if not trace:
                raise ValueError("replay() needs a non-empty trace")
            for r in trace:
                self._enqueue({
                    "arrival": float(r["arrival"]), "prompt": r["prompt"],
                    "max_new": r["max_new"],
                    "priority": r.get("priority", 0),
                    "slo_ttft": r.get("slo_ttft"),
                    "slo_tpot": r.get("slo_tpot")})
        else:
            self._trace = iter(trace)
            self._thead = next(self._trace, None)
            if self._thead is None:
                raise ValueError("replay() needs a non-empty trace")
        self.run_until_idle(max_rounds)
        return self.report()

    # --- aggregation (the deterministic fleet record) ------------------------

    def report(self) -> ServerReport:
        """The fleet-wide ``ServerReport`` over every finished request.

        Swap fields sum the schedulers' *data*-page counters per replica
        (``n_pages_swapped_out/in``) — one unit, one sum; the pools'
        released-*reference* counters (``swapped_out_pages``) are a
        different unit and deliberately never enter the
        report.  ``admission_order`` carries fleet-wide request ids; in
        large-trace mode (``retain=False``) the merged log lives only in
        ``event_digest()`` and the order is empty."""
        a = self._agg
        if not a["n"]:
            raise RuntimeError("nothing finished yet — replay a trace or "
                               "run_until_idle() first")
        pct = lambda xs, q: float(                          # noqa: E731
            np.percentile(np.asarray(xs, np.float64), q))
        scheds = self.replicas.values()
        return ServerReport(
            n_requests=a["n"],
            n_tokens=a["tokens"],
            makespan=a["last_finish"] - a["first_arrival"],
            p50_ttft=pct(a["ttft"], 50), p99_ttft=pct(a["ttft"], 99),
            p50_tpot=pct(a["tpot"], 50), p99_tpot=pct(a["tpot"], 99),
            preemptions=sum(s.n_preemptions for s in scheds),
            pages_swapped_out=sum(s.n_pages_swapped_out for s in scheds),
            pages_swapped_in=sum(s.n_pages_swapped_in for s in scheds),
            slo_attainment=(a["slo_hit"] / a["slo_total"]
                            if a["slo_total"] else 1.0),
            admission_order=[frid for _, _, kind, frid in self.events
                             if kind == "admit"],
            n_shed=self.n_shed)

    def event_digest(self) -> str:
        """SHA-256 over the merged event log so far — the O(1)-memory
        replay fingerprint the large-trace determinism test compares."""
        return self._digest.hexdigest()

    def prefix_hit_rate(self) -> float:
        """Fleet-wide prefix-cache hit rate: pooled hit/miss pages over
        every paged replica — what prefix-aware routing is measured on
        against round-robin."""
        hit = miss = 0
        for sched in self.replicas.values():
            if getattr(sched.engine, "paged", False):
                st = sched.engine.pool.stats
                hit += st.hit_pages
                miss += st.miss_pages
        return hit / (hit + miss) if hit + miss else 0.0

    def shared_tier_stats(self) -> dict | None:
        """The fleet tier's hit/byte counters, or None when no tier is
        attached."""
        return self.tier.stats() if self.tier is not None else None

    def materialized_pages(self) -> int:
        """Fleet-wide prompt pages actually COMPUTED (pooled
        ``miss_pages``) — the quantity the shared tier exists to shrink;
        tier- and locally-served pages never enter it."""
        return sum(s.engine.pool.stats.miss_pages
                   for s in self.replicas.values()
                   if getattr(s.engine, "paged", False))

    def replica_stats(self) -> dict:
        """Per-replica routing/preemption/swap counters, sorted ids —
        the registry side of the registry-vs-report swap cross-check."""
        out = {}
        for rep in sorted(self.replicas):
            s = self.replicas[rep]
            out[rep] = {
                "routed": self.n_routed_to[rep],
                "inflight": self.inflight[rep],
                "draining": rep in self.router.draining,
                "migrated_out": self.migrated_from[rep],
                "preemptions": s.n_preemptions,
                "pages_swapped_out": s.n_pages_swapped_out,
                "pages_swapped_in": s.n_pages_swapped_in}
        return out
