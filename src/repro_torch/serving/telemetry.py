"""Deterministic serving telemetry: lifecycle spans, a metrics registry and
Perfetto trace export under the injected virtual clock (the port's copy of
``repro/serving/telemetry.py``).

Nothing under ``serving/`` reads the wall clock, so the record replays: two
replays of a seeded trace give byte-identical metric snapshots, event logs
and Perfetto exports, and the port's equal the reference's byte for byte
(``tests/test_torch_telemetry.py``), apart from the kernels section.

Three surfaces, one object:

* **Spans** on named tracks: per request (``queued → running ⇄ swapped →
  finished`` on ``requests``), per slot (``prefill`` / ``decode`` /
  ``swap_out`` / ``swap_in`` on ``slots``) and per round (``round`` on
  ``sched``), stamped by the scheduler's injected clock.  ``to_perfetto()``
  emits the Chrome trace-event JSON that Perfetto opens: one process per
  track, one thread per request or slot; ``event_log()`` is the same record
  as rows.
* **Metrics**: counters, gauges and histograms, plus snapshot-time
  *providers* that pull the page pool's and the spec decoder's stats into
  one ``snapshot()``.  Swap counters spell their direction
  (``*_swapped_out_*`` / ``*_swapped_in_*``), and the two swap units stay
  apart: ``pool.swapped_out_pages`` counts page *references* released,
  ``sched.pages_swapped_out`` the *data* pages moved through the host blob.
* **Null registry** (``NULL_TELEMETRY``), the default: every method is a
  no-op and ``enabled`` is False, so the hot paths skip their aggregation.

Every number in ``snapshot()`` / ``event_log()`` / ``to_perfetto()`` comes
from the virtual clock, the seeded trace or allocator state; floats are
rounded to 9 decimals (the scheduler's event rounding), torch and numpy
scalars become Python numbers, and JSON is dumped with sorted keys.

The kernels section is the port's own (the reference's counts traced
matmul routes and autotune hits, which the port has not): ``launch.<name>``
is the delta of ``kernels.ops.launch_counts()`` since the registry first
attached an engine, present only where nonzero.  It counts kernel *wrapper
calls*: a decode step replayed from a CUDA graph calls no wrapper and
counts nothing, a captured one counts once.  On the CPU no wrapper
launches a kernel and the section is empty.  ``ops.reset_launch_counts``
between attach and snapshot would make the deltas negative.
"""

from __future__ import annotations

import json

from repro_torch.kernels import ops

__all__ = ["Telemetry", "NULL_TELEMETRY", "DEFAULT_BUCKETS", "TRACKS"]

# Histogram bucket upper edges (inclusive "≤ edge"; one overflow bucket
# rides above the last): occupancy and queue-depth counts.
DEFAULT_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128)

# Track name -> Perfetto pid.  "counters" carries the "C" (counter-track)
# samples.  Scoped tracks (a fleet replica's "r0.requests", ...) get pids
# above these in first-appearance order, deterministic under replay.
TRACKS = {"requests": 1, "slots": 2, "sched": 3, "counters": 4}


def _canon(obj):
    """Canonicalize for byte-stable JSON: floats to 9 decimals, numpy
    scalars and torch scalars / 0-d tensors to Python ints and floats
    (through ``.item()``)."""
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, int):
        return int(obj)
    if isinstance(obj, float):
        return round(float(obj), 9)
    if hasattr(obj, "item"):                 # numpy / torch scalar
        return _canon(obj.item())
    return obj


class _Hist:
    """Fixed-edge histogram: per-bucket counts + count/sum/min/max."""

    __slots__ = ("edges", "counts", "count", "total", "lo", "hi")

    def __init__(self, edges):
        self.edges = tuple(edges)
        self.counts = [0] * (len(self.edges) + 1)
        self.count = 0
        self.total = 0.0
        self.lo = None
        self.hi = None

    def observe(self, v):
        v = float(v)
        for i, e in enumerate(self.edges):
            if v <= e:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.count += 1
        self.total += v
        self.lo = v if self.lo is None else min(self.lo, v)
        self.hi = v if self.hi is None else max(self.hi, v)

    def to_json(self):
        return {"edges": list(self.edges), "counts": list(self.counts),
                "count": self.count, "sum": self.total,
                "min": self.lo, "max": self.hi}


class Telemetry:
    """Tracer + metrics registry over one injected clock.

    Construction is cheap and clock-less; whoever owns the virtual clock
    (``AsyncScheduler`` via ``Server(telemetry=...)``, or a ``Fleet``)
    calls ``bind_clock`` before spans are emitted.  Span begin/end pairs
    are keyed ``(track, tid, name)``.
    """

    enabled = True

    def __init__(self, clock=None):
        self.clock = clock
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, _Hist] = {}
        self._providers: list[tuple[str, object]] = []
        self._events: list[tuple] = []       # ("X", t0, t1, trk, tid, name)
        self._open: dict[tuple, float] = {}  # (trk, tid, name) -> t0
        self._kernels_attached = False

    def bind_clock(self, clock) -> None:
        self.clock = clock

    # --- metrics -------------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        self._gauges[name] = value

    def observe(self, name: str, value, edges=None) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _Hist(DEFAULT_BUCKETS if edges is None
                                          else edges)
        h.observe(value)

    def add_provider(self, prefix: str, fn) -> None:
        """Register a snapshot-time stats source: ``fn()`` returns a flat
        dict merged under ``prefix`` in every ``snapshot()``."""
        self._providers.append((prefix, fn))

    # --- spans ---------------------------------------------------------------

    def span(self, track: str, tid: int, name: str, t0: float,
             t1: float) -> None:
        """A complete span with explicit times (prefill, decode rounds,
        swaps: work delimited by clock advances)."""
        self._events.append(("X", round(t0, 9), round(t1, 9),
                             track, int(tid), name))

    def open_span(self, track: str, tid: int, name: str) -> None:
        self._open[(track, int(tid), name)] = self.clock.now()

    def close_span(self, track: str, tid: int, name: str) -> None:
        t0 = self._open.pop((track, int(tid), name), None)
        if t0 is not None:
            self.span(track, tid, name, t0, self.clock.now())

    def instant(self, track: str, tid: int, name: str) -> None:
        self._events.append(("I", round(self.clock.now(), 9),
                             track, int(tid), name))

    def counter(self, name: str, value) -> None:
        """One sample of a counter track at the current virtual time: a
        Perfetto "C" event on the ``counters`` process."""
        self._events.append(("C", round(self.clock.now(), 9), name,
                             round(float(value), 9)))

    # --- snapshot / export ---------------------------------------------------

    def snapshot(self) -> dict:
        """Counters, gauges, histograms and every provider's live stats,
        as one canonicalized dict."""
        snap = {"counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.to_json()
                               for k, h in self._hists.items()}}
        for prefix, fn in self._providers:
            sect = snap.setdefault(prefix, {})
            sect.update(fn())
        return _canon(snap)

    def snapshot_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True,
                          separators=(",", ":"))

    def event_log(self) -> list:
        """Span, instant and counter rows in emission order."""
        out = []
        for ev in self._events:
            if ev[0] == "X":
                _, t0, t1, track, tid, name = ev
                out.append({"ph": "X", "t0": t0, "t1": t1, "track": track,
                            "tid": tid, "name": name})
            elif ev[0] == "C":
                _, t, name, value = ev
                out.append({"ph": "C", "t": t, "name": name,
                            "value": value})
            else:
                _, t, track, tid, name = ev
                out.append({"ph": "I", "t": t, "track": track, "tid": tid,
                            "name": name})
        return out

    def event_log_json(self) -> str:
        return json.dumps(self.event_log(), sort_keys=True,
                          separators=(",", ":"))

    def to_perfetto(self) -> dict:
        """Chrome trace-event JSON: "X" complete events on one process a
        track and one thread a request or slot, timestamps in microseconds
        of virtual time.  Tracks beyond ``TRACKS`` get pids in
        first-appearance order."""
        us = lambda t: int(round(t * 1e6))               # noqa: E731
        tracks = dict(TRACKS)
        for ev in self._events:                  # scoped-track discovery
            if ev[0] == "C":
                continue
            track = ev[3] if ev[0] == "X" else ev[2]
            if track not in tracks:
                tracks[track] = max(tracks.values()) + 1
        events, seen = [], set()
        for track, pid in sorted(tracks.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "pid": pid, "name": "process_name",
                           "args": {"name": track}})
        for ev in self._events:
            if ev[0] == "C":
                # Perfetto keys a counter series on (pid, name); scoped
                # series ("r0.sched.queue_depth") stay separate curves
                _, t, name, value = ev
                events.append({"ph": "C", "pid": tracks["counters"],
                               "ts": us(t), "name": name,
                               "args": {"value": value}})
                continue
            track, tid = (ev[3], ev[4]) if ev[0] == "X" else (ev[2], ev[3])
            pid = tracks[track]
            if (pid, tid) not in seen:
                seen.add((pid, tid))
                unit = track[:-1] if track.endswith("s") else track
                events.append({"ph": "M", "pid": pid, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": f"{unit} {tid}"}})
            if ev[0] == "X":
                _, t0, t1, _, _, name = ev
                events.append({"ph": "X", "pid": pid, "tid": tid,
                               "ts": us(t0), "dur": us(t1 - t0),
                               "name": name, "cat": track})
            else:
                _, t, _, _, name = ev
                events.append({"ph": "i", "pid": pid, "tid": tid,
                               "ts": us(t), "name": name, "cat": track,
                               "s": "t"})
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"clock": "virtual"}}

    def export_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f, indent=1)

    def export_metrics(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps(self.snapshot(), sort_keys=True, indent=1)
                    + "\n")

    # --- scoping (fleet replicas) --------------------------------------------

    def scoped(self, scope: str) -> "_ScopedTelemetry":
        """A view of THIS registry that prefixes every metric name,
        provider prefix, span track and counter series with ``<scope>.``:
        one snapshot and one export, per-scope sections and tracks.  A
        fleet hands replica ``r0``'s scheduler ``telemetry.scoped("r0")``."""
        return _ScopedTelemetry(self, scope)

    # --- subsystem wiring ----------------------------------------------------

    def attach_engine(self, engine) -> None:
        """Point an engine's hot-path counters here and register its page
        pool, spec acceptance and kernel launches as snapshot-time
        providers.  Schedulers call this; batch users may call it
        directly."""
        engine.telemetry = self
        if getattr(engine, "paged", False):
            self.add_provider("pool", _pool_provider(engine))
        if getattr(engine, "spec", None) is not None \
                or getattr(engine, "spec_stats", None) is not None:
            self.add_provider("spec", _spec_provider(engine))
        if getattr(engine, "probes", False):
            self.add_provider("numerics", engine.numerics)
        self.attach_kernel_counters()

    def attach_kernel_counters(self) -> None:
        """Register the kernels section: ``launch.<kernel>``, the wrapper
        calls of ``ops.launch_counts()`` since this first attach (the
        counters are process-wide), keys present only when nonzero.
        Idempotent: engines attached later share the first baseline."""
        if self._kernels_attached:
            return
        self._kernels_attached = True
        base = ops.launch_counts()

        def prov():
            out = {}
            for k, v in ops.launch_counts().items():
                d = v - base.get(k, 0)
                if d:
                    out[f"launch.{k}"] = d
            return out

        self.add_provider("kernels", prov)

    # --- human summary -------------------------------------------------------

    def summary(self) -> str:
        """Compact end-of-run lines."""
        s = self.snapshot()
        c = s.get("counters", {})
        g = lambda k: c.get(k, 0)                        # noqa: E731
        lines = []
        if g("sched.submitted"):            # batch users have no scheduler
            lines.append(f"[telemetry] requests: {g('sched.admissions')} "
                         f"admitted, {g('sched.preemptions')} preempted "
                         f"({g('sched.pages_swapped_out')} pages out / "
                         f"{g('sched.pages_swapped_in')} in), "
                         f"{g('sched.finished')} finished")
            slo = g("sched.slo_hits") + g("sched.slo_misses")
            if slo:
                lines[-1] += f"; SLO {g('sched.slo_hits')}/{slo} met"
        if g("engine.steps"):
            lines.append(f"[telemetry] engine: {g('engine.steps')} decode "
                         f"rounds, {g('engine.tokens')} tokens, "
                         f"{g('engine.stops_finished')} finished / "
                         f"{g('engine.stops_quantum')} quantum-bounded "
                         f"slot-rounds, {g('engine.admit_blocked')} blocked "
                         "admissions")
        pool = s.get("pool")
        if pool:
            lines.append(f"[telemetry] pool: prefix hit rate "
                         f"{100 * pool['hit_rate']:.0f}% "
                         f"({pool['hit_pages']} hit / {pool['miss_pages']} "
                         f"miss), peak {pool['peak_pages_in_use']} pages / "
                         f"refcount high-water {pool['peak_page_refs']}, "
                         f"{pool['cow_copies']} CoW, "
                         f"{pool['evictions']} evictions, swap "
                         f"{pool['swapped_out_pages']} out / "
                         f"{pool['swapped_in_pages']} in")
        spec = s.get("spec")
        if spec and spec.get("proposed"):
            lines.append(f"[telemetry] spec: acceptance "
                         f"{100 * spec['acceptance_rate']:.0f}% "
                         f"({spec['accepted']}/{spec['proposed']} drafted), "
                         f"{spec['tokens_per_round']:.1f} tokens/round over "
                         f"{spec['rounds']} rounds")
        kern = s.get("kernels")
        if kern:
            launches = ", ".join(f"{k}={v}" for k, v in sorted(kern.items()))
            lines.append(f"[telemetry] kernels: {launches}")
        num = s.get("numerics")
        if num and num.get("tokens"):
            sat = max(num.get("sat_rate") or [0.0])
            hr = min(num.get("headroom_bits") or [31.0])
            kv = max(num.get("kv_err_max") or [0.0])
            lines.append(f"[telemetry] numerics[{num.get('backend')}]: "
                         f"{int(num['tokens'])} tokens probed, worst-layer "
                         f"saturation {100 * sat:.3f}%, accumulator headroom "
                         f"{hr:.1f} bits min, kv round-trip err {kv:.2e} max, "
                         f"page_oob {int(num.get('page_oob', 0))}, widx_oob "
                         f"{int(num.get('widx_oob', 0))}")
        return "\n".join(lines) if lines else "[telemetry] nothing recorded"


def _pool_provider(engine):
    def prov():
        st = engine.pool.stats
        return {"hit_pages": st.hit_pages, "miss_pages": st.miss_pages,
                "shared_hit_pages": st.shared_hit_pages,
                "hit_rate": st.hit_rate, "cow_copies": st.cow_copies,
                "evictions": st.evictions,
                "peak_pages_in_use": st.peak_pages_in_use,
                "peak_page_refs": st.peak_page_refs,
                "truncated_pages": st.truncated_pages,
                "swapped_out_pages": st.swapped_out_pages,
                "swapped_in_pages": st.swapped_in_pages,
                "pages_in_use": engine.pool.pages_in_use(),
                "pressure": engine.pool.pressure()}
    return prov


def _spec_provider(engine):
    def prov():
        ss = engine.spec_stats
        return {"rounds": ss.rounds, "proposed": ss.proposed,
                "accepted": ss.accepted, "emitted": ss.emitted,
                "acceptance_rate": ss.acceptance_rate,
                "tokens_per_round": ss.tokens_per_round}
    return prov


class _ScopedTelemetry:
    """Name-prefixing view of a shared ``Telemetry``: every counter, gauge
    and histogram name, provider prefix, span track and counter series
    gains ``<scope>.``.  State lives in the base registry, so a fleet's
    replicas land in one snapshot and one export.  The kernels section
    stays unscoped: launch counters are process-wide."""

    enabled = True

    def __init__(self, base, scope: str):
        self._base = base
        self.scope = str(scope)

    def _n(self, name: str) -> str:
        return f"{self.scope}.{name}"

    def bind_clock(self, clock) -> None:
        self._base.bind_clock(clock)

    def count(self, name, n=1):
        self._base.count(self._n(name), n)

    def gauge(self, name, value):
        self._base.gauge(self._n(name), value)

    def observe(self, name, value, edges=None):
        self._base.observe(self._n(name), value, edges)

    def add_provider(self, prefix, fn):
        self._base.add_provider(self._n(prefix), fn)

    def span(self, track, tid, name, t0, t1):
        self._base.span(self._n(track), tid, name, t0, t1)

    def open_span(self, track, tid, name):
        self._base.open_span(self._n(track), tid, name)

    def close_span(self, track, tid, name):
        self._base.close_span(self._n(track), tid, name)

    def instant(self, track, tid, name):
        self._base.instant(self._n(track), tid, name)

    def counter(self, name, value):
        self._base.counter(self._n(name), value)

    def attach_engine(self, engine) -> None:
        """``Telemetry.attach_engine`` with the providers under this scope
        ("r0.pool", "r0.spec", ...)."""
        engine.telemetry = self
        if getattr(engine, "paged", False):
            self.add_provider("pool", _pool_provider(engine))
        if getattr(engine, "spec", None) is not None \
                or getattr(engine, "spec_stats", None) is not None:
            self.add_provider("spec", _spec_provider(engine))
        if getattr(engine, "probes", False):
            self.add_provider("numerics", engine.numerics)
        self._base.attach_kernel_counters()

    def attach_kernel_counters(self) -> None:
        self._base.attach_kernel_counters()

    def scoped(self, scope: str) -> "_ScopedTelemetry":
        return _ScopedTelemetry(self._base, self._n(scope))

    def snapshot(self):
        return self._base.snapshot()

    def event_log(self):
        return self._base.event_log()

    def summary(self):
        return self._base.summary()


class _NullTelemetry:
    """The disabled default: every method is a no-op and ``enabled`` is
    False.  One shared instance, never mutated."""

    enabled = False

    def bind_clock(self, clock):
        pass

    def count(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    def observe(self, name, value, edges=None):
        pass

    def add_provider(self, prefix, fn):
        pass

    def span(self, track, tid, name, t0, t1):
        pass

    def open_span(self, track, tid, name):
        pass

    def close_span(self, track, tid, name):
        pass

    def instant(self, track, tid, name):
        pass

    def counter(self, name, value):
        pass

    def attach_engine(self, engine):
        pass

    def attach_kernel_counters(self):
        pass

    def scoped(self, scope):
        return self

    def snapshot(self):
        return {}

    def event_log(self):
        return []

    def summary(self):
        return "[telemetry] disabled"


NULL_TELEMETRY = _NullTelemetry()
