"""Request server and synthetic traffic over ``AsyncScheduler`` (the port's
copy of ``repro/serving/server.py``).

``Server`` wraps engine and scheduler into a long-running server:
``submit()`` for live traffic (arrival = the injected clock's now),
``replay()`` for a recorded or synthetic trace (the deterministic mode),
and a ``ServerReport`` (p50/p99 TTFT and TPOT, preemptions, SLO
attainment) after a drain.

Traffic: ``poisson_trace`` makes a seeded open-loop arrival process
(exponential gaps, mixed prompt and stop lengths, priority classes,
optional SLOs) through numpy, so that this package and the reference
draw the same trace from one seed; ``save_trace``/``load_trace``
round-trip traces as JSON.  The same trace gives the same scheduler
decisions: nothing here reads the wall clock.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.serving.scheduler import AsyncScheduler, VirtualClock

__all__ = ["Server", "ServerReport", "poisson_trace", "poisson_trace_iter",
           "save_trace", "load_trace", "iter_trace", "contended_trace",
           "CONTENDED_ENGINE_KW"]

# The contended workload: an engine one notch too small for the trace
# below, so that admissions queue and priority preemptions fire (seeds 0
# and 1 preempt).  The reference's pair, unchanged: contention at a seed
# is a property of the pair.
CONTENDED_ENGINE_KW = dict(max_len=48, max_batch=2, paged=True,
                           page_size=8, n_pages=9)


def contended_trace(seed: int, vocab: int, **over) -> list[dict]:
    """The reference 8-request contended trace for the engine shape in
    ``CONTENDED_ENGINE_KW`` (keyword overrides pass through to
    ``poisson_trace``, e.g. SLOs)."""
    return poisson_trace(seed, 8, rate=40.0, vocab=vocab, plen=(2, 9),
                         max_new=(2, 10), priorities=(0, 1), **over)


def poisson_trace_iter(seed: int, n: int, *, rate: float = 20.0,
                       vocab: int = 512, plen=(2, 10), max_new=(2, 12),
                       priorities=(0,), slo_ttft: float | None = None,
                       slo_tpot: float | None = None, shared_prefix=()):
    """Streamed form of ``poisson_trace``: yields one row at a time with
    O(1) rows live, so 100k+-request traces never materialize in RAM.
    Same seed → the same row sequence as the list form, element for
    element.  ``shared_prefix``: tokens
    prepended to every prompt (the shared-system-prompt workload the
    prefix-aware router is measured on).  Arrivals are non-decreasing by
    construction — what ``Fleet.replay`` requires of a streamed trace."""
    rng = np.random.default_rng(seed)
    prefix = [int(x) for x in shared_prefix]
    t = 0.0
    for _ in range(n):
        t += float(rng.exponential(1.0 / rate))
        pl = int(rng.integers(plen[0], plen[1] + 1))
        yield {
            "arrival": round(t, 9),
            "prompt": prefix + [int(x) for x in rng.integers(0, vocab, pl)],
            "max_new": int(rng.integers(max_new[0], max_new[1] + 1)),
            "priority": int(rng.choice(priorities)),
            "slo_ttft": slo_ttft, "slo_tpot": slo_tpot}


def poisson_trace(seed: int, n: int, *, rate: float = 20.0,
                  vocab: int = 512, plen=(2, 10), max_new=(2, 12),
                  priorities=(0,), slo_ttft: float | None = None,
                  slo_tpot: float | None = None,
                  shared_prefix=()) -> list[dict]:
    """Seeded open-loop Poisson arrival trace: ``n`` requests at ``rate``
    arrivals per (virtual) second, prompt/stop lengths uniform over the
    given inclusive ranges, priority drawn uniformly from
    ``priorities``.  Pure function of its arguments."""
    return list(poisson_trace_iter(
        seed, n, rate=rate, vocab=vocab, plen=plen, max_new=max_new,
        priorities=priorities, slo_ttft=slo_ttft, slo_tpot=slo_tpot,
        shared_prefix=shared_prefix))


def save_trace(path: str, trace) -> None:
    """Write a trace (list OR generator) as a JSON array, one row per
    line — rows stream straight to disk, so saving a 100k+-request
    generator never materializes it."""
    with open(path, "w") as f:
        f.write("[")
        sep = "\n"
        for row in trace:
            f.write(sep)
            json.dump(row, f)
            sep = ",\n"
        f.write("\n]\n")


def load_trace(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def iter_trace(path: str, chunk: int = 1 << 16):
    """Stream a JSON-array trace row by row with O(1) rows buffered —
    the replay-side twin of a generator ``save_trace``.  Accepts any
    JSON array of objects (not just line-delimited ones)."""
    dec = json.JSONDecoder()
    with open(path) as f:
        buf = f.read(chunk)
        i = 0
        while True:
            while True:                      # skip [ , whitespace
                while i < len(buf) and buf[i] in " \t\r\n,[":
                    i += 1
                if i < len(buf):
                    break
                more = f.read(chunk)
                if not more:
                    raise ValueError(f"{path}: truncated trace")
                buf, i = more, 0
            if buf[i] == "]":
                return
            try:
                row, end = dec.raw_decode(buf, i)
            except ValueError:
                more = f.read(chunk)         # row split across the buffer
                if not more:
                    raise
                buf, i = buf[i:] + more, 0
                continue
            yield row
            buf, i = buf[end:], 0


@dataclasses.dataclass
class ServerReport:
    """Aggregate + per-request metrics after a drained trace.  Every
    field is in injected-clock time — deterministic under a
    ``VirtualClock`` replay."""

    n_requests: int
    n_tokens: int
    makespan: float                  # first arrival -> last finish
    p50_ttft: float
    p99_ttft: float
    p50_tpot: float
    p99_tpot: float
    preemptions: int
    pages_swapped_out: int           # data pages preemption moved out
    pages_swapped_in: int            # data pages restore moved back
    slo_attainment: float            # over requests that set an SLO
    admission_order: list
    # arrivals rejected by fleet admission backpressure (DESIGN.md §15);
    # always 0 for the single server, which has no shed gate
    n_shed: int = 0

    @staticmethod
    def build(handles, sched) -> "ServerReport":
        pct = lambda xs, q: float(                          # noqa: E731
            np.percentile(np.asarray(xs, np.float64), q))
        sloed = [h for h in handles
                 if h.slo_ttft is not None or h.slo_tpot is not None]
        att = (sum(h.slo_met() for h in sloed) / len(sloed)
               if sloed else 1.0)
        return ServerReport(
            n_requests=len(handles),
            n_tokens=sum(len(h.tokens) for h in handles),
            makespan=(max(h.finished_at for h in handles)
                      - min(h.arrival for h in handles)),
            p50_ttft=pct([h.ttft for h in handles], 50),
            p99_ttft=pct([h.ttft for h in handles], 99),
            p50_tpot=pct([h.tpot for h in handles], 50),
            p99_tpot=pct([h.tpot for h in handles], 99),
            preemptions=sched.n_preemptions,
            pages_swapped_out=sum(h.pages_swapped_out for h in handles),
            pages_swapped_in=sched.n_pages_swapped_in,
            slo_attainment=att,
            admission_order=sched.admission_order)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Server:
    """Long-running request server: one engine, one scheduler, an
    injected clock.  ``replay()`` is the deterministic batch entry;
    ``submit()``/``poll()`` compose into live loops."""

    def __init__(self, engine, *, clock=None, costs=None, quantum: int = 1,
                 preempt: bool = True, telemetry=None):
        self.clock = VirtualClock() if clock is None else clock
        self.sched = AsyncScheduler(engine, clock=self.clock, costs=costs,
                                    quantum=quantum, preempt=preempt,
                                    telemetry=telemetry)
        self.telemetry = self.sched.telemetry

    def submit(self, prompt, max_new: int, **kw):
        return self.sched.submit(prompt, max_new, **kw)

    def poll(self) -> bool:
        """One scheduling round; False once idle."""
        return self.sched.step()

    def run_until_idle(self) -> None:
        self.sched.run_until_idle()

    def replay(self, trace: list[dict]) -> ServerReport:
        """Feed a trace's arrivals and drain it under the injected
        clock.  Returns the aggregate report; per-request handles stay
        readable on ``self.sched.handles``."""
        if not trace:
            raise ValueError("replay() needs a non-empty trace")
        handles = [self.sched.submit(
                       r["prompt"], r["max_new"],
                       priority=r.get("priority", 0),
                       arrival=r["arrival"],
                       slo_ttft=r.get("slo_ttft"),
                       slo_tpot=r.get("slo_tpot"))
                   for r in trace]
        self.sched.run_until_idle()
        return ServerReport.build(handles, self.sched)
