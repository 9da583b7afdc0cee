"""The telemetry registry of the port (``repro_torch/serving/telemetry.py``)
against the JAX package's, computed live in this process, mirroring
``tests/test_telemetry.py``.

* registry units: the same calls on both registries (counters, gauges,
  histogram edges and overflow, providers merged under their prefix,
  scoped names and tracks, spans, instants, counter tracks, torch and
  numpy scalars) give byte-equal ``snapshot_json``, ``event_log_json``
  and Perfetto JSON;
* an instrumented ``Server.replay(contended_trace(1, vocab))`` at
  ``CONTENDED_ENGINE_KW`` (bf16 and int8 pages) equals the reference's
  byte for byte in snapshot, event log and Perfetto JSON, with the kernels
  section removed on both sides (the port's counts kernel launches, the
  reference's traced matmul routes);
* an instrumented replay and a null-registry replay give equal events,
  streams and report; counters agree with the report; the Perfetto
  structure; an export round trip; the null registry is inert;
* the port's kernels section holds launch deltas from attach time.

Model: qwen3-1.7b reduced to 2 layers in f32, params carried by the
bridge (``test_torch_spec.py``'s ``qwen``).  Every comparison is exact.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import (CONTENDED_ENGINE_KW,  # noqa: E402
                                 NULL_TELEMETRY, Server, Telemetry,
                                 contended_trace)
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.telemetry import TRACKS, _canon  # noqa: E402
from test_torch_spec import _reference_model, qwen  # noqa: E402,F401

torch.set_num_threads(2)


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def now(self):
        return self.t


def _no_kernels(snapshot_json: str) -> str:
    """The snapshot JSON with its kernels section removed, re-dumped the
    way ``snapshot_json`` dumps."""
    snap = json.loads(snapshot_json)
    snap.pop("kernels", None)
    return json.dumps(snap, sort_keys=True, separators=(",", ":"))


def _record(tel) -> dict:
    return {"snapshot": _no_kernels(tel.snapshot_json()),
            "events": tel.event_log_json(),
            "perfetto": json.dumps(tel.to_perfetto(), sort_keys=True)}


# --- registry units against the reference -----------------------------------

def _drive(tel, scalar):
    """One fixed sequence of registry calls; ``scalar(x, kind)`` makes the
    package's own scalar type (torch on the port, numpy on the
    reference)."""
    clock = _Clock(0.25)
    tel.bind_clock(clock)
    tel.count("a")
    tel.count("a", 2)
    tel.count("big", 10 ** 12)
    tel.gauge("g", 0.1 + 0.2)
    tel.gauge("g32", scalar(1 / 3, "f32"))
    tel.gauge("i", scalar(7, "i64"))
    for v in (0, 1, 2, 3, 5, 128, 129, 200, -1, 0.5):
        tel.observe("h", v)
    tel.observe("edges", scalar(2.5, "f32"), edges=(1, 2.5, 10))
    tel.observe("edges", 11, edges=(1, 2.5, 10))
    tel.observe("edges", 1, edges=(99,))          # first edges stick
    tel.add_provider("pool", lambda: {"x": 1, "rate": 2 / 3})
    tel.add_provider("pool", lambda: {"y": scalar(2.5, "f32")})
    tel.add_provider("spec", lambda: {"ok": True, "none": None,
                                      "list": [scalar(1, "i64"), 0.1]})
    r0 = tel.scoped("r0")
    r0.count("sched.rounds", 3)
    r0.gauge("load", 0.75)
    r0.observe("sched.queue_depth", 4)
    r0.add_provider("pool", lambda: {"pressure": 1 - 5 / 8})
    r0.scoped("inner").count("n")
    tel.open_span("requests", 0, "queued")
    r0.open_span("requests", 0, "queued")
    clock.t = 0.5 + 1e-10
    tel.close_span("requests", 0, "queued")
    tel.close_span("requests", 9, "never-opened")
    r0.close_span("requests", 0, "queued")
    tel.span("slots", 1, "prefill", 0.25, 0.30000000004)
    r0.span("slots", 1, "decode", 0.5, 0.52)
    tel.instant("sched", 0, "idle_jump")
    r0.instant("fleet", 0, "join:r0")
    tel.counter("sched.queue_depth", 3)
    r0.counter("pool.pressure", scalar(0.375, "f32"))
    tel.counter("x", 0.1 + 0.2)
    clock.t = 1.0
    tel.scoped("r1").instant("requests", 2, "submit")
    tel.instant("fleet", 0, "drain:r0")


def test_registry_units_equal_reference():
    """The same calls on both registries: byte-equal snapshots, event
    logs and Perfetto JSON; histogram overflow and the first edges a
    histogram was given; providers merged under one prefix; scoped
    names, sections and tracks (pids above ``TRACKS`` in first-appearance
    order); torch scalars canonicalized as the reference's numpy ones."""
    from repro.serving.telemetry import Telemetry as JTelemetry
    cast = {"f32": (torch.float32, np.float32), "i64": (torch.int64,
                                                        np.int64)}
    tel, jtel = Telemetry(), JTelemetry()
    _drive(tel, lambda x, k: torch.tensor(x, dtype=cast[k][0]))
    _drive(jtel, lambda x, k: cast[k][1](x))
    assert tel.snapshot_json() == jtel.snapshot_json()
    assert tel.event_log_json() == jtel.event_log_json()
    assert json.dumps(tel.to_perfetto(), sort_keys=True) == \
        json.dumps(jtel.to_perfetto(), sort_keys=True)
    snap = tel.snapshot()
    h = snap["histograms"]["h"]
    assert h["counts"][-1] == 2 and h["count"] == 10 and h["min"] == -1
    assert snap["histograms"]["edges"]["edges"] == [1, 2.5, 10]
    assert snap["histograms"]["edges"]["counts"] == [1, 1, 0, 1]
    assert snap["pool"] == {"x": 1, "rate": round(2 / 3, 9), "y": 2.5}
    assert snap["r0.pool"] == {"pressure": 0.375}
    assert snap["counters"]["r0.inner.n"] == 1
    assert snap["gauges"]["i"] == 7 and type(snap["gauges"]["i"]) is int
    procs = {e["args"]["name"]: e["pid"] for e in
             tel.to_perfetto()["traceEvents"] if e["name"] == "process_name"}
    assert procs == {**TRACKS, "r0.requests": 5, "r0.slots": 6,
                     "r0.fleet": 7, "r1.requests": 8, "fleet": 9}


def test_canon_turns_torch_scalars_into_python_numbers():
    """A provider may return torch scalars or 0-d tensors; they become
    Python ints, floats and bools, rounded as the reference rounds."""
    got = _canon({"f": torch.tensor(0.1, dtype=torch.float64) * 3,
                  "i": torch.tensor(5), "b": torch.tensor(True),
                  "n": np.float32(0.5), 1: (torch.tensor(2.0),)})
    assert got == {"f": round(0.1 * 3, 9), "i": 5, "b": True, "n": 0.5,
                   "1": [2.0]}
    assert [type(v) for v in (got["f"], got["i"], got["b"])] == \
        [float, int, bool]
    assert json.dumps(got, sort_keys=True)


def test_counter_event_units():
    tel = Telemetry()
    tel.bind_clock(_Clock(1.5))
    tel.counter("q", 3)
    tel.counter("q", torch.tensor(0.1 + 0.2, dtype=torch.float64))
    log = tel.event_log()
    assert log[0] == {"ph": "C", "t": 1.5, "name": "q", "value": 3.0}
    assert log[1]["value"] == round(0.1 + 0.2, 9)


def test_null_telemetry_is_inert():
    n = NULL_TELEMETRY
    assert n.enabled is False
    n.count("a")
    n.gauge("g", 1)
    n.observe("h", 1)
    n.instant("requests", 0, "x")
    n.open_span("requests", 0, "x")
    n.close_span("requests", 0, "x")
    n.span("slots", 0, "x", 0.0, 1.0)
    n.counter("c", 1)
    n.add_provider("p", lambda: {"x": 1})
    n.bind_clock(None)
    n.attach_engine(object())
    n.attach_kernel_counters()
    assert n.scoped("r0") is n
    assert n.snapshot() == {}
    assert n.event_log() == []
    assert n.summary() == "[telemetry] disabled"


# --- instrumented replays ----------------------------------------------------

def _replay(engine, trace, server, tel=None):
    srv = server(engine, telemetry=tel)
    rep = srv.replay(trace)
    streams = {h.rid: list(h.tokens) for h in srv.sched.handles.values()}
    return srv, rep, streams


@pytest.fixture(scope="module")
def replays(qwen):
    """Per kv dtype: the port's instrumented replay of the contended trace,
    the reference's, and the port's with the null registry.  Records are
    taken right after each drain."""
    from repro.serving import ServeEngine as JEngine
    from repro.serving import Server as JServer
    from repro.serving.telemetry import Telemetry as JTelemetry
    trace = contended_trace(1, qwen.cfg.vocab)
    out = {"trace": trace}
    for kv in ("bf16", "int8"):
        kw = dict(CONTENDED_ENGINE_KW, kv_dtype=kv)
        tel, jtel = Telemetry(), JTelemetry()
        srv, rep, st = _replay(TEngine(qwen.tmodel, qwen.tparams["dense"],
                                       device="cpu", **kw), trace, Server,
                               tel)
        rec = _record(tel)
        jsrv, jrep, jst = _replay(JEngine(qwen.model, qwen.params["dense"],
                                          **kw), trace, JServer, jtel)
        out[kv] = {"tel": tel, "srv": srv, "rep": rep, "streams": st,
                   "rec": rec, "jrec": _record(jtel), "jrep": jrep,
                   "jstreams": jst, "jevents": jsrv.sched.events}
    nsrv, nrep, nst = _replay(
        TEngine(qwen.tmodel, qwen.tparams["dense"], device="cpu",
                **CONTENDED_ENGINE_KW), trace, Server)
    out["null"] = {"srv": nsrv, "rep": nrep, "streams": nst}
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_instrumented_replay_equals_reference(replays, kv):
    """The acceptance criterion: snapshot, event log and Perfetto JSON
    equal the reference's byte for byte (kernels section removed), and
    so do the events, streams and report behind them."""
    r = replays[kv]
    assert r["rep"].preemptions >= 1, "trace is not contended: weak test"
    for k in ("snapshot", "events", "perfetto"):
        assert r["rec"][k].encode() == r["jrec"][k].encode(), k
    assert r["srv"].sched.events == r["jevents"]
    assert r["streams"] == r["jstreams"]
    assert r["rep"].to_json() == r["jrep"].to_json()
    snap = json.loads(r["rec"]["snapshot"])
    assert {"counters", "gauges", "histograms", "pool", "spec"} <= set(snap)
    assert snap["counters"]["sched.swap_bytes_out"] > 0


def test_telemetry_does_not_change_decisions(replays):
    """Observability is write-only: the instrumented replay's events,
    streams and report equal the null registry's."""
    r, n = replays["bf16"], replays["null"]
    assert r["srv"].sched.events == n["srv"].sched.events
    assert r["streams"] == n["streams"]
    assert r["rep"].to_json() == n["rep"].to_json()
    assert n["srv"].telemetry is NULL_TELEMETRY
    assert n["srv"].sched.engine.telemetry is NULL_TELEMETRY


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_counters_match_report(replays, kv):
    r = replays[kv]
    rep, snap = r["rep"], json.loads(r["rec"]["snapshot"])
    c, n = snap["counters"], len(replays["trace"])
    assert c["sched.submitted"] == c["sched.arrivals"] == n
    assert c["sched.finished"] == rep.n_requests == n
    assert c["sched.preemptions"] == rep.preemptions
    assert c["sched.pages_swapped_out"] == rep.pages_swapped_out
    assert c["sched.pages_swapped_in"] == rep.pages_swapped_in
    assert c["sched.preemptions"] == c["sched.resumes"]
    assert c["sched.swap_bytes_out"] == c["sched.swap_bytes_in"] > 0
    assert c["engine.tokens"] + c["sched.admissions"] == rep.n_tokens
    assert snap["pool"]["swapped_out_pages"] >= c["sched.pages_swapped_out"]
    assert snap["pool"]["peak_page_refs"] >= 1
    assert r["srv"].sched.engine.telemetry is r["tel"]


def test_perfetto_structure(replays):
    """One process a track, one thread a request or slot; a full lifecycle
    a request, the preempted one's detour, slot spans, and counter tracks
    equal in the event log and the Chrome-trace JSON."""
    r, n = replays["bf16"], len(replays["trace"])
    doc = json.loads(r["rec"]["perfetto"])
    evs = doc["traceEvents"]
    assert doc["otherData"]["clock"] == "virtual"
    procs = {e["args"]["name"]: e["pid"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == TRACKS
    threads = {(e["pid"], e["tid"]) for e in evs
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {(TRACKS["requests"], rid) for rid in range(n)} <= threads
    assert len(threads) == len({(e["pid"], e["tid"]) for e in evs
                                if e["ph"] in ("X", "i")})
    req = TRACKS["requests"]
    for rid in range(n):
        named = {e["name"] for e in evs
                 if e.get("pid") == req and e.get("tid") == rid}
        assert {"queued", "running", "admit", "finish"} <= named, rid
    for e in evs:
        if e["ph"] == "X":
            assert isinstance(e["ts"], int) and e["dur"] >= 0
    pre = [e["tid"] for e in evs if e.get("pid") == req
           and e["name"] == "preempt"]
    assert pre
    assert {"swapped", "resume"} <= {e["name"] for e in evs if e.get("pid")
                                     == req and e.get("tid") == pre[0]}
    slot_names = {e["name"] for e in evs
                  if e.get("pid") == TRACKS["slots"] and e["ph"] == "X"}
    assert {"prefill", "decode", "swap_out", "swap_in"} <= slot_names
    cs = [e for e in r["tel"].event_log() if e["ph"] == "C"]
    assert {"sched.queue_depth", "pool.pressure",
            "engine.batch_occupancy"} <= {e["name"] for e in cs}
    pcs = [e for e in evs if e["ph"] == "C"]
    assert all(e["pid"] == TRACKS["counters"] for e in pcs)
    assert [(e["name"], e["value"]) for e in cs] == \
        [(e["name"], e["args"]["value"]) for e in pcs]


def test_export_files_round_trip(replays, tmp_path):
    tel = replays["bf16"]["tel"]
    mpath, tpath = tmp_path / "m.json", tmp_path / "t.json"
    tel.export_metrics(str(mpath))
    tel.export_trace(str(tpath))
    with open(mpath) as f:
        assert json.load(f) == tel.snapshot()
    with open(tpath) as f:
        assert json.load(f) == json.loads(json.dumps(tel.to_perfetto()))
    assert _no_kernels(tel.snapshot_json()) == \
        replays["bf16"]["rec"]["snapshot"]


def test_summary_lines(replays):
    s = replays["bf16"]["tel"].summary()
    rep = replays["bf16"]["rep"]
    assert s.startswith("[telemetry] requests: ")
    assert f"{rep.preemptions} preempted" in s
    assert "[telemetry] engine:" in s and "[telemetry] pool:" in s
    assert Telemetry().summary() == "[telemetry] nothing recorded"


# --- the port's kernels section ----------------------------------------------

def test_kernel_section_counts_launches_from_attach(qwen):
    """``launch.<kernel>`` holds the wrapper calls made after the registry
    first attached an engine, a key only where nonzero: launches counted
    before the attach (another engine's serve) are not folded in, and a
    second engine shares the first baseline.  On the CPU no wrapper
    launches, so the calls are counted by hand here."""
    K = ops.KERNELS
    saved = {k: fn.launches for k, fn in K.items()}
    try:
        K["codebook_matmul"].launches += 5           # an earlier serve
        K["page_gather"].launches += 3
        tel = Telemetry()
        srv = Server(TEngine(qwen.tmodel, qwen.tparams["dense"],
                             device="cpu", **CONTENDED_ENGINE_KW),
                     telemetry=tel)
        assert tel.snapshot()["kernels"] == {}
        K["page_gather"].launches += 2
        K["act_quant"].launches += 1
        tel.attach_engine(srv.sched.engine)           # idempotent baseline
        K["page_gather"].launches += 1
        assert tel.snapshot()["kernels"] == {"launch.page_gather": 3,
                                             "launch.act_quant": 1}
        assert "[telemetry] kernels: launch.act_quant=1, " \
            "launch.page_gather=3" in tel.summary()
        r1 = tel.scoped("r1")
        r1.attach_kernel_counters()
        assert "r1.kernels" not in tel.snapshot()
    finally:
        for k, fn in K.items():
            fn.launches = saved[k]
