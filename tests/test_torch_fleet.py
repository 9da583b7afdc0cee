"""The router and the multi-replica fleet of the port
(``repro_torch/serving/router.py``, ``fleet.py``) against the JAX
package's, computed live in this process, mirroring ``tests/test_fleet.py``
and ``tests/test_fleet_scale.py``.

* router units over fake probes: decisions equal the reference
  ``FleetRouter``'s (scoring and ties, the round-robin cycle, the cursor
  across membership changes, ``decide`` with defer and shed);
* fleets of the reduced model at ``CONTENDED_ENGINE_KW``: ``event_digest``,
  merged events, streams and ``report().to_json()`` equal the reference's
  for 2 replicas in both orders, drain and scale-up, drain migration (also
  against ``Server.replay``), the shared prefix tier (bf16 and int8 pages:
  tier and pool counters equal too), every shed policy, and one replica
  against ``Server.replay``; the fleet's telemetry equals the reference's
  byte for byte, kernels section removed;
* fleets of stub engines (the port's copy of the reference's
  ``_StubEngine``, over the port's ``PagePool``): all replicas drained,
  deferring until a scale-up and failing loudly without one, a streamed
  replay equal to the list replay, and ``retain=False`` over 2,000
  requests giving the reference's digest;
* the reference's two state-machine walks (``_SchedWalk`` of
  ``tests/test_scheduler_sim.py``, ``_FleetWalk`` of ``tests/test_fleet.py``)
  on the port's scheduler and fleet over the stub, 12 seeds each, with the
  invariants checked after every transition and the events equal to the
  reference walk's of the same seed.

The ``cuda`` test needs the card (``pytest -m cuda``): a 2-replica
contended fleet on the graph route equals the eager route.  JAX is
imported only through fixtures and inside tests: the card's machine has
none.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import (CONTENDED_ENGINE_KW, Fleet,  # noqa: E402
                                 FleetRouter, PagePool, ReplicaProbe,
                                 Server, Telemetry, contended_trace,
                                 poisson_trace, poisson_trace_iter)
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.scheduler import (FINISHED,  # noqa: E402
                                           RUNNING, AsyncScheduler)
from test_torch_spec import _reference_model, qwen  # noqa: E402,F401

torch.set_num_threads(2)

STUB_KW = dict(max_batch=2, n_pages=9, page_size=8)
N_WALKS = 12


# --- the port's stub engine --------------------------------------------------

class _StubModel:
    def init_paged_cache(self, n_pages, page_size, dtype, device=None, tp=1):
        return {"k": torch.zeros((1, n_pages, page_size, 1, 2),
                                 dtype=torch.float32, device=device)}


class _StubState:
    def __init__(self, B):
        self.live = np.zeros(B, bool)
        self.adm = [None] * B
        self.pos = np.zeros(B, int)
        self.gen = np.zeros(B, int)
        self.stop = np.zeros(B, int)


class _StubEngine:
    """The engine's sched_* surface over the port's real ``PagePool``, with
    decode replaced by a fake emission (token == n_gen): the port's copy of
    the reference's ``_StubEngine`` (``tests/test_scheduler_sim.py``)."""

    spec = None
    paged = True

    def __init__(self, *, max_batch, n_pages, page_size):
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_len = page_size * (n_pages - 1)
        self.pool = PagePool(_StubModel(), n_pages=n_pages,
                             page_size=page_size,
                             pages_per_slot=n_pages - 1,
                             kv_dtype=torch.float32, prefix_cache=True,
                             device="cpu")

    def sched_check(self, prompt, stop):
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        if len(prompt) + stop > self.max_len:
            raise ValueError("prompt + max_new exceeds max_len")

    def sched_state(self):
        return _StubState(self.max_batch)

    def sched_admit(self, st, slot, prompt, stop):
        adm = self.pool.admit(list(prompt), stop)
        if adm is None:
            return None
        self.pool.register_prefill(adm)
        self.pool.cow(adm)
        st.adm[slot] = adm
        st.live[slot] = True
        st.pos[slot] = len(prompt)
        st.gen[slot], st.stop[slot] = 1, stop
        return 0

    def serve_step(self, st, quantum=1):
        toks, done = {}, []
        for b in range(self.max_batch):
            if not st.live[b] or st.gen[b] >= st.stop[b]:
                continue
            n = int(min(quantum, st.stop[b] - st.gen[b]))
            toks[b] = [int(st.gen[b] + i) for i in range(n)]
            st.gen[b] += n
            st.pos[b] += n
            if st.gen[b] >= st.stop[b]:
                done.append(b)
        return toks, done

    def sched_release(self, st, slot):
        self.pool.retire(st.adm[slot])
        st.adm[slot] = None
        st.live[slot] = False

    def sched_swap_out(self, st, slot):
        adm = st.adm[slot]
        n_data = -(-int(st.pos[slot]) // self.page_size)
        blob = SimpleNamespace(n_pages=n_data, reserve=adm.reserve,
                               pos=int(st.pos[slot]),
                               n_gen=int(st.gen[slot]),
                               stop=int(st.stop[slot]))
        self.pool.swap_out(adm)
        st.adm[slot] = None
        st.live[slot] = False
        return blob

    def sched_swap_in(self, st, slot, blob):
        adm = self.pool.swap_in(blob.reserve)
        if adm is None:
            return False
        st.adm[slot] = adm
        st.live[slot] = True
        st.pos[slot] = blob.pos
        st.gen[slot], st.stop[slot] = blob.n_gen, blob.stop
        return True


@pytest.fixture(scope="module")
def jref():
    """The reference's fleet, router, telemetry and stub engine."""
    pytest.importorskip("jax")
    import repro.serving as JS
    from test_scheduler_sim import _StubEngine as JStub
    return SimpleNamespace(Fleet=JS.Fleet, Router=JS.FleetRouter,
                           Telemetry=JS.Telemetry, Stub=JStub)


def _record(fleet, rep=None):
    """Everything the determinism contract covers: digest, merged events,
    streams (retain mode) and the report."""
    return {"digest": fleet.event_digest(), "events": list(fleet.events),
            "streams": {frid: list(h.tokens)
                        for frid, h in fleet.handles.items()},
            "report": (rep or fleet.report()).to_json()}


# --- the router --------------------------------------------------------------

class _FakeProbe:
    def __init__(self, match=0, load=0, free=0, pressure=0.0):
        self.m, self.l, self.f, self.p = match, load, free, pressure

    def prefix_match_pages(self, toks):
        return self.m

    def load(self):
        return self.l

    def free_pages(self):
        return self.f

    def pressure(self):
        return self.p


def _scoring(R):
    r, out = R(), []
    r.add("r1", _FakeProbe(match=2))
    r.add("r0", _FakeProbe(match=0, free=5))
    out.append(r.route([1]))                # prefix beats free pages
    r.probes["r0"].m = 2
    r.probes["r1"].l = 1
    out.append(r.route([1]))                # equal prefix: lighter load
    r.probes["r1"].l = 0
    out.append(r.route([1]))                # full tie: smallest id
    r.probes["r1"].f = 6
    out.append(r.route([1]))                # then free pages
    r.drain("r0")
    out.append(r.route([1]))
    r.drain("r1")
    with pytest.raises(RuntimeError, match="no admitting replica"):
        r.route([1])
    with pytest.raises(ValueError, match="unknown policy"):
        R(policy="sticky")
    with pytest.raises(ValueError, match="already registered"):
        r.add("r0", _FakeProbe())
    with pytest.raises(KeyError):
        r.drain("r9")
    assert out == ["r1", "r0", "r0", "r1", "r1"]
    return out + [r.n_routed, r.admitting]


def _round_robin(R):
    r = R(policy="round_robin")
    for rep in ("r2", "r0", "r1"):
        r.add(rep, _FakeProbe())
    out = [r.route([1]) for _ in range(6)]
    assert out == ["r0", "r1", "r2", "r0", "r1", "r2"]
    r.drain("r1")
    out += [r.route([1]) for _ in range(4)]
    assert set(out[6:]) == {"r0", "r2"}
    return out


def _rr_membership(R):
    r = R(policy="round_robin")
    for rep in ("r0", "r1", "r2"):
        r.add(rep, _FakeProbe())
    out = [r.route([1]) for _ in range(4)]
    r.drain("r0")
    out += [r.route([1]) for _ in range(4)]
    r.add("r3", _FakeProbe())
    out += [r.route([1]) for _ in range(36)]
    assert out[:14] == ["r0", "r1", "r2", "r0", "r1", "r2", "r1", "r2",
                        "r3", "r1", "r2", "r3", "r1", "r2"]
    assert {k: out[14:].count(k) for k in set(out[14:])} == \
        {"r1": 10, "r2": 10, "r3": 10}
    return out + [r.n_routed]


def _decide(R):
    r = R(shed_policy="slo", shed_threshold=0.8)
    r.add("r0", _FakeProbe(pressure=0.9))
    r.add("r1", _FakeProbe(pressure=0.97))
    out = [r.pressure(), r.decide([1], has_slo=True),
           r.decide([1], has_slo=False), r.n_shed]
    r.probes["r0"].p = 0.2
    out.append(r.decide([1], has_slo=True))
    r_all = R(shed_policy="all", shed_threshold=0.5)
    r_all.add("r0", _FakeProbe(pressure=0.6))
    r_def = R(shed_policy="defer", shed_threshold=0.5)
    r_def.add("r0", _FakeProbe(pressure=0.6))
    r_none = R(shed_threshold=0.5)
    r_none.add("r0", _FakeProbe(pressure=1.0))
    r2 = R()
    r2.add("r0", _FakeProbe())
    r2.drain("r0")
    out += [r_all.decide([1]), r_def.decide([1]), r_none.decide([1]),
            r2.decide([1]), r2.pressure()]
    with pytest.raises(RuntimeError, match="no admitting replica"):
        r2.route([1])
    with pytest.raises(ValueError, match="unknown shed policy"):
        R(shed_policy="maybe")
    assert out == [0.9, ("shed", None), ("defer", None), 1,
                   ("route", "r0"), ("shed", None), ("defer", None),
                   ("route", "r0"), ("defer", None), 1.0]
    return out


@pytest.mark.parametrize("scenario", [_scoring, _round_robin,
                                      _rr_membership, _decide],
                         ids=lambda f: f.__name__.strip("_"))
def test_router_decisions_equal_reference(jref, scenario):
    """The same probe states and calls: the port's router decides as the
    reference's does, and as the reference's own tests pin."""
    assert scenario(FleetRouter) == scenario(jref.Router)


# --- fleets of the reduced model against the reference -----------------------

def _engines(qwen, order, **kw):
    kw = dict(CONTENDED_ENGINE_KW, **kw)
    return ({r: TEngine(qwen.tmodel, qwen.tparams["dense"], device="cpu",
                        **kw) for r in order},
            {r: qwen.Engine(qwen.model, qwen.params["dense"], **kw)
             for r in order})


def _both(qwen, jref, order, trace, *, engine_kw=None, scale=None,
          **fleet_kw):
    """The same fleet on both packages: (port record, reference record,
    port fleet, reference fleet).  ``scale``: (t, rep) of a scale-up by a
    fresh engine of the same shape; ``drain_at`` passes through."""
    ekw = engine_kw or {}
    drain_at = fleet_kw.pop("drain_at", ())
    te, je = _engines(qwen, order, **ekw)
    tf = Fleet(te, **fleet_kw)
    jf = jref.Fleet(je, **fleet_kw)
    ts = js = ()
    if scale is not None:
        t, rep = scale
        ts = [(t, rep, lambda: _engines(qwen, [rep], **ekw)[0][rep])]
        js = [(t, rep, lambda: _engines(qwen, [rep], **ekw)[1][rep])]
    trep = tf.replay(trace, drain_at=drain_at, scale_at=ts)
    jrep = jf.replay(trace, drain_at=drain_at, scale_at=js)
    return _record(tf, trep), _record(jf, jrep), tf, jf


@pytest.mark.parametrize("order", [["r0", "r1"], ["r1", "r0"]],
                         ids=["r0r1", "r1r0"])
def test_two_replicas_equal_reference(qwen, jref, order):
    """2 replicas on the contended trace, in either replica order: digest,
    events, streams and report equal the reference's (and so the order
    does not matter)."""
    trace = contended_trace(1, qwen.cfg.vocab)
    got, want, tf, _ = _both(qwen, jref, order, trace)
    assert got == want
    assert got["report"]["n_requests"] == len(trace)
    routed = {r: st["routed"] for r, st in tf.replica_stats().items()}
    assert sum(routed.values()) == len(trace) and min(routed.values()) > 0
    assert all(s.engine.pool.reserved_extra == 0
               for s in tf.replicas.values())


def test_drain_and_scale_up_equal_reference(qwen, jref):
    """Mid-trace drain and scale-up: the reference's case, equal to the
    reference's run; the drained replica takes no route after the drain
    and the joiner serves."""
    trace = poisson_trace(1, 16, rate=60.0, vocab=qwen.cfg.vocab,
                          plen=(2, 9), max_new=(2, 10), priorities=(0, 1))
    got, want, tf, jf = _both(qwen, jref, ["r0", "r1"], trace,
                              drain_at=[(0.12, "r0")], scale=(0.18, "r2"))
    assert got == want
    assert tf.replica_stats() == jf.replica_stats()
    assert tf.inflight["r0"] == 0 and tf.n_routed_to["r2"] > 0
    t_drain = next(t for t, _, k, _ in tf.events if k == "drain")
    late = {r for t, r, k, _ in tf.events if k == "route" and t > t_drain}
    assert late and "r0" not in late
    assert all(h.state == FINISHED for h in tf.handles.values())


def test_drain_migration_equals_reference_and_server(qwen, jref):
    """Drain migration: the requests expelled from r0 (running ones as
    swap blobs) are adopted by r1, and every stream equals one server's
    replay of the same trace; digest, events and report equal the
    reference's, in both replica orders."""
    trace = poisson_trace(7, 10, rate=80.0, vocab=qwen.cfg.vocab,
                          plen=(2, 9), max_new=(6, 10))
    srv = Server(TEngine(qwen.tmodel, qwen.tparams["dense"], device="cpu",
                         **CONTENDED_ENGINE_KW))
    srv.replay(trace)
    want = {rid: list(h.tokens) for rid, h in srv.sched.handles.items()}
    recs = []
    for order in (["r0", "r1"], ["r1", "r0"]):
        got, ref, tf, jf = _both(qwen, jref, order, trace,
                                 migrate_on_drain=True,
                                 drain_at=[(0.08, "r0")])
        assert got == ref
        assert got["streams"] == want
        assert tf.n_migrated == jf.n_migrated >= 1
        assert tf.n_migrated_pages == jf.n_migrated_pages >= 1
        assert tf.replica_stats() == jf.replica_stats()
        kinds = {k for _, _, k, _ in tf.events}
        assert {"migrate", "expel", "adopt"} <= kinds
        assert all(s.engine.pool.reserved_extra == 0
                   for s in tf.replicas.values())
        recs.append(got)
    assert recs[0]["digest"] == recs[1]["digest"]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_shared_tier_equals_reference(qwen, jref, kv):
    """Two requests sharing a two-page system prompt, round robin: with
    the tier, r1 takes both pages from it; tokens equal the tier-less
    fleet's, fewer pages are materialized, and the tier's stats (bytes
    of every plane, int8 scales included) and the pools' shared hits
    equal the reference's."""
    page = CONTENDED_ENGINE_KW["page_size"]
    sys_prompt = list(range(1, 2 * page + 1))
    trace = [{"arrival": 0.0, "prompt": sys_prompt + [5, 6], "max_new": 4},
             {"arrival": 0.4, "prompt": sys_prompt + [9], "max_new": 4}]
    runs = {}
    for tier in (False, True):
        got, want, tf, jf = _both(qwen, jref, ["r0", "r1"], trace,
                                  engine_kw={"kv_dtype": kv},
                                  policy="round_robin",
                                  shared_prefix_tier=tier)
        assert got == want
        assert tf.shared_tier_stats() == jf.shared_tier_stats()
        pools = [tf.replicas[r].engine.pool for r in ("r0", "r1")]
        jpools = [jf.replicas[r].engine.pool for r in ("r0", "r1")]
        assert [p.stats.shared_hit_pages for p in pools] == \
            [p.stats.shared_hit_pages for p in jpools]
        assert tf.materialized_pages() == jf.materialized_pages()
        assert tf.prefix_hit_rate() == jf.prefix_hit_rate()
        runs[tier] = (got, tf)
    (base, fb), (got, f) = runs[False], runs[True]
    assert got["streams"] == base["streams"]
    stats = f.shared_tier_stats()
    assert stats["hits"] >= 2 and stats["puts"] >= 2 and stats["bytes"] > 0
    assert sum(f.replicas[r].engine.pool.stats.shared_hit_pages
               for r in ("r0", "r1")) >= 2
    assert f.materialized_pages() < fb.materialized_pages()
    assert fb.shared_tier_stats() is None


def _slo_trace(vocab):
    """12 long-prompt arrivals at 200 a second (two contended replicas
    run near full pools), a TTFT SLO on every other request."""
    trace = poisson_trace(1, 12, rate=200.0, vocab=vocab, plen=(10, 20),
                          max_new=(4, 10), priorities=(0, 1))
    return [dict(r, slo_ttft=0.05 if i % 2 else None)
            for i, r in enumerate(trace)]


@pytest.mark.parametrize("policy", ["none", "defer", "slo", "all"])
def test_shed_policies_equal_reference(qwen, jref, policy):
    """Admission backpressure on 2 contended replicas at threshold 0.5:
    each shed policy's shed set, deferrals, digest, events, streams and
    report equal the reference's."""
    trace = _slo_trace(qwen.cfg.vocab)
    got, want, tf, jf = _both(qwen, jref, ["r0", "r1"], trace,
                              shed_policy=policy, shed_threshold=0.5)
    assert got == want
    assert (tf.shed_rids, tf.n_deferred) == (jf.shed_rids, jf.n_deferred)
    assert got["report"]["n_shed"] == len(tf.shed_rids)
    if policy in ("slo", "all"):
        assert tf.shed_rids, f"{policy}: nothing shed: weak test"
    if policy in ("slo", "defer"):
        assert tf.n_deferred >= 1, f"{policy}: nothing deferred"
    if policy == "slo":
        assert all(trace[i]["slo_ttft"] is not None for i in tf.shed_rids)
    if policy == "none":
        assert not tf.shed_rids and not tf.n_deferred


def test_one_replica_fleet_is_the_server(qwen, jref):
    """``Fleet`` of one replica: the streams, report and scheduling
    decisions of ``Server.replay``, and the reference fleet's record."""
    trace = contended_trace(1, qwen.cfg.vocab)
    srv = Server(TEngine(qwen.tmodel, qwen.tparams["dense"], device="cpu",
                         **CONTENDED_ENGINE_KW))
    rep_s = srv.replay(trace)
    got, want, tf, _ = _both(qwen, jref, ["r0"], trace)
    assert got == want
    assert rep_s.preemptions >= 1
    assert got["report"] == rep_s.to_json()
    assert got["streams"] == {h.rid: h.tokens
                              for h in srv.sched.handles.values()}
    kinds = ("arrive", "admit", "preempt", "resume", "finish")
    assert [(t, k, r) for t, _, k, r in tf.events if k in kinds] == \
        [(t, k, r) for t, k, r in srv.sched.events if k in kinds]


def test_fleet_telemetry_equals_reference(qwen, jref):
    """A 2-replica fleet with one registry: snapshot (``r0.``/``r1.``/
    ``fleet.`` sections), event log and Perfetto JSON equal the
    reference's byte for byte, kernels section removed; per-replica
    tracks get pids above the fixed ones; counters agree with the
    report and the replicas' stats."""
    from test_torch_telemetry import _record as tel_record
    trace = contended_trace(1, qwen.cfg.vocab)
    tel, jtel = Telemetry(), jref.Telemetry()
    te, je = _engines(qwen, ["r0", "r1"])
    tf, jf = Fleet(te, telemetry=tel), jref.Fleet(je, telemetry=jtel)
    got, want = _record(tf, tf.replay(trace)), _record(jf, jf.replay(trace))
    assert got == want
    rec, jrec = tel_record(tel), tel_record(jtel)
    for k in ("snapshot", "events", "perfetto"):
        assert rec[k].encode() == jrec[k].encode(), k
    snap = json.loads(rec["snapshot"])
    c, rep = snap["counters"], tf.report()
    assert "r0.pool" in snap and "r1.pool" in snap
    assert c["fleet.routed"] == c["fleet.submitted"] == len(trace)
    assert c["fleet.replicas"] == 2
    reps = ("r0", "r1")
    assert rep.preemptions == sum(c.get(f"{r}.sched.preemptions", 0)
                                  for r in reps)
    assert rep.pages_swapped_out == sum(
        c.get(f"{r}.sched.pages_swapped_out", 0) for r in reps)
    assert rep.n_tokens == sum(c.get(f"{r}.engine.tokens", 0)
                               + c.get(f"{r}.sched.admissions", 0)
                               for r in reps)
    assert rep.pages_swapped_out == sum(
        s["pages_swapped_out"] for s in tf.replica_stats().values())
    evs = json.loads(rec["perfetto"])["traceEvents"]
    procs = {e["args"]["name"]: e["pid"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"r0.requests", "r0.slots", "r1.requests", "r1.slots",
            "fleet"} <= set(procs)
    assert min(procs[n] for n in ("r0.requests", "r1.sched", "fleet")) > 4
    tids = {e["tid"] for n in ("r0.requests", "r1.requests") for e in evs
            if e.get("pid") == procs[n] and e["ph"] != "M"}
    assert tids


# --- stub fleets: deferral, streaming, scale ---------------------------------

def _stub_pair(jref, engines_of, **kw):
    """(port fleet, reference fleet) over stubs; ``engines_of(Stub)``
    builds the engines argument."""
    return (Fleet(engines_of(_StubEngine), **kw),
            jref.Fleet(engines_of(jref.Stub), **kw))


def test_all_drained_defers_until_scale_up(jref):
    """An arrival while every replica drains is deferred, then routed the
    instant a scale-up joins; without one the fleet fails loudly.  Both
    as the reference."""
    trace = [{"arrival": 0.0, "prompt": [1, 2, 3], "max_new": 2},
             {"arrival": 0.3, "prompt": [4, 5, 6], "max_new": 2}]
    recs = []
    for Stub, F in ((_StubEngine, Fleet), (jref.Stub, jref.Fleet)):
        f = F({"r0": Stub(**STUB_KW)})
        rep = f.replay(trace, drain_at=[(0.2, "r0")],
                       scale_at=[(0.5, "r1", lambda: Stub(**STUB_KW))])
        assert f.n_deferred == 1 and rep.n_requests == 2
        routed = [(t, r) for t, r, k, frid in f.events
                  if k == "route" and frid == 1]
        assert routed[0][1] == "r1" and routed[0][0] >= 0.5
        recs.append(_record(f, rep))
        g = F({"r0": Stub(**STUB_KW)})
        with pytest.raises(RuntimeError, match="fleet stalled"):
            g.replay(trace, drain_at=[(0.1, "r0")])
        recs.append(list(g.events))
    assert recs[0] == recs[2] and recs[1] == recs[3]


def test_stub_shed_policies_equal_reference(jref):
    """The reference's backpressure case over stubs (one replica,
    threshold 0.5, an SLO arrival among big ones) under every policy."""
    big = lambda tok: {"prompt": [tok] * 16, "max_new": 8}  # noqa: E731
    trace = [{"arrival": 0.0, **big(1)}, {"arrival": 0.0, **big(2)},
             {"arrival": 0.01, "prompt": [3] * 4, "max_new": 2,
              "slo_ttft": 0.05},
             {"arrival": 0.012, "prompt": [4] * 4, "max_new": 2}]
    for policy in ("none", "defer", "slo", "all"):
        tf, jf = _stub_pair(jref, lambda S: [S(**STUB_KW)],
                            shed_policy=policy, shed_threshold=0.5)
        got, want = _record(tf, tf.replay(trace)), _record(jf,
                                                           jf.replay(trace))
        assert got == want, policy
        assert tf.shed_rids == jf.shed_rids
    assert tf.shed_rids


def test_streamed_replay_equals_list_replay(jref):
    """A generator trace (one row of lookahead) and ``retain=False``
    (digest only, handles released) give the list replay's digest and
    report, and the reference's."""
    kw = dict(rate=150.0, vocab=50, plen=(2, 9), max_new=(2, 8),
              priorities=(0, 1))
    f_list = Fleet([_StubEngine(**STUB_KW) for _ in range(3)])
    rep_list = f_list.replay(poisson_trace(5, 300, **kw))
    f_iter = Fleet([_StubEngine(**STUB_KW) for _ in range(3)], retain=False)
    rep_iter = f_iter.replay(poisson_trace_iter(5, 300, **kw))
    assert f_iter.event_digest() == f_list.event_digest()
    assert not f_iter.handles and not f_iter.assigned
    d = rep_list.to_json()
    d["admission_order"] = []
    assert rep_iter.to_json() == d
    j_list = jref.Fleet([jref.Stub(**STUB_KW) for _ in range(3)])
    assert j_list.replay(poisson_trace(5, 300, **kw)).to_json() == \
        rep_list.to_json()
    assert j_list.event_digest() == f_list.event_digest()
    with pytest.raises(ValueError, match="non-decreasing"):
        Fleet([_StubEngine(**STUB_KW)]).replay(iter(
            [{"arrival": 0.2, "prompt": [1, 2], "max_new": 2},
             {"arrival": 0.1, "prompt": [3, 4], "max_new": 2}]))


def test_streamed_retain_false_at_scale_equals_reference(jref):
    """The tier-1 counterpart of ``tests/test_fleet_scale.py``: 2,000
    streamed requests sharing a one-page system prompt over 4 stub
    replicas with prefix routing, a drain with migration, a scale-up and
    the shared tier, ``retain=False``:
    the digest and report equal the reference's, in bounded memory."""
    kw = dict(rate=400.0, vocab=8, plen=(1, 12), max_new=(1, 12),
              priorities=(0, 1, 2), shared_prefix=range(1, 9))
    recs = []
    for Stub, F in ((_StubEngine, Fleet), (jref.Stub, jref.Fleet)):
        f = F([Stub(**STUB_KW) for _ in range(4)], retain=False,
              migrate_on_drain=True, shared_prefix_tier=True)
        rep = f.replay(poisson_trace_iter(11, 2000, **kw),
                       drain_at=[(1.0, "r0")],
                       scale_at=[(2.0, "r4", lambda: Stub(**STUB_KW))])
        assert not f.handles and not f.assigned and not f.events
        assert rep.n_requests == 2000
        recs.append((f.event_digest(), rep.to_json(), f.n_migrated,
                     f.shared_tier_stats()["hits"], f.replica_stats()))
    assert recs[0] == recs[1]
    assert recs[0][2] >= 1 and recs[0][3] >= 1


def test_replica_probe_reads_the_replica():
    """``ReplicaProbe``: load, free pages, pressure and prefix match of a
    live paged replica, read-only."""
    f = Fleet({"r0": _StubEngine(**STUB_KW)})
    p = f.router.probes["r0"]
    assert isinstance(p, ReplicaProbe) and p.rep == "r0"
    pool = f.replicas["r0"].engine.pool
    assert (p.load(), p.free_pages(), p.pressure()) == (0, 8, 0.0)
    f.submit(list(range(20)), 3)
    f.step()
    assert p.load() == 1 and p.free_pages() == pool.free_claimable() == 5
    assert p.pressure() == pool.pressure() == 1 - 5 / 8
    order = list(pool.table)
    assert p.prefix_match_pages(list(range(20))) == 2
    assert list(pool.table) == order


# --- the reference's state-machine walks on the port -------------------------

class _SchedWalk:
    """The port's copy of the reference's ``_SchedWalk``: a random walk
    over submit/step on a scheduler over the stub, the invariants checked
    after every transition, then a full drain."""

    def __init__(self, rng, *, n_pages, page, B=2):
        self.rng = rng
        self.eng = _StubEngine(max_batch=B, n_pages=n_pages, page_size=page)
        self.sched = AsyncScheduler(self.eng, quantum=1)
        self.page = page
        self.held = {}

    def submit(self):
        page = self.page
        plen = int(self.rng.integers(1, 2 * page + 1))
        stop = int(self.rng.integers(1, 2 * page + 1))
        prompt = [int(t) for t in self.rng.integers(0, 3, plen)]
        dt = float(self.rng.choice([0.0, 0.0, 0.01, 0.05]))
        self.sched.submit(prompt, stop,
                          priority=int(self.rng.integers(0, 3)),
                          arrival=self.sched.clock.now() + dt)

    def step(self):
        self.sched.step()

    def check(self):
        sched, pool = self.sched, self.eng.pool
        holders = {}
        for h in sched.running:
            adm = sched.st.adm[h.slot]
            assert adm is not None and h.state == RUNNING
            pids = tuple(adm.pids[:adm.n_live])
            for pid in pids:
                assert pid != 0, "trash page held by a live request"
                holders.setdefault(pid, []).append(h.rid)
            key = self.held.get(h.rid)
            if key is not None and key[0] == h._admit_seq:
                assert key[1] == pids, f"request {h.rid} lost pages"
            self.held[h.rid] = (h._admit_seq, pids)
        for pid in range(1, pool.n_pages):
            want = len(holders.get(pid, ())) + (1 if pid in pool.key_of
                                                else 0)
            assert pool.ref[pid] == want, f"refcount leak on page {pid}"
        free = pool.free
        assert len(free) == len(set(free))
        assert set(free) == {p for p in range(1, pool.n_pages)
                             if pool.ref[p] == 0}
        assert pool.reserved_extra == 0
        assert pool.free_claimable() >= 0

    def run(self, n_ops=40):
        ops = [self.submit, self.submit, self.step, self.step, self.step]
        self.check()
        for _ in range(n_ops):
            ops[self.rng.integers(len(ops))]()
            self.check()
        self.sched.run_until_idle(max_rounds=5000)
        self.check()
        for h in self.sched.handles.values():
            assert h.state == FINISHED and len(h.tokens) == h.max_new
        assert all(self.eng.pool.ref[p] in (0, 1)
                   for p in range(1, self.eng.pool.n_pages))
        return self


class _FleetWalk:
    """The port's copy of the reference's ``_FleetWalk``: submit, step,
    drain and scale on a 2-replica stub fleet (migration and the shared
    tier each on in half the walks), the fleet invariants checked after
    every transition, then a full drain."""

    def __init__(self, rng):
        self.rng = rng
        self.fleet = Fleet({"r0": _StubEngine(**STUB_KW),
                            "r1": _StubEngine(**STUB_KW)},
                           migrate_on_drain=bool(rng.integers(2)),
                           shared_prefix_tier=bool(rng.integers(2)))
        self.drained = []
        self.scaled = False

    def submit(self):
        page = STUB_KW["page_size"]
        plen = int(self.rng.integers(1, 2 * page + 1))
        prompt = [int(t) for t in self.rng.integers(0, 3, plen)]
        dt = float(self.rng.choice([0.0, 0.0, 0.01, 0.05]))
        self.fleet.submit(prompt, int(self.rng.integers(1, 2 * page + 1)),
                          priority=int(self.rng.integers(0, 3)),
                          arrival=self.fleet.clock.now() + dt)

    def step(self):
        self.fleet.step()

    def drain(self):
        if len(self.fleet.router.admitting) > 1:
            rep = self.fleet.router.admitting[
                int(self.rng.integers(len(self.fleet.router.admitting)))]
            self.fleet.drain(rep)
            self.drained.append(rep)

    def scale(self):
        if not self.scaled:
            self.fleet.add_replica("r2", _StubEngine(**STUB_KW))
            self.scaled = True

    def check(self):
        fleet = self.fleet
        seen = dict(fleet._rows)
        for frid, (rep, lrid) in fleet.assigned.items():
            assert frid not in seen, f"request {frid} routed AND pending"
            h = fleet.replicas[rep].handles[lrid]
            assert fleet._local2fleet[rep][lrid] == frid
            seen[frid] = h
        assert sorted(seen) == list(range(fleet._seq)), "request lost"
        for rep, sched in fleet.replicas.items():
            local = fleet._local2fleet[rep]
            assert len(set(local.values())) == len(local), \
                f"{rep}: a request admitted twice"
            unfinished = sum(1 for h in sched.handles.values()
                             if h.state != FINISHED)
            assert fleet.inflight[rep] == unfinished
            pool = sched.engine.pool
            holders = {}
            for h in sched.running:
                adm = sched.st.adm[h.slot]
                for pid in adm.pids[:adm.n_live]:
                    assert pid != 0
                    holders[pid] = holders.get(pid, 0) + 1
            for pid in range(1, pool.n_pages):
                want = holders.get(pid, 0) + (1 if pid in pool.key_of
                                              else 0)
                assert pool.ref[pid] == want, \
                    f"{rep}: refcount leak on page {pid}"
            assert pool.reserved_extra == 0
        for rep in self.drained:
            assert rep not in fleet.router.admitting
            if fleet.migrate_on_drain:
                assert fleet.inflight[rep] == 0
                assert all(h.state == FINISHED
                           for h in fleet.replicas[rep].handles.values())

    def run(self, n_ops=40):
        ops = [self.submit, self.submit, self.step, self.step, self.step,
               self.drain, self.scale]
        self.check()
        for _ in range(n_ops):
            ops[self.rng.integers(len(ops))]()
            self.check()
        self.fleet.run_until_idle(max_rounds=5000)
        self.check()
        assert sum(h.state == FINISHED for h in self.fleet.handles.values()) \
            == self.fleet._seq
        for h in self.fleet.handles.values():
            assert len(h.tokens) == h.max_new
        for rep in self.drained:
            assert self.fleet.inflight[rep] == 0
        return self


def _walk_seed(i: int) -> int:
    return int(np.random.default_rng(1234 + i).integers(0, 2 ** 31 - 1))


@pytest.mark.parametrize("i", range(N_WALKS))
def test_scheduler_walk_equals_reference(jref, i):
    """The reference's scheduler walk on the port, one seed (pool size and
    page drawn from it as the reference's strategies draw): invariants
    hold after every transition, and the events equal the reference
    walk's of the same seed."""
    from test_scheduler_sim import _SchedWalk as JWalk
    seed = _walk_seed(i)
    n_pages, page = [6, 10][seed % 2], [2, 4][(seed >> 1) % 2]
    got = _SchedWalk(np.random.default_rng(seed), n_pages=n_pages,
                     page=page).run()
    want = JWalk(np.random.default_rng(seed), n_pages=n_pages, page=page)
    want.run()
    assert got.sched.events == want.sched.events
    assert got.sched.handles.keys() == want.sched.handles.keys()
    assert [h.tokens for h in got.sched.handles.values()] == \
        [h.tokens for h in want.sched.handles.values()]


@pytest.mark.parametrize("i", range(N_WALKS))
def test_fleet_walk_equals_reference(jref, i):
    """The reference's fleet walk on the port, one seed: invariants hold
    after every transition, and the merged events and digest equal the
    reference walk's of the same seed."""
    from test_fleet import _FleetWalk as JWalk
    seed = _walk_seed(i)
    got = _FleetWalk(np.random.default_rng(seed)).run()
    want = JWalk(np.random.default_rng(seed))
    want.run()
    assert got.fleet.events == want.fleet.events
    assert got.fleet.event_digest() == want.fleet.event_digest()
    assert got.drained == want.drained
    assert (got.fleet.migrate_on_drain, got.fleet.tier is None) == \
        (want.fleet.migrate_on_drain, want.fleet.tier is None)


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_fleet_graph_equals_eager():
    """qwen3-1.7b at full width, 2 layers, codebook, 2 replicas at the
    contended pair on the contended trace, r0 drained at 0.05 s with
    migration (a running request's pages gathered out of r0's pool and
    written into r1's, whose page table a captured step reads; r1 then
    preempts): digest, events, streams and report on the graph route
    equal the eager route's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph route runs only on the card")
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.serving import to_codebook_params
    dev = torch.device("cuda")
    m = tbuild(TCfg.get("qwen3-1.7b").replace(n_layers=2))
    params = m.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    wq = m.cfg.quantized(n_weights=1000).wq
    pq, state = cluster_params(params, wq, init_state(wq), wq.interval)
    cp = to_codebook_params(pq, wq, state)
    trace = contended_trace(1, m.cfg.vocab)
    got = []
    for graphs in (False, True, True):
        engines = []
        for _ in range(2):
            e = TEngine(m, cp, backend="codebook", device=dev,
                        **CONTENDED_ENGINE_KW)
            e._graphs = graphs
            engines.append(e)
        f = Fleet(engines, migrate_on_drain=True)
        rep = f.replay(trace, drain_at=[(0.05, "r0")])
        got.append(_record(f, rep))
        assert rep.preemptions >= 1 and f.n_migrated_pages >= 1
        assert (sum(e.n_replays for e in engines) > 0) == graphs
        del f, engines
    assert got[0] == got[1] == got[2]
