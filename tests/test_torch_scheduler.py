"""The step-level scheduling API (``ServeEngine.sched_*``/``serve_step``),
``serving/scheduler.py`` and ``serving/server.py`` of the port against the
JAX package's, computed live in this process, mirroring
``tests/test_scheduler_sim.py``.

Model: qwen3-1.7b reduced to 2 layers in f32 (k-means |W| = 256), as
``test_torch_spec.py``; params cross through the bridge.

* ``serve_step`` sessions equal ``serve`` (contiguous and paged), and a
  quantum of 3 equals a quantum of 1;
* preempt → swap out → restore: every stream equals the uncontended serve
  and the reference's, on the reference's 7 cases (backend × layout ×
  int8 pages), with the same events;
* ``Server.replay(contended_trace(1, vocab))`` at ``CONTENDED_ENGINE_KW``:
  events, streams, ``report.to_json()`` and the pool's state equal the
  reference's, with at least one preemption; twice on the port alike;
* ``expel``/``adopt`` move requests between two schedulers, a running one
  through its swap blob; streaming callbacks and metrics; trace save/load;
  ``submit`` refuses impossible requests; a telemetry registry is accepted
  and spec sessions are refused; no wall clock under
  ``repro_torch/serving``.

The ``cuda`` test needs the card (``pytest -m cuda``): a contended replay's
streams on the graph route equal the eager route's.  JAX is imported only
through fixtures: the card's machine has none.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import (CONTENDED_ENGINE_KW,  # noqa: E402
                                 NULL_TELEMETRY, AsyncScheduler, Server,
                                 ServerReport, SpecConfig, Telemetry,
                                 VirtualClock, contended_trace, iter_trace,
                                 load_trace, poisson_trace, save_trace)
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving.scheduler import (FINISHED, QUEUED,  # noqa: E402
                                           RUNNING, SWAPPED)
from test_torch_spec import _reference_model, qwen  # noqa: E402,F401

torch.set_num_threads(2)

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14]]
STOPS = [6, 3, 5, 4]


def _engines(m, backend="dense", paged=False, **kw):
    """The reference's engine and the port's of one shape (max_len 48, 2
    slots; paged: page 8)."""
    which = "dense" if backend == "dense" else "index"
    kw.setdefault("max_len", 48)
    kw.setdefault("max_batch", 2)
    if paged:
        kw.setdefault("page_size", 8)
    je = m.Engine(m.model, m.params[which], backend=backend, paged=paged,
                  **kw)
    te = TEngine(m.tmodel, m.tparams[which], backend=backend, paged=paged,
                 device="cpu", **kw)
    return je, te


def _pool_state(pool):
    return (dataclasses.asdict(pool.stats), list(pool.free),
            list(pool.table.items()), pool.reserved_extra)


# --- step-level parity with serve() ------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_serve_step_matches_serve(qwen, paged):
    """An uncontended session equals a batch ``serve`` token for token, on
    the port and against the reference's session; then ``serve`` after
    the session on the same engine gives the same tokens again."""
    from repro.serving import Server as JServer
    je, te = _engines(qwen, paged=paged)
    want = te.serve(PROMPTS, max_new=STOPS)
    assert je.serve(PROMPTS, max_new=STOPS) == want
    srv = Server(te)
    hs = [srv.submit(p, s) for p, s in zip(PROMPTS, STOPS)]
    srv.run_until_idle()
    assert [h.result() for h in hs] == want
    assert srv.sched.n_preemptions == 0
    jsrv = JServer(je)
    jhs = [jsrv.submit(p, s) for p, s in zip(PROMPTS, STOPS)]
    jsrv.run_until_idle()
    assert [h.result() for h in jhs] == want
    assert srv.sched.events == jsrv.sched.events
    if paged:
        assert _pool_state(te.pool) == _pool_state(je.pool)
        assert te.pool.reserved_extra == 0
    assert te.serve(PROMPTS, max_new=STOPS) == want


def test_quantum_does_not_change_tokens(qwen):
    """Quantum 3 gives quantum 1's streams, and the reference's events."""
    from repro.serving import Server as JServer
    je, te = _engines(qwen)
    outs = []
    for q in (1, 3):
        srv = Server(te, quantum=q)
        hs = [srv.submit(p, s) for p, s in zip(PROMPTS, STOPS)]
        srv.run_until_idle()
        outs.append([h.result() for h in hs])
        jsrv = JServer(je, quantum=q)
        for p, s in zip(PROMPTS, STOPS):
            jsrv.submit(p, s)
        jsrv.run_until_idle()
        assert srv.sched.events == jsrv.sched.events
    assert outs[0] == outs[1]


# --- preempt -> swap out -> restore parity -----------------------------------

CASES = [("dense", False, None), ("dense", True, None),
         ("dense", True, "int8"), ("codebook", False, None),
         ("codebook", True, None), ("lut", False, None),
         ("lut", True, None)]


@pytest.mark.parametrize("backend,paged,kv", CASES,
                         ids=[f"{b}-{'paged' if p else 'contig'}"
                              + (f"-{k}" if k else "")
                              for b, p, k in CASES])
def test_preempt_restore_token_parity(qwen, backend, paged, kv):
    """A high-priority late arrival preempts a running victim (slots full;
    paged pools tight): its K/V go to the host blob and back.  Every
    stream equals the uncontended serve's and the reference's; the events
    and (paged) the pool's state equal the reference's."""
    from repro.serving import Server as JServer
    kw = {}
    if paged:
        kw["n_pages"] = 7
    if kv:
        kw["kv_dtype"] = kv
    je, te = _engines(qwen, backend=backend, paged=paged, **kw)
    prompts = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12]]
    stops = [10, 8, 6]
    want = te.serve(prompts, max_new=stops)
    assert je.serve(prompts, max_new=stops) == want
    res = []
    for srv in (Server(te), JServer(je)):
        h0 = srv.submit(prompts[0], stops[0], priority=0, arrival=0.0)
        h1 = srv.submit(prompts[1], stops[1], priority=0, arrival=0.0)
        h2 = srv.submit(prompts[2], stops[2], priority=1, arrival=0.05)
        srv.run_until_idle()
        assert h0.n_preempt + h1.n_preempt >= 1, "no preemption happened"
        assert h2.n_preempt == 0
        assert [h.result() for h in (h0, h1, h2)] == want
        assert max(h0.pages_swapped_out, h1.pages_swapped_out) > 0
        res.append((srv.sched.events, srv.sched.n_pages_swapped_in,
                    [h.pages_swapped_out for h in (h0, h1, h2)]))
    assert res[0] == res[1]
    if paged:
        assert _pool_state(te.pool) == _pool_state(je.pool)


def test_swap_blob_is_the_slots_state(qwen):
    """A swap-out's blob holds the request's K/V verbatim: paged, its
    pages with data gathered from every plane (one
    ``ops.gather_pages_many`` over the layers); contiguous, its rows up to
    ``pos``; swapping it back in on a fresh slot restores them."""
    for paged in (False, True):
        _, te = _engines(qwen, paged=paged, kv_dtype="int8")
        st = te.sched_state()
        te.sched_admit(st, 1, list(range(1, 12)), 9)
        te.serve_step(st, quantum=3)
        pos = int(st.pos[1])
        assert pos == 11 + 3
        if paged:
            pids = st.adm[1].pids[:2]
            want = {k: v[:, pids].clone() for k, v in te.pool.cache.items()}
        else:
            want = {k: v[:, 1, :pos].clone()
                    for k, v in st.loop.cache["kv"].items()}
        blob = te.sched_swap_out(st, 1)
        assert blob.n_pages == -(-pos // te.page_size)
        assert blob.pos == pos and blob.n_gen == 4
        assert not st.live[1]
        for k, v in want.items():
            assert torch.equal(blob.data[k], v), k
        assert te.sched_swap_in(st, 0, blob)
        if paged:
            got = {k: v[:, st.adm[0].pids[:2]]
                   for k, v in te.pool.cache.items()}
        else:
            got = {k: v[:, 0, :pos] for k, v in st.loop.cache["kv"].items()}
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        assert st.out[0, :4].tolist() == blob.out_row.tolist()
        if paged:
            bad = dataclasses.replace(blob, data={
                k: v[:, :, :4] for k, v in blob.data.items()})
            with pytest.raises(ValueError, match="layout"):
                te.sched_swap_in(st, 1, bad)


def test_no_preempt_mode_waits_instead(qwen):
    _, te = _engines(qwen)
    prompts = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12]]
    stops = [10, 8, 6]
    want = te.serve(prompts, max_new=stops)
    srv = Server(te, preempt=False)
    hs = [srv.submit(prompts[0], stops[0], priority=0, arrival=0.0),
          srv.submit(prompts[1], stops[1], priority=0, arrival=0.0),
          srv.submit(prompts[2], stops[2], priority=1, arrival=0.05)]
    srv.run_until_idle()
    assert srv.sched.n_preemptions == 0
    assert [h.result() for h in hs] == want


# --- deterministic trace replay ----------------------------------------------

def _replay(engine, trace, server):
    srv = server(engine)
    rep = srv.replay(trace)
    streams = {h.rid: list(h.tokens) for h in srv.sched.handles.values()}
    return srv.sched.events, streams, rep


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_contended_trace_equals_reference(qwen, kv):
    """Seed 1 on the contended pair: the port's events, streams, report
    and pool state equal the reference's, at least one preemption fires,
    pages move out and back; a second replay on a fresh engine is
    identical; every stream equals the same engine shape's uncontended
    serve of the same requests."""
    from repro.serving import Server as JServer
    trace = contended_trace(1, qwen.cfg.vocab)
    kw = dict(CONTENDED_ENGINE_KW, kv_dtype=kv)

    def engines():
        return (qwen.Engine(qwen.model, qwen.params["dense"], **kw),
                TEngine(qwen.tmodel, qwen.tparams["dense"], device="cpu",
                        **kw))
    je, te = engines()
    ev, st, rep = _replay(te, trace, Server)
    jev, jst, jrep = _replay(je, trace, JServer)
    assert rep.preemptions >= 1, "trace is not contended: weak test"
    assert rep.pages_swapped_out > 0 and rep.pages_swapped_in > 0
    assert ev == jev
    assert st == jst
    assert rep.to_json() == jrep.to_json()
    assert _pool_state(te.pool) == _pool_state(je.pool)
    assert te.pool.reserved_extra == 0
    ev2, st2, rep2 = _replay(engines()[1], trace, Server)
    assert (ev2, st2, rep2.to_json()) == (ev, st, rep.to_json())
    want = te.serve([r["prompt"] for r in trace],
                    max_new=[r["max_new"] for r in trace])
    for rid, r in enumerate(trace):
        assert r["prompt"] + st[rid] == want[rid]


def test_streaming_callbacks_and_metrics(qwen):
    """Tokens stream at nondecreasing virtual times; TTFT/TPOT and SLO
    attainment come from the injected clock."""
    _, te = _engines(qwen)
    got = []
    srv = Server(te)
    h0 = srv.submit(PROMPTS[0], 6, slo_ttft=10.0, slo_tpot=10.0,
                    on_token=lambda h, t, ts: got.append((h.rid, t, ts)))
    h1 = srv.submit(PROMPTS[1], 4, slo_ttft=1e-9,
                    on_token=lambda h, t, ts: got.append((h.rid, t, ts)))
    srv.run_until_idle()
    assert [t for r, t, _ in got if r == h0.rid] == h0.tokens
    assert [t for r, t, _ in got if r == h1.rid] == h1.tokens
    times = [ts for _, _, ts in got]
    assert times == sorted(times)
    for h in (h0, h1):
        assert h.state == FINISHED
        assert h.ttft > 0 and h.tpot > 0
        assert h.first_token_at == h.admitted_at
    assert h0.slo_met() and not h1.slo_met()
    assert ServerReport.build([h0, h1], srv.sched).slo_attainment == 0.5
    h2 = srv.submit(PROMPTS[2], 3)
    assert list(h2.stream()) == h2.tokens and len(h2.tokens) == 3


def test_expel_adopt_rehomes_requests_across_schedulers(qwen):
    """Two paged engines of one shape share a clock: a running request is
    expelled with its swap blob (not counted as a preemption) and adopted
    by the other scheduler, which restores it; a queued one moves with no
    blob.  Every request still finishes with the stream an uncontended
    serve gives."""
    _, ea = _engines(qwen, paged=True)
    _, eb = _engines(qwen, paged=True)
    reqs = [([1] * 10, 6), ([2] * 6, 4), ([3] * 4, 3)]
    want = ea.serve([p for p, _ in reqs], max_new=[s for _, s in reqs])
    clock = VirtualClock()
    a = AsyncScheduler(ea, clock=clock)
    b = AsyncScheduler(eb, clock=clock)
    h_run, h_stay, h_q = (a.submit(p, s) for p, s in reqs)
    a.step()
    assert h_run.state == RUNNING and h_q.state == QUEUED
    hr, blob_r = a.expel(h_run.rid)
    assert hr is h_run and hr.state == SWAPPED and blob_r.n_pages >= 1
    hq, blob_q = a.expel(h_q.rid)
    assert blob_q is None and hq.state == QUEUED
    assert a.n_preemptions == 0
    assert [k for _, k, _ in a.events].count("expel") == 2
    assert b.adopt(hr, blob=blob_r) is h_run and h_run.state == SWAPPED
    b.adopt(hq)
    a.run_until_idle()
    b.run_until_idle()
    for h, w, (p, _) in zip((h_run, h_stay, h_q), want, reqs):
        assert h.state == FINISHED and h.result() == w
    assert b.n_pages_swapped_in >= blob_r.n_pages
    assert ea.pool.reserved_extra == eb.pool.reserved_extra == 0
    with pytest.raises(ValueError, match="already finished"):
        b.expel(h_run.rid)


def test_trace_save_load_roundtrip(qwen, tmp_path):
    """Traces are the reference's, row for row (seeded through numpy), and
    survive the JSON round trip, streamed or whole."""
    from repro.serving import poisson_trace as jtrace
    from repro.serving.server import contended_trace as jcontended
    trace = poisson_trace(3, 5, vocab=100, priorities=(0, 1), slo_ttft=0.25)
    assert trace == jtrace(3, 5, vocab=100, priorities=(0, 1),
                           slo_ttft=0.25)
    assert contended_trace(1, qwen.cfg.vocab) == jcontended(1,
                                                            qwen.cfg.vocab)
    path = str(tmp_path / "trace.json")
    save_trace(path, trace)
    assert load_trace(path) == trace
    assert list(iter_trace(path, chunk=7)) == trace


def test_submit_rejects_impossible_requests(qwen):
    _, te = _engines(qwen)
    srv = Server(te)
    with pytest.raises(ValueError, match="max_len"):
        srv.submit(list(range(1, 47)), 40)
    with pytest.raises(ValueError, match="empty"):
        srv.submit([], 4)
    _, tp = _engines(qwen, paged=True, n_pages=3)
    with pytest.raises(ValueError, match="pages"):
        Server(tp).submit(list(range(1, 20)), 10)


def test_telemetry_accepted_spec_refused(qwen):
    """A registry is accepted by ``Server`` and ``ServeEngine``; the
    scheduler binds it to its clock and attaches the engine, which then
    holds the scheduler's registry.  A speculative engine is still
    refused by ``AsyncScheduler`` and ``sched_state``, as the reference
    refuses it."""
    _, te = _engines(qwen)
    assert te.telemetry is NULL_TELEMETRY and not te.telemetry.enabled
    tel = Telemetry()
    srv = Server(te, telemetry=tel)
    assert srv.telemetry is tel and te.telemetry is tel
    assert tel.clock is srv.clock
    own = Telemetry()
    e2 = TEngine(qwen.tmodel, qwen.tparams["dense"], device="cpu",
                 telemetry=own)
    assert e2.telemetry is own
    Server(e2)
    assert e2.telemetry is NULL_TELEMETRY       # the session's registry
    se = TEngine(qwen.tmodel, qwen.tparams["dense"], device="cpu",
                 spec=SpecConfig(draft="ngram", k=2), telemetry=Telemetry())
    with pytest.raises(NotImplementedError, match="speculative"):
        AsyncScheduler(se)
    with pytest.raises(NotImplementedError, match="speculative"):
        se.sched_state()


def test_no_wall_clock_in_serving():
    """Nothing under the port's ``serving/`` reads the wall clock: time is
    injected.  The scheduler, the server, the telemetry registry, the
    router and the fleet must be among the files scanned."""
    import repro_torch.serving as S
    forbidden = ("import time", "time.time", "from time ", "datetime",
                 "perf_counter", "monotonic(")
    sdir = os.path.dirname(os.path.abspath(S.__file__))
    scanned = []
    for fn in sorted(os.listdir(sdir)):
        if fn.endswith(".py"):
            scanned.append(fn)
            with open(os.path.join(sdir, fn)) as f:
                src = f.read()
            for pat in forbidden:
                assert pat not in src, f"serving/{fn} reads the wall ({pat!r})"
    for must in ("scheduler.py", "server.py", "telemetry.py", "engine.py",
                 "fleet.py", "router.py"):
        assert must in scanned


# --- on the card -------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_contended_replay_graph_equals_eager():
    """qwen3-1.7b at full width, 2 layers, codebook, at the contended
    pair: the replay's events and streams on the graph route (a decode
    step one replay) equal the eager route's, with a preemption."""
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
        e = TEngine(m, cp, backend="codebook", device=dev,
                    **CONTENDED_ENGINE_KW)
        e._graphs = graphs
        ev, streams, rep = _replay(e, trace, Server)
        got.append((ev, streams, rep.to_json()))
        assert rep.preemptions >= 1
        assert (e.n_replays > 0) == graphs
    assert got[0] == got[1] == got[2]
