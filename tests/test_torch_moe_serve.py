"""The ``moe`` family through every serving path of the port's engine,
against the JAX package's engine run live in this process, on the reduced
qwen3-moe-30b-a3b (8 experts, top-2) compressed as the launcher's
``--compress`` does it, and the reduced grok-1-314b (its ``kv_quant``
int8 cache, ``moe_token_chunks=2``).

In a MoE model every row of a forward competes for the experts' capacity,
so what the engine feeds its prompt padding, its chunk tails and its free
or retired slots changes the live requests' tokens.  Besides the tokens,
each test therefore records every model forward of both engines (kind,
token ids, positions, page tables; the reference's through an ordered
``jax.debug.callback`` traced into each jitted forward, which reports the
concrete inputs of every run, loop steps included) and holds the two
sequences equal, forward for forward:

* ``generate`` and ``serve`` with more requests than slots and staggered
  lengths (two serves on one engine: the port's static slots are reused),
  on dense, codebook and lut;
* grok's ``kv_quant`` cache, and paged bf16 and int8 pages with the
  prefix cache (pool statistics equal);
* ``Server.replay(contended_trace(1, vocab))`` with preemptions (bf16 and
  int8 pages), a contiguous ``Server`` session, and a 2-replica ``Fleet``.

Speculative rounds and the numerics probes are in ``test_torch_moe_spec.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving import (CONTENDED_ENGINE_KW, Fleet,  # noqa: E402
                                 Server, contended_trace)
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from test_torch_moe import reference_moe_model  # noqa: E402

torch.set_num_threads(2)

PROMPTS = [[435, 326, 262], [138, 158, 21, 39, 9, 90, 416, 332, 467],
           [258, 310, 497, 373, 324],
           [278, 287, 478, 142, 417, 343, 2, 202, 439, 284, 18, 391],
           [373, 433], [90, 46, 442, 12, 277, 42, 154]]
STOPS = [6, 3, 8, 5, 7, 4]
BACKENDS = ("dense", "codebook", "lut")


@pytest.fixture(scope="module")
def qmoe():
    return reference_moe_model()


@pytest.fixture(scope="module")
def grok():
    m = reference_moe_model("grok-1-314b", moe_token_chunks=2)
    assert m.cfg.kv_quant and m.tmodel.cfg.kv_quant
    return m


# --- recording every forward ---------------------------------------------------

def _host(x) -> list:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.int64).tolist()


def _entry(kind, args):
    """(kind, tokens, positions or the chunk's start/length/write page,
    page table or page row) of one forward."""
    if kind in ("decode", "verify"):
        tokens, cache = args[0], args[1]
        return (_host(tokens), _host(cache["pos"]),
                cache.get("page_table"))
    b = args[0]
    if kind == "prefill":
        return _host(b["tokens"]), _host(b["lengths"]), None
    return (_host(b["tokens"]),
            [_host(b[k]) for k in ("start", "length", "write_pid")],
            b["page_row"])


def _record(log, model_cls, monkeypatch, jax=None):
    """Wrap the model handle's forwards to append (kind, tokens, positions
    or chunk fields, page table) to ``log``.  ``jax``: the handle runs
    under ``jax.jit`` and each entry is appended at run time by an ordered
    ``jax.debug.callback`` with the forward's concrete inputs."""
    def wrap(kind):
        orig = getattr(model_cls, kind)

        def f(self, params, *a, **kw):
            if jax is None:
                toks, pos, table = _entry(kind, a)
                log.append((kind, toks, pos,
                            None if table is None else _host(table)))
            else:
                fields = _jax_fields(kind, a)

                def put(*vals):
                    out = [_host(v) for v in vals]
                    if kind == "prefill_chunk":
                        out = [out[0], out[1:4], out[4]]
                    elif len(out) == 2:
                        out.append(None)
                    log.append((kind, *out))
                jax.debug.callback(put, *fields, ordered=True)
            return orig(self, params, *a, **kw)
        monkeypatch.setattr(model_cls, kind, f)

    for kind in ("prefill", "decode", "verify", "prefill_chunk"):
        wrap(kind)


def _jax_fields(kind, a):
    if kind in ("decode", "verify"):
        cache = a[1]
        return (a[0], cache["pos"]) + (
            (cache["page_table"],) if "page_table" in cache else ())
    b = a[0]
    if kind == "prefill":
        return b["tokens"], b["lengths"]
    return (b["tokens"], b["start"], b["length"], b["write_pid"],
            b["page_row"])


def both(m, jfn, tfn, monkeypatch, record=True, eager=False):
    """(reference output, port output), after holding every forward's
    inputs equal when ``record``.  The reference runs jitted, its
    forwards recorded at run time, or ``eager`` under
    ``jax.disable_jit``."""
    import repro.models.model_zoo as JZ
    import repro_torch.models.model_zoo as TZ

    jlog, tlog = [], []
    with monkeypatch.context() as mp:
        if record:
            _record(jlog, JZ.Model, mp, None if eager else m.jax)
        if eager:
            with m.jax.disable_jit():
                want = jfn()
        else:
            want = jfn()
            m.jax.effects_barrier()
    with monkeypatch.context() as mp:
        _record(tlog, TZ.Model, mp)
        got = tfn()
    if record:
        assert len(tlog) == len(jlog)
        for i, (a, b) in enumerate(zip(jlog, tlog)):
            assert a == b, f"forward {i}: reference {a} port {b}"
    return want, got


def _engines(m, backend, **kw):
    which = "dense" if backend == "dense" else "index"
    return (m.Engine(m.model, m.params[which], backend=backend, **kw),
            TEngine(m.tmodel, m.tparams[which], backend=backend,
                    device="cpu", **kw))


def _rows(out):
    return [list(map(int, r)) for r in out]


def _pool_state(pool):
    return (dataclasses.asdict(pool.stats), list(pool.free),
            list(pool.table.items()), pool.reserved_extra)


# --- generate, serve and the caches ------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_generate_and_serve_equal_reference(qmoe, backend, monkeypatch):
    je, te = _engines(qmoe, backend, max_len=48, max_batch=8)
    want, got = both(qmoe, lambda: _rows(je.generate(PROMPTS[:4], 5)),
                     lambda: _rows(te.generate(PROMPTS[:4], 5)), monkeypatch)
    assert got == want
    je, te = _engines(qmoe, backend, max_len=48, max_batch=2)
    want, got = both(
        qmoe, lambda: [je.serve(PROMPTS, STOPS), je.serve(PROMPTS[:3], 4)],
        lambda: [te.serve(PROMPTS, STOPS), te.serve(PROMPTS[:3], 4)],
        monkeypatch)
    assert got == want


CACHES = {"kv_quant": {}, "paged_bf16": dict(paged=True, page_size=8),
          "paged_int8": dict(paged=True, page_size=8, kv_dtype="int8")}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_caches_equal_reference(qmoe, grok, backend, cache, monkeypatch):
    """grok's int8 contiguous cache; qwen3-moe's page pool in bf16 and
    int8, twice over the same prompts (the second serve hits the prefix
    cache)."""
    m = grok if cache == "kv_quant" else qmoe
    je, te = _engines(m, backend, max_len=48, max_batch=2, **CACHES[cache])
    want, got = both(m, lambda: [je.serve(PROMPTS, STOPS),
                                 je.serve(PROMPTS[::-1], STOPS)],
                     lambda: [te.serve(PROMPTS, STOPS),
                              te.serve(PROMPTS[::-1], STOPS)], monkeypatch)
    assert got == want
    if te.paged:
        assert _pool_state(te.pool) == _pool_state(je.pool)
        assert te.pool.stats.hit_pages > 0


# --- the scheduler, the server and the fleet -------------------------------------

def _replay_record(srv, rep):
    return (srv.sched.events,
            {h.rid: list(h.tokens) for h in srv.sched.handles.values()},
            rep.to_json())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_contended_replay_equals_reference(qmoe, kv, monkeypatch):
    from repro.serving import Server as JServer
    trace = contended_trace(1, qmoe.cfg.vocab)
    je, te = _engines(qmoe, "codebook",
                      **dict(CONTENDED_ENGINE_KW, kv_dtype=kv))

    def run(server, engine):
        srv = server(engine)
        return _replay_record(srv, srv.replay(trace))
    want, got = both(qmoe, lambda: run(JServer, je),
                     lambda: run(Server, te), monkeypatch)
    assert got == want
    assert got[2]["preemptions"] >= 1, "trace is not contended: weak test"
    assert _pool_state(te.pool) == _pool_state(je.pool)


def test_contiguous_session_equals_reference_and_serve(qmoe, monkeypatch):
    """A ``Server`` session on the contiguous cache (the reference's
    session cannot run eagerly: outputs only), equal to ``serve``."""
    from repro.serving import Server as JServer
    je, te = _engines(qmoe, "codebook", max_len=48, max_batch=2)

    def run(server, engine):
        srv = server(engine)
        hs = [srv.submit(p, s) for p, s in zip(PROMPTS, STOPS)]
        srv.run_until_idle()
        return [h.result() for h in hs], srv.sched.events
    want, got = both(qmoe, lambda: run(JServer, je), lambda: run(Server, te),
                     monkeypatch)
    assert got == want
    assert got[0] == te.serve(PROMPTS, STOPS)


def test_two_replica_fleet_equals_reference(qmoe, monkeypatch):
    from repro.serving import Fleet as JFleet
    trace = contended_trace(1, qmoe.cfg.vocab)
    pairs = [_engines(qmoe, "codebook", **CONTENDED_ENGINE_KW)
             for _ in range(2)]

    def run(fleet_cls, side):
        f = fleet_cls({f"r{i}": p[side] for i, p in enumerate(pairs)})
        rep = f.replay(trace)
        return (f.event_digest(), list(f.events),
                {k: list(h.tokens) for k, h in f.handles.items()},
                rep.to_json())
    want, got = both(qmoe, lambda: run(JFleet, 0), lambda: run(Fleet, 1),
                     monkeypatch)
    assert got == want
    assert {len(p[1].pool.free) for p in pairs} \
        == {len(p[0].pool.free) for p in pairs}
