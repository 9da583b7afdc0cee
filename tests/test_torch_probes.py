"""The numerics probes of the port (``repro_torch/kernels/probes.py``,
``repro_torch/serving/probes.py``, ``ServeEngine(probes=True)``) against
the JAX package's, run live in this process (never against
``tests/golden_numerics.json``), mirroring ``tests/test_probes.py``.

* taps on equal inputs: lut saturation against a numpy oracle, and every
  counter of ``tap_matmul``, ``tap_kv`` and ``tap_act`` against the
  reference's probe on the same inputs; the empty state is inert;
* the static index audit (a hand tree, and the compressed model's ids
  against the reference's count), ``summarize``, ``golden_entry`` and
  ``sentinel_check`` (every trip case) equal the reference's;
* the 6 golden scenarios (dense, codebook, lut × contiguous, int8 pages):
  tokens with probes on equal tokens with probes off and the reference's;
  ``backend``, ``tokens``, ``matmul_calls``, ``act_total``, ``page_oob``
  and the ``widx_*`` counts exact; ``acc_max`` within rtol 1e-3 a layer;
  saturation and KV error within the reference's own sentinel slack
  (``sentinel_check(port, golden_entry(reference))`` is empty); the
  reference's internal checks hold on the port's numerics;
* the working point reduced (``act_levels`` 32, codebook and lut): the
  relu6 rails saturate, the codebook FFN takes the unfused launches while
  probes are on, tokens equal probes off and the reference's (run under
  ``jax.disable_jit``, as ``test_torch_quantized_serve.py`` explains);
* telemetry: an instrumented ``Server.replay(contended_trace(1))`` gives a
  ``numerics`` section byte-equal to the reference's (dense, codebook;
  lut within the bounds above), its counter tracks, two replays byte-equal,
  and a 2-replica fleet's ``r0.numerics``/``r1.numerics`` equal the
  reference fleet's;
* state discipline: the counters never enter the pool, a loop state's
  cache or a swap blob of a preempting replay, whose tokens equal probes
  off; ``reset_probes`` zeroes the same buffers, and a reset engine
  measures what a fresh one does; probes with ``spec`` are refused.

Model: ``tests/test_probes.py``'s reduced 2-layer qwen3 (f32, k-means |W|
= 256, int8 ids), params carried by the bridge.  The ``cuda`` test needs
the card (``pytest -m cuda``): a reduced probes engine's numerics are
byte-equal on the graph route and the eager route.  JAX is imported only
through fixtures and inside tests: the card's machine has none.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.kernels import probes as kprobes  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import (CONTENDED_ENGINE_KW, Fleet,  # noqa: E402
                                 Server, SpecConfig, Telemetry,
                                 contended_trace)
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving import probes as nprobes  # noqa: E402

torch.set_num_threads(2)

PROMPTS = nprobes.GOLDEN_PROMPTS
MAX_NEW = nprobes.GOLDEN_MAX_NEW
ACC_RTOL = 1e-3
EXACT = ("backend", "tokens", "matmul_calls", "act_total", "page_oob",
         "widx_neg", "widx_oob", "widx_total")
TRACKS = {"numerics.sat_rate_max", "numerics.headroom_bits_min",
          "numerics.kv_err_max"}


def _cfg(mod, **kw):
    return mod.get("qwen3-1.7b").reduced().replace(n_layers=2,
                                                   dtype="float32", **kw)


@pytest.fixture(scope="module")
def zoo():
    """``tests/test_probes.py``'s zoo in both packages: the reference's
    model, dense and index-form params; the port's model and the same
    params through the bridge; and both models at ``act_levels`` 32."""
    jax = pytest.importorskip("jax")
    import repro.configs as C
    from repro.core.quantizer import WeightQuantConfig, cluster_params
    from repro.core.quantizer import init_state as quant_init_state
    from repro.models.model_zoo import build
    from repro.serving import to_codebook_params
    from repro_torch.bridge import from_jax_params

    model = build(_cfg(C))
    params = model.init(jax.random.PRNGKey(0))
    wq = WeightQuantConfig(num_weights=256, method="kmeans")
    pq, st = cluster_params(params, wq, quant_init_state(wq), 200,
                            jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, wq, st, min_size=256)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return SimpleNamespace(
        jax=jax, model=model, model32=build(_cfg(C, act_levels=32)),
        params={"dense": params, "index": cp},
        tmodel=tbuild(_cfg(TCfg)), tmodel32=tbuild(_cfg(TCfg, act_levels=32)),
        tparams={"dense": from_jax_params(np_tree(params), "cpu"),
                 "index": from_jax_params(np_tree(cp), "cpu")})


@pytest.fixture(scope="module")
def jx():
    """The reference's probes modules and engine stack."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import repro.serving as JS
    from repro.kernels import dispatch as jdispatch
    from repro.kernels import probes as jkprobes
    from repro.models import attention as jattention
    from repro.models import layers as jlayers
    from repro.serving import probes as jnprobes
    return SimpleNamespace(jax=jax, jnp=jnp, dispatch=jdispatch,
                           kprobes=jkprobes, nprobes=jnprobes, attention=jattention,
                           layers=jlayers, Engine=JS.ServeEngine,
                           Server=JS.Server, Telemetry=JS.Telemetry,
                           Fleet=JS.Fleet)


def _params(z, be, port=True):
    key = "dense" if be == "dense" else "index"
    return (z.tparams if port else z.params)[key]


@pytest.fixture(scope="module")
def ref_runs(zoo, jx):
    """The reference's golden scenarios, served with probes on: tokens and
    numerics per scenario."""
    toks = {}
    nums = {}
    for name, (be, kw) in nprobes.GOLDEN_SCENARIOS.items():
        e = jx.Engine(zoo.model, _params(zoo, be, port=False), max_len=48,
                      max_batch=2, backend=be, probes=True, **kw)
        toks[name] = e.serve(PROMPTS, max_new=MAX_NEW)
        nums[name] = e.numerics()
    return toks, nums


# --- taps on equal inputs ----------------------------------------------------

def _lut_case(seed=0):
    """(x (B, K) beyond the grid, w_idx, codebook, spec args) of the
    reference's oracle test."""
    rng = np.random.default_rng(seed)
    n_w, K, N, B = 16, 32, 8, 4
    cb = rng.normal(scale=0.1, size=n_w).astype(np.float32)
    w_idx = rng.integers(0, n_w, (K, N)).astype(np.int32)
    x = rng.uniform(-4.0, 4.0, (B, K)).astype(np.float32)
    return x, w_idx, cb, dict(fan_in=K, levels=64, a_range=(-2.0, 2.0))


def _host(state) -> dict:
    return {k: np.asarray(v, np.float32).tolist() for k, v in state.items()}


def test_saturation_tap_matches_oracle_and_reference(jx):
    """A lut ``backend_matmul`` driven outside the grid, under one frame:
    ``act_sat`` equals the numpy oracle's clip count, and every counter
    equals the reference probe's on the same inputs (its table built
    eagerly, as the port builds it, and the call run op by op)."""
    x, w_idx, cb, sk = _lut_case()
    spec = dispatch.make_lut_spec(cb, **sk)
    bk = dispatch.BackendSpec("lut", spec)
    table = dispatch.build_lut_table(torch.from_numpy(cb), spec)
    ps = kprobes.init_state(1, "cpu")
    with kprobes.layer(ps, 0):
        dispatch.backend_matmul(torch.from_numpy(x), torch.from_numpy(w_idx),
                                torch.from_numpy(cb), bk, table=table)
    got = _host(ps)
    want_sat = int(((x < spec.a_min) | (x > spec.a_max)).sum())
    assert want_sat > 0, "seed produced no out-of-grid inputs — weak test"
    assert got["act_sat"] == [want_sat]
    assert got["act_total"] == [float(x.size)]
    assert got["matmul_calls"] == [1.0]
    assert got["acc_max"][0] > 0.0

    jspec = jx.dispatch.make_lut_spec(jx.jnp.asarray(cb), **sk)
    assert (jspec.a_min, jspec.a_max, jspec.levels, jspec.s) == \
        (spec.a_min, spec.a_max, spec.levels, spec.s)
    jtable = jx.dispatch.build_lut_table(jx.jnp.asarray(cb), jspec)
    np.testing.assert_array_equal(np.asarray(jtable), table.numpy())
    with jx.dispatch.use_backend("lut", jspec), jx.jax.disable_jit():
        with jx.kprobes.layer(jx.kprobes.init_state(1), 0) as pb:
            jx.dispatch.backend_matmul(jx.jnp.asarray(x),
                                       jx.jnp.asarray(w_idx),
                                       jx.jnp.asarray(cb), kind="row",
                                       table=jtable)
    assert got == _host(pb.state)


def test_kv_and_act_taps_equal_reference(jx):
    """``quantize_kv``'s tap (through each package's own ``quantize_kv``,
    which store bit-equal pairs) and ``tap_act`` on the same inputs:
    ``kv_err_max``, ``kv_err_cnt``, ``act_sat`` and ``act_total`` exact,
    ``kv_err_sum`` within f32 summation order."""
    from repro_torch.models import attention as A
    rng = np.random.default_rng(3)
    t = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    a = rng.normal(scale=4.0, size=(3, 96)).astype(np.float32)
    ps = kprobes.init_state(1, "cpu")
    with kprobes.layer(ps, 0):
        q, sc = A.quantize_kv(torch.from_numpy(t))
        kprobes.tap_act(torch.from_numpy(a), 0.0, 6.0)
    with jx.kprobes.layer(jx.kprobes.init_state(1), 0) as pb:
        jq, jsc = jx.attention.quantize_kv(jx.jnp.asarray(t))
        jx.kprobes.tap_act(jx.jnp.asarray(a), 0.0, 6.0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sc.to(torch.float32).numpy(),
                                  np.asarray(jsc, np.float32))
    got, want = _host(ps), _host(pb.state)
    assert want["kv_err_max"][0] > 0.0
    assert want["act_sat"][0] == float(((a < 0) | (a > 6)).sum()) > 0
    np.testing.assert_allclose(got["kv_err_sum"], want["kv_err_sum"],
                               rtol=1e-6)
    for k in ("kv_err_sum",):
        got.pop(k), want.pop(k)
    assert got == want


def test_frame_folds_in_place_like_reference(jx):
    """Several records of one name in one frame, over two frames of one
    layer and one of another: sums add, maxes keep the high-water mark,
    Python numbers fold in f32, and the buffers are the same objects
    after the merges."""
    vals = [0.1, 0.7, 0.3]
    ps = kprobes.init_state(2, "cpu")
    ptrs = {k: v.data_ptr() for k, v in ps.items()}
    jps = jx.kprobes.init_state(2)
    for l in (0, 0, 1):
        with kprobes.layer(ps, l):
            for v in vals:
                kprobes.record("kv_err_max", torch.tensor(v * (l + 1)))
                kprobes.record("kv_err_sum", torch.tensor(v))
                kprobes.record("act_total", v)
        with jx.kprobes.layer(jps, l) as pb:
            for v in vals:
                jx.kprobes.record("kv_err_max", jx.jnp.asarray(v * (l + 1)))
                jx.kprobes.record("kv_err_sum", jx.jnp.asarray(v))
                jx.kprobes.record("act_total", v)
        jps = pb.state
    kprobes.bump(ps, "tokens", 3)
    kprobes.bump(ps, "page_oob", torch.tensor(2))
    jps = jx.kprobes.bump(jps, "tokens", 3)
    jps = jx.kprobes.bump(jps, "page_oob", jx.jnp.asarray(2))
    assert _host(ps) == _host(jps)
    assert {k: v.data_ptr() for k, v in ps.items()} == ptrs


def test_empty_state_is_inert(zoo):
    """The off state records nothing and allocates nothing; a probes-off
    engine holds no probe buffer and reports an empty section."""
    with kprobes.layer({}, 0) as st:
        assert not kprobes.active()
        kprobes.record("act_sat", 1.0)      # dropped: no frame open
    assert st == {}
    assert kprobes.bump({}, "tokens", 1.0) == {}
    assert nprobes.summarize({}) == {}
    kprobes.tap_act(torch.zeros((4,)), 0.0, 6.0)   # no frame: no-op
    st = kprobes.init_state(2, "cpu")
    assert set(st) == set(kprobes.PER_LAYER) | set(kprobes.SCALARS)
    assert len({v.data_ptr() for v in st.values()}) == len(st)
    assert all(float(v.sum()) == 0.0 for v in st.values())
    e = TEngine(zoo.tmodel, zoo.tparams["index"], backend="codebook",
                max_len=48, max_batch=2, device="cpu")
    e.serve(PROMPTS, max_new=MAX_NEW)
    assert e._ps == {} and e._probe_audit == {} and e.numerics() == {}
    e.reset_probes()
    assert e._ps == {}


# --- audit and policy --------------------------------------------------------

def test_static_index_audit_equals_reference(zoo, jx):
    """The reference's hand tree (−1 wraps into range; 9 and −12 stay out)
    and the compressed model's ids: the port's audit equals the
    reference's, computed live (196,101 negative int8 ids, none out of
    range, of 393,216)."""
    ids = [[0, -1], [-12, 9]]
    tree = {"blk": {"w_idx": torch.tensor(ids, dtype=torch.int32),
                    "codebook": torch.zeros((8,))},
            "float_leaf": torch.zeros((3,))}
    jtree = {"blk": {"w_idx": jx.jnp.asarray(ids, jx.jnp.int32),
                     "codebook": jx.jnp.zeros((8,))},
             "float_leaf": jx.jnp.zeros((3,))}
    assert nprobes.static_index_audit(tree) == \
        jx.nprobes.static_index_audit(jtree) == \
        {"widx_neg": 2, "widx_oob": 2, "widx_total": 4}
    int8 = {"w_idx": torch.tensor([[-128, 127, -3]], dtype=torch.int8),
            "codebook": torch.zeros((100,))}
    jint8 = {"w_idx": jx.jnp.asarray([[-128, 127, -3]], jx.jnp.int8),
             "codebook": jx.jnp.zeros((100,))}
    assert nprobes.static_index_audit(int8) == \
        jx.nprobes.static_index_audit(jint8)
    assert nprobes.static_index_audit({"w": torch.zeros((2, 2))}) == \
        {"widx_neg": 0, "widx_oob": 0, "widx_total": 0}
    got = nprobes.static_index_audit(zoo.tparams["index"])
    assert got == jx.nprobes.static_index_audit(zoo.params["index"])
    assert got == {"widx_neg": 196101, "widx_oob": 0, "widx_total": 393216}
    lut = TEngine(zoo.tmodel, zoo.tparams["index"], backend="lut",
                  probes=True, max_len=48, device="cpu")
    assert lut._probe_audit == got      # lut tables are no index sites


def _raw_state(seed: int, L: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    st = {k: rng.integers(0, 50, L).astype(np.float32)
          for k in kprobes.PER_LAYER}
    st["act_total"] += 100.0
    st["acc_max"] = np.asarray([0.0, 1182106.0, 3e9][:L], np.float32)
    st["kv_err_max"] = rng.random(L).astype(np.float32)
    st["kv_err_sum"] = rng.random(L).astype(np.float32) * 7
    st["kv_err_cnt"][0] = 0.0
    st.update(page_oob=np.float32(0.0), tokens=np.float32(29.0))
    return st


@pytest.mark.parametrize("seed", [0, 1])
def test_summary_and_sentinel_policy_equal_reference(jx, seed):
    """``summarize`` on equal raw counters (a layer that never moved, one
    past int32: negative headroom), ``golden_entry`` and
    ``sentinel_check`` on its own entry, on none, on an empty snapshot and
    on every trip case of ``test_sentinel_bounds_policy``: equal to the
    reference's, messages included."""
    raw = _raw_state(seed)
    audit = {"widx_neg": 5, "widx_oob": 0, "widx_total": 40}
    got = nprobes.summarize({k: torch.from_numpy(np.asarray(v))
                             for k, v in raw.items()}, audit=audit,
                            backend="lut")
    want = jx.nprobes.summarize({k: jx.jnp.asarray(v)
                                 for k, v in raw.items()}, audit=audit,
                                backend="lut")
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["headroom_bits"][0] == nprobes.FULL_HEADROOM_BITS
    assert got["headroom_bits"][2] < 0.0
    num = {"sat_rate": [0.01, 0.0], "headroom_bits": [5.0, 8.0],
           "kv_err_max": [0.01, 0.0], "widx_neg": 0, "widx_oob": 0,
           "page_oob": 0.0, "tokens": 10.0}
    g = nprobes.golden_entry(num)
    assert g == jx.nprobes.golden_entry(num)
    assert nprobes.sentinel_check(num, g) == []
    trips = {
        "headroom": dict(num, headroom_bits=[-0.5, 8.0]),
        "sat_rate": dict(num, sat_rate=[0.2, 0.0]),
        "page_oob": dict(num, page_oob=2.0),
        "widx_oob": dict(num, widx_oob=3),
        "kv_err_max": dict(num, kv_err_max=[0.5, 0.0]),
        "drop": dict(num, headroom_bits=[3.5, 8.0]),
    }
    for key, bad in trips.items():
        fails = nprobes.sentinel_check(bad, g)
        assert fails == jx.nprobes.sentinel_check(bad, g), key
        assert any(key.replace("drop", "headroom") in f for f in fails)
    for num_, g_ in ((num, None), ({}, g), (got, nprobes.golden_entry(got))):
        assert nprobes.sentinel_check(num_, g_) == \
            jx.nprobes.sentinel_check(num_, g_)
    for name in ("SAT_RATE_SLACK", "SAT_RATE_EPS", "KV_ERR_SLACK",
                 "KV_ERR_EPS", "HEADROOM_DROP_BITS", "INT32_MAX",
                 "FULL_HEADROOM_BITS", "GOLDEN_PROMPTS", "GOLDEN_MAX_NEW",
                 "GOLDEN_SCENARIOS"):
        assert getattr(nprobes, name) == getattr(jx.nprobes, name), name


# --- the golden scenarios ----------------------------------------------------

@pytest.fixture(scope="module")
def port_runs(zoo):
    """The port's golden scenarios (``run_golden_scenarios``) with probes
    on and off: (tokens on, tokens off, numerics)."""
    on, off = {}, {}
    args = (zoo.tmodel, zoo.tparams["dense"], zoo.tparams["index"])
    nums = nprobes.run_golden_scenarios(*args, device="cpu", tokens=on)
    assert nprobes.run_golden_scenarios(*args, device="cpu", probes=False,
                                        tokens=off) == \
        {name: {} for name in nprobes.GOLDEN_SCENARIOS}
    return on, off, nums


def _internal_checks(num: dict, be: str, mode: str) -> None:
    """``tests/test_probes.py::test_probes_token_identity``'s checks on
    one scenario's numerics."""
    assert num["backend"] == be
    assert num["tokens"] > 0.0
    assert num["page_oob"] == 0.0
    if be == "dense":
        assert all(c == 0.0 for c in num["matmul_calls"])
    else:
        assert all(c > 0.0 for c in num["matmul_calls"])
        assert len(set(num["matmul_calls"])) == 1
    if be == "lut":
        assert all(h > 0.0 for h in num["headroom_bits"]), num
        assert all(a > 0.0 for a in num["acc_max"]), num
        assert all(t > 0.0 for t in num["act_total"])
    if mode == "paged":
        assert max(num["kv_err_max"]) > 0.0
        assert all(0.0 <= m <= x or x == 0.0 for m, x in
                   zip(num["kv_err_mean"], num["kv_err_max"]))
    else:
        assert max(num["kv_err_max"]) == 0.0
    if be != "dense":
        assert num["widx_total"] > 0 and num["widx_oob"] == 0


def _agree(got: dict, want: dict) -> None:
    """The port's numerics against the reference's: structural counts
    exact, ``acc_max`` within ``ACC_RTOL`` a layer, saturation and KV
    error within the reference's sentinel slack."""
    assert set(got) == set(want)
    for k in EXACT:
        assert got[k] == want[k], (k, got[k], want[k])
    np.testing.assert_allclose(got["acc_max"], want["acc_max"],
                               rtol=ACC_RTOL, atol=0)
    assert nprobes.sentinel_check(got, nprobes.golden_entry(want)) == []


@pytest.mark.parametrize("name", list(nprobes.GOLDEN_SCENARIOS))
def test_golden_scenario_equals_reference(port_runs, ref_runs, name):
    on, off, nums = port_runs
    jtoks, jnums = ref_runs
    assert on[name] == off[name], f"{name}: probes changed the tokens"
    assert on[name] == jtoks[name]
    be, mode = name.split("/")
    _internal_checks(nums[name], be, mode)
    _agree(nums[name], jnums[name])


# --- the working point, reduced --------------------------------------------------

def _spy(monkeypatch, module, name) -> list:
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("be", ["codebook", "lut"])
def test_working_point_saturates_and_takes_unfused_ffn(zoo, jx, be,
                                                       monkeypatch):
    """``act_levels`` 32 on the contiguous cache: relu6 pins pre-
    activations at its rails (``act_sat`` > 0, against the reference as
    above); with probes on the codebook FFN makes two ``codebook_matmul``
    calls and no ``codebook_swiglu`` call a layer a forward, with them
    off the gated launch; tokens equal probes off and the reference's
    (run op by op)."""
    kw = dict(max_len=48, max_batch=2, backend=be, device="cpu")
    p = zoo.tparams["index"]
    L_ = zoo.tmodel32.cfg.n_layers
    runs = {}
    for probes in (False, True):
        mm = _spy(monkeypatch, ops, "codebook_matmul")
        gated = _spy(monkeypatch, ops, "codebook_swiglu")
        e = TEngine(zoo.tmodel32, p, probes=probes, **kw)
        runs[probes] = (e.serve(PROMPTS, max_new=MAX_NEW), e.numerics())
        fwd = e.n_forwards
        if be == "codebook":
            assert (len(mm), len(gated)) == (
                (7 * L_ * fwd, 0) if probes else (5 * L_ * fwd, L_ * fwd))
        monkeypatch.undo()
    (off, _), (on, num) = runs[False], runs[True]
    assert on == off
    with jx.jax.disable_jit():
        je = jx.Engine(zoo.model32, zoo.params["index"], max_len=48,
                       max_batch=2, backend=be, probes=True)
        want = je.serve(PROMPTS, max_new=MAX_NEW)
        jnum = je.numerics()
    assert on == want
    assert min(num["act_sat"]) > 0.0 and max(num["sat_rate"]) > 0.0
    _agree(num, jnum)
    _internal_checks(num, be, "contig")


# --- telemetry -----------------------------------------------------------------

def _replay(engine, server, telemetry, trace):
    tel = telemetry()
    srv = server(engine, telemetry=tel)
    srv.replay(trace)
    snap = json.loads(tel.snapshot_json())
    tracks = {e["name"] for e in tel.event_log() if e["ph"] == "C"}
    streams = {h.rid: list(h.tokens) for h in srv.sched.handles.values()}
    return snap, tracks, streams


def _section(snap: dict) -> bytes:
    return json.dumps(snap["numerics"], sort_keys=True).encode()


@pytest.mark.parametrize("be", ["dense", "codebook", "lut"])
def test_replay_numerics_equal_reference(zoo, jx, be):
    """An instrumented ``Server.replay(contended_trace(1, vocab))`` at
    ``CONTENDED_ENGINE_KW`` with probes: the ``numerics`` section equals
    the reference's byte for byte on dense and codebook (every field is
    structural there), within the bounds above on lut; the counter tracks
    are sampled; two port replays are byte-equal."""
    trace = contended_trace(1, zoo.model.cfg.vocab)
    kw = dict(CONTENDED_ENGINE_KW, backend=be, probes=True)
    got = [_replay(TEngine(zoo.tmodel, _params(zoo, be), device="cpu", **kw),
                   Server, Telemetry, trace) for _ in range(2)]
    snap, tracks, _ = got[0]
    want, jtracks, _ = _replay(
        jx.Engine(zoo.model, _params(zoo, be, port=False), **kw),
        jx.Server, jx.Telemetry, trace)
    assert _section(snap) == _section(got[1][0])
    assert snap["numerics"]["tokens"] > 0.0
    assert TRACKS <= tracks and TRACKS <= jtracks
    if be == "lut":
        _agree(snap["numerics"], want["numerics"])
    else:
        assert _section(snap) == _section(want)


def test_fleet_numerics_equal_reference(zoo, jx):
    """A 2-replica fleet of codebook probe engines replaying the contended
    trace with one registry: ``r0.numerics`` and ``r1.numerics`` equal the
    reference fleet's byte for byte."""
    trace = contended_trace(1, zoo.model.cfg.vocab)
    kw = dict(CONTENDED_ENGINE_KW, backend="codebook", probes=True)
    tel, jtel = Telemetry(), jx.Telemetry()
    Fleet({r: TEngine(zoo.tmodel, zoo.tparams["index"], device="cpu", **kw)
           for r in ("r0", "r1")}, telemetry=tel).replay(trace)
    jx.Fleet({r: jx.Engine(zoo.model, zoo.params["index"], **kw)
              for r in ("r0", "r1")}, telemetry=jtel).replay(trace)
    snap, jsnap = json.loads(tel.snapshot_json()), \
        json.loads(jtel.snapshot_json())
    for r in ("r0", "r1"):
        key = f"{r}.numerics"
        assert key in snap and snap[key]["tokens"] > 0.0
        assert json.dumps(snap[key], sort_keys=True) == \
            json.dumps(jsnap[key], sort_keys=True)


# --- state discipline --------------------------------------------------------------

def test_counters_stay_out_of_swapped_and_pooled_state(zoo):
    """A preempting replay with probes (int8 pages, lut): no probe key in
    the pool's cache, any loop state's cache or any swap blob, the streams
    equal probes off, and the probe buffers are the ones made at set-up."""
    trace = contended_trace(1, zoo.model.cfg.vocab)
    kw = dict(CONTENDED_ENGINE_KW, backend="lut", kv_dtype="int8",
              device="cpu")
    off = _replay(TEngine(zoo.tmodel, zoo.tparams["index"], **kw), Server,
                  Telemetry, trace)[2]
    e = TEngine(zoo.tmodel, zoo.tparams["index"], probes=True, **kw)
    ptrs = {k: v.data_ptr() for k, v in e._ps.items()}
    blobs = []
    swap_out = e.sched_swap_out

    def keep(*a):
        blobs.append(swap_out(*a))
        return blobs[-1]
    e.sched_swap_out = keep
    srv = Server(e)
    rep = srv.replay(trace)
    streams = {h.rid: list(h.tokens) for h in srv.sched.handles.values()}
    assert rep.preemptions >= 1 and blobs
    assert streams == off
    assert "probes" not in e.pool.cache
    for st in e._slot_sets.values():
        assert "probes" not in st.cache
    for b in blobs:
        assert set(b.data) == set(e.pool.cache)
    assert {k: v.data_ptr() for k, v in e._ps.items()} == ptrs
    assert e.numerics()["tokens"] > 0.0


@pytest.mark.parametrize("paged", [False, True])
def test_reset_keeps_buffers_and_equals_a_fresh_engine(zoo, paged):
    """``reset_probes`` zeroes each buffer in place (same tensor, same
    storage); serving after it measures exactly what a fresh engine
    does."""
    kw = dict(max_len=48, max_batch=2, backend="lut", probes=True,
              device="cpu")
    if paged:
        kw.update(paged=True, page_size=8, kv_dtype="int8",
                  prefix_cache=False)
    e = TEngine(zoo.tmodel, zoo.tparams["index"], **kw)
    bufs = dict(e._ps)
    ptrs = {k: v.data_ptr() for k, v in bufs.items()}
    e.serve(PROMPTS, max_new=MAX_NEW)
    first = e.numerics()
    e.serve(PROMPTS, max_new=MAX_NEW)
    assert e.numerics()["tokens"] == 2 * first["tokens"]
    e.reset_probes()
    assert all(e._ps[k] is bufs[k] for k in bufs)
    assert {k: v.data_ptr() for k, v in e._ps.items()} == ptrs
    assert all(float(v.abs().sum()) == 0.0 for v in e._ps.values())
    e.serve(PROMPTS, max_new=MAX_NEW)
    fresh = TEngine(zoo.tmodel, zoo.tparams["index"], **kw)
    fresh.serve(PROMPTS, max_new=MAX_NEW)
    assert json.dumps(e.numerics(), sort_keys=True) == \
        json.dumps(fresh.numerics(), sort_keys=True) == \
        json.dumps(first, sort_keys=True)


def test_generate_and_step_api_are_probed(zoo, jx):
    """``generate`` and the step API (``sched_admit``, ``serve_step``) are
    instrumented as the reference's: the same numerics."""
    kw = dict(max_len=48, max_batch=3, backend="codebook", probes=True)
    e = TEngine(zoo.tmodel, zoo.tparams["index"], device="cpu", **kw)
    je = jx.Engine(zoo.model, zoo.params["index"], **kw)
    assert e.generate(PROMPTS, max_new=4) == je.generate(PROMPTS, max_new=4)
    assert e.numerics() == je.numerics()
    for eng in (e, je):
        st = eng.sched_state()
        for slot, p in enumerate(PROMPTS):
            eng.sched_admit(st, slot, p, 5)
        for _ in range(2):
            eng.serve_step(st, 2)
    assert e.numerics() == je.numerics()
    assert e.numerics()["tokens"] > 0.0


def test_probes_with_spec_engine_raises(zoo):
    with pytest.raises(NotImplementedError, match="probes"):
        TEngine(zoo.tmodel, zoo.tparams["dense"], max_len=48, max_batch=2,
                probes=True, spec=SpecConfig(draft="ngram", k=3),
                device="cpu")


# --- on the card -------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_probe_numerics_graph_equals_eager():
    """The reduced 2-layer qwen3 (f32, |W| 256) on the card, lut with int8
    pages and codebook on the contiguous cache: ``numerics()`` after a
    serve on the graph route (a decode step one replay, the probe updates
    inside it) is byte-equal to the same serve's on the eager route, and
    the tokens are equal."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the graph route runs only on the card")
    from repro_torch.core.quantizer import (WeightQuantConfig,
                                            cluster_params, init_state)
    from repro_torch.serving import to_codebook_params
    dev = torch.device("cuda")
    m = tbuild(_cfg(TCfg))
    params = m.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    wq = WeightQuantConfig(num_weights=256)
    pq, state = cluster_params(params, wq, init_state(wq), wq.interval)
    cp = to_codebook_params(pq, wq, state, min_size=256)
    for kw in (dict(backend="lut", paged=True, page_size=8,
                    kv_dtype="int8", prefix_cache=False),
               dict(backend="codebook")):
        got = []
        for graphs in (True, False):
            e = TEngine(m, cp, max_len=48, max_batch=2, probes=True,
                        device=dev, **kw)
            e._graphs = graphs
            toks = e.serve(PROMPTS, max_new=MAX_NEW)
            assert (e.n_replays > 0) == graphs
            got.append((toks, json.dumps(e.numerics(), sort_keys=True)))
        assert got[0] == got[1], kw
