"""Tensor-parallel serving of the port (``ServeEngine(mesh=)``: the sharded
dispatch of ``kernels/dispatch.py``, the sequence-sharded flash-decode join
of ``models/attention.py``, ``launch/mesh.py`` and ``launch/serve.py
--tp``) on gloo ranks on the CPU, held against the port's mesh-less engine
and the reference's mesh-less ``ServeEngine`` on the same params.

One module-scoped spawn of 2 ranks (``run_ranks``: a ``file://``
rendezvous under pytest's temporary directory) serves a tiny dense model
(qwen3 reduced to 2 layers, d 64, 4 heads, kv 2, ff 128, f32, k-means |W|
256) through every case: dense, codebook and lut on the contiguous cache,
plain and n-gram speculative, codebook and lut at act_levels 32 (the
quantized FFN activation on the column shards), and dense and codebook
with the int8 cache (``kv_quant``); tokens must equal both mesh-less
engines exactly, and the
ranks each other.  A spawn of 4 ranks serves codebook and lut plain.  The
ranks also return: the lut ``w2`` row product's int32 accumulator after
its psum (the twin of the reference's ``lut_acc_psum_case``), the route
each block matmul took, the largest payload handed to a collective in a
decode and a verify step (the twin of ``collective_bounds``), and one
layer's joined decode and verify outputs, held to the reference's
mesh-less ``attn_decode_cached``/``attn_verify_cached`` within 1e-5.

In bf16 (the port's own tiny model, seeded) the ranks' decision records
are held bit-equal to ``chip_smoke.py``'s witness, the mesh-less engine
computing as the two ranks do in one process.

JAX is imported in the fixtures only: the ranks import this module to
find their function, and the ``cuda`` test at the end runs on the card.
"""

import contextlib
import functools
import importlib.util
import io
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import serve as TL  # noqa: E402
from repro_torch.launch.mesh import (FileFunction, Mesh,  # noqa: E402
                                     make_local_mesh, run_ranks)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model_zoo import build as tbuild  # noqa: E402
from repro_torch.serving import ServeEngine as TEngine  # noqa: E402
from repro_torch.serving import SpecConfig as TSpec  # noqa: E402

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14]]
MAX_NEW = 6
MAX_LEN = 64
K = 3                                  # n-gram draft tokens a round
CASES = ["dense/plain", "dense/spec", "codebook/plain", "codebook/spec",
         "lut/plain", "lut/spec", "dense-int8/plain", "codebook-a32/plain",
         "lut-a32/plain", "codebook-int8/plain"]
TP4_CASES = ["codebook/plain", "lut/plain"]
# bf16 cases held to chip_smoke.py's witness (``tp_one_process``)
BF16_CASES = ["dense-int8/plain", "codebook/spec", "lut-a32/plain"]
BYTES_B, BYTES_S, BYTES_K1 = 4, 256, 4   # the collective-bound step shape


def tiny_cfg(cfg):
    return cfg.reduced().replace(n_layers=2, d_model=64, n_kv=2, d_ff=128,
                                 head_dim=16, dtype="float32")


def _case(case: str):
    """(backend, act_levels, kv_quant, spec) of a case name."""
    be, sp = case.split("/")
    name, *mods = be.split("-")
    return name, 32 if "a32" in mods else 0, "int8" in mods, sp == "spec"


def _port_tokens(trees, mesh, cases) -> dict:
    base = tiny_cfg(TC.get("qwen3-1.7b"))
    out = {}
    for case in cases:
        be, levels, kvq, spec = _case(case)
        e = TEngine(tbuild(base.replace(kv_quant=kvq, act_levels=levels)),
                    trees["p"] if be == "dense" else trees["cp"],
                    max_len=MAX_LEN, max_batch=2, backend=be, device="cpu",
                    spec=TSpec(draft="ngram", k=K) if spec else None,
                    mesh=mesh)
        out[case] = e.serve(PROMPTS, max_new=MAX_NEW)
    return out


# --- what a rank runs ----------------------------------------------------------

def _w2_site(trees):
    site = trees["cp"]["blocks"]["mlp"]["w2"]
    w_idx, book = site["w_idx"][0], site["codebook"][0]     # (128, 64)
    spec = dispatch.make_lut_spec(book.numpy(), fan_in=w_idx.shape[0])
    x2 = torch.from_numpy(
        (np.random.default_rng(42).standard_normal((8, w_idx.shape[0]))
         * 2.0).astype(np.float32))
    return w_idx, book, spec, dispatch.build_lut_table(book, spec), x2


def _lut_acc_case(trees, mesh) -> dict:
    """The w2 row product's int32 accumulator summed over the ranks, and
    ``backend_matmul``'s decoded row route, on this rank's K-slice."""
    from repro_torch.distributed import collectives

    w_idx, book, spec, table, x2 = _w2_site(trees)
    k_loc = w_idx.shape[0] // mesh.tp
    m = mesh.coords["model"]
    w_loc = w_idx[m * k_loc:(m + 1) * k_loc].contiguous()
    x_loc = x2[:, m * k_loc:(m + 1) * k_loc].contiguous()
    acc = collectives.psum(dispatch.lut_acc(x_loc, w_loc, book, spec, table),
                           mesh)
    y = dispatch.backend_matmul(x_loc, w_loc, book,
                                dispatch.BackendSpec("lut", spec, mesh),
                                table=table, kind="row")
    return {"acc": acc, "y": y, "s": spec.s}


def _collective_bytes(trees, mesh) -> dict:
    """The largest payload (and the calls) of the collectives of one
    decode step and one verify step of the codebook engine at B = 4, S =
    256."""
    e = TEngine(tbuild(tiny_cfg(TC.get("qwen3-1.7b"))), trees["cp"],
                max_len=BYTES_S, max_batch=BYTES_B, backend="codebook",
                device="cpu", mesh=mesh)
    cache = e._contiguous_cache(BYTES_B)
    cache["pos"].fill_(9)
    out = {}
    for what, L in (("decode", 1), ("verify", BYTES_K1)):
        toks = torch.ones((BYTES_B, L), dtype=torch.int64)
        mesh.stats.reset()
        (e.model.decode if L == 1 else e.model.verify)(e.params, toks, cache,
                                                       e.bk)
        out[what] = (mesh.stats.largest(), dict(mesh.stats.calls))
    return out


def _join_inputs(trees):
    rng = np.random.default_rng(7)
    cfg = tiny_cfg(TC.get("qwen3-1.7b"))
    B, S = 2, 16
    shape = (1, B, S, cfg.n_kv, cfg.hd)
    return {"x1": rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32),
            "x4": rng.standard_normal((B, 4, cfg.d_model)).astype(np.float32),
            "k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32),
            "pos": np.array([5, 11], np.int32)}


def _join_case(trees, mesh) -> dict:
    """Layer 0's attention on this rank's S-slice of a random cache: the
    decode step (vlen pos + 1, the write row masked) and a 4-token verify
    (vlen pos); the outputs and this rank's slice after the writes."""
    cfg = tiny_cfg(TC.get("qwen3-1.7b"))
    e = TEngine(tbuild(cfg), trees["p"], max_len=MAX_LEN, device="cpu",
                mesh=mesh)
    p_l = TT._layer(e.params["blocks"], 0)["attn"]
    inp = _join_inputs(trees)
    S_loc = inp["k"].shape[2] // mesh.tp
    a = mesh.coords["model"] * S_loc
    pos = torch.from_numpy(inp["pos"])
    out = {}
    for what, x, ppos, vlen in (
            ("decode", inp["x1"], pos[:, None], pos + 1),
            ("verify", inp["x4"], pos[:, None] + torch.arange(4)[None],
             pos)):
        k = torch.from_numpy(inp["k"][:, :, a:a + S_loc].copy())
        v = torch.from_numpy(inp["v"][:, :, a:a + S_loc].copy())
        fn = TA.attn_decode_cached if what == "decode" \
            else TA.attn_verify_cached
        y = fn(p_l, torch.from_numpy(x), TT.attn_cfg(cfg), pos=ppos,
               insert_at=pos, valid_len=vlen, k_all=k, v_all=v, layer=0,
               backend=e.bk)
        out[what] = (y, k, v)
    return out


@functools.lru_cache(maxsize=None)
def _smoke():
    """``chip_smoke.py``, loaded by its path (its [tp] phase's witness and
    decision records run here on the CPU)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_for_tests",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16_trees() -> dict:
    """The port's own tiny model in bf16, seeded, and its k-means form."""
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.serving import to_codebook_params

    cfg = tiny_cfg(TC.get("qwen3-1.7b")).replace(dtype="bfloat16")
    params = tbuild(cfg).init(torch.Generator().manual_seed(0), "cpu")
    wq = cfg.quantized(n_weights=256).wq
    pq, st = cluster_params(params, wq, init_state(wq), wq.interval)
    return {"p": params, "cp": to_codebook_params(pq, wq, st, min_size=1024)}


def _bf16_runs(trees, mesh, one_process=False) -> dict:
    """Each BF16_CASES serve's tokens and decision records (``chip_smoke.
    tp_record``); with ``one_process`` the mesh-less engine computes as
    two ranks do (``chip_smoke.tp_one_process``)."""
    S = _smoke()
    base = tiny_cfg(TC.get("qwen3-1.7b")).replace(dtype="bfloat16")
    out = {}
    for case in BF16_CASES:
        be, levels, kvq, spec = _case(case)
        e = TEngine(tbuild(base.replace(kv_quant=kvq, act_levels=levels)),
                    trees["p"] if be == "dense" else trees["cp"],
                    max_len=MAX_LEN, max_batch=4, backend=be, device="cpu",
                    spec=TSpec(draft="ngram", k=K) if spec else None,
                    mesh=mesh)
        rec = []
        S.tp_record(e, rec)
        with (S.tp_one_process(torch.bfloat16) if one_process
              else contextlib.nullcontext()):
            out[case] = (e.serve(PROMPTS, max_new=MAX_NEW), rec)
    return out


def rank_tp2(rank: int, path: str) -> dict:
    trees = torch.load(path, weights_only=True)
    mesh = make_local_mesh(1, 2)
    dispatch.reset_route_counts()
    tokens = _port_tokens(trees, mesh, CASES)
    routes = dispatch.route_counts()
    return {"tokens": tokens, "routes": routes,
            "bf16": _bf16_runs(trees["bf16"], mesh),
            "lut": _lut_acc_case(trees, mesh),
            "bytes": _collective_bytes(trees, mesh),
            "join": _join_case(trees, mesh)}


def rank_tp4(rank: int, path: str) -> dict:
    trees = torch.load(path, weights_only=True)
    return {"tokens": _port_tokens(trees, make_local_mesh(1, 4), TP4_CASES)}


# --- fixtures (the parent process) ---------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The reference's tiny model, its params and their compressed form,
    bridged to the port and written for the ranks."""
    jax = pytest.importorskip("jax")
    import repro.configs as C
    from repro.core.quantizer import (WeightQuantConfig, cluster_params,
                                      init_state)
    from repro.models.model_zoo import build
    from repro.serving import to_codebook_params
    from repro_torch.bridge import from_jax_params

    cfg = tiny_cfg(C.get("qwen3-1.7b"))
    params = build(cfg).init(jax.random.PRNGKey(0))
    wq = WeightQuantConfig(num_weights=256, method="kmeans")
    pq, state = cluster_params(params, wq, init_state(wq), 1000,
                               jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, wq, state, min_size=1024)
    trees = {n: from_jax_params(jax.tree_util.tree_map(np.asarray, t), "cpu")
             for n, t in (("p", params), ("cp", cp))}
    trees["bf16"] = _bf16_trees()
    path = str(tmp_path_factory.mktemp("tp") / "trees.pt")
    torch.save(trees, path)
    return {"cfg": cfg, "params": params, "cp": cp, "trees": trees,
            "path": path, "tmp": str(tmp_path_factory.mktemp("ranks"))}


@pytest.fixture(scope="module")
def tp2(tiny):
    return run_ranks(rank_tp2, 2, (tiny["path"],), tmp_dir=tiny["tmp"])


@pytest.fixture(scope="module")
def tp4(tiny):
    return run_ranks(rank_tp4, 4, (tiny["path"],), tmp_dir=tiny["tmp"])


@pytest.fixture(scope="module")
def meshless(tiny):
    return _port_tokens(tiny["trees"], None, CASES)


@pytest.fixture(scope="module")
def reference(tiny):
    from repro.models.model_zoo import build
    from repro.serving import ServeEngine, SpecConfig

    out = {}
    for case in CASES:
        be, levels, kvq, spec = _case(case)
        e = ServeEngine(build(tiny["cfg"].replace(kv_quant=kvq,
                                                  act_levels=levels)),
                        tiny["params"] if be == "dense" else tiny["cp"],
                        max_len=MAX_LEN, max_batch=2, backend=be,
                        spec=SpecConfig(draft="ngram", k=K) if spec
                        else None)
        out[case] = e.serve(PROMPTS, max_new=MAX_NEW)
    return out


# --- tokens ---------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_tp2_tokens_equal_meshless_and_reference(tp2, meshless, reference,
                                                 case):
    assert meshless[case] == reference[case]
    for r in tp2:
        assert r["tokens"][case] == reference[case]


@pytest.mark.parametrize("case", TP4_CASES)
def test_tp4_tokens_equal_meshless_and_reference(tp4, reference, case):
    for r in tp4:
        assert r["tokens"][case] == reference[case]


@pytest.mark.parametrize("case", BF16_CASES)
def test_tp2_bf16_equals_its_sums_in_one_process(tiny, tp2, case):
    """In bf16 (the port's own tiny model) tp=2 may part from tp=1 by its
    sums' order and rounding; computed as the two ranks do in one process
    (chip_smoke.py's witness, ``tp_one_process``), the mesh-less engine
    gives tp=2's tokens and bit-equal decision logits."""
    toks, rec = _bf16_runs(tiny["trees"]["bf16"], None, one_process=True)[
        case]
    for r in tp2:
        got, got_rec = r["bf16"][case]
        assert got == toks
        assert len(got_rec) == len(rec)
        for (a, act), (b, bact) in zip(rec, got_rec):
            assert torch.equal(act, bact)
            assert torch.equal(a, b)


def test_ranks_agree(tp2):
    """Each collective hands every rank the same bytes: the ranks' outputs
    are identical, bit for bit."""
    a, b = tp2
    assert a["tokens"] == b["tokens"]
    assert torch.equal(a["lut"]["y"], b["lut"]["y"])
    for what in ("decode", "verify"):
        assert torch.equal(a["join"][what][0], b["join"][what][0])


def test_ranks_run_a_function_of_a_file(tmp_path):
    """A ``FileFunction`` hands the ranks a function of a script by the
    file's path: each rank loads the file itself, whatever name (if any)
    the caller imported it under."""
    src = tmp_path / "a_script.py"
    src.write_text("import os\n\n\ndef rank_fn(rank, x):\n"
                   "    return rank * 10 + x, __name__ != '__main__'\n")
    got = run_ranks(FileFunction(str(src), "rank_fn"), 2, (3,),
                    tmp_dir=str(tmp_path))
    assert got == [(3, True), (13, True)]


# --- the lut row psum -------------------------------------------------------------

def test_lut_row_psum_is_bit_exact(tiny, tp2):
    """The w2 site's int32 accumulator psummed over 2 ranks equals the
    one-device accumulator and the reference's ``_lut_acc``, and the
    decoded row route equals the one-device product, bit for bit: the
    decode uses the full fan-in's spec (one sized for K/2 has another
    ``s``)."""
    import jax.numpy as jnp
    from repro.kernels import dispatch as RD

    w_idx, book, spec, table, x2 = _w2_site(tiny["trees"])
    one = dispatch.lut_acc(x2, w_idx, book, spec, table)
    rspec = RD.make_lut_spec(jnp.asarray(book.numpy()), fan_in=w_idx.shape[0])
    want = np.asarray(RD._lut_acc(jnp.asarray(x2.numpy()),
                                  jnp.asarray(w_idx.numpy()),
                                  jnp.asarray(book.numpy()), rspec,
                                  RD.build_lut_table(
                                      jnp.asarray(book.numpy()), rspec)))
    assert rspec.s == spec.s
    np.testing.assert_array_equal(one.numpy(), want)
    y_one = dispatch.backend_matmul(x2, w_idx, book,
                                    dispatch.BackendSpec("lut", spec),
                                    table=table)
    for r in tp2:
        assert r["lut"]["s"] == spec.s
        assert torch.equal(r["lut"]["acc"], one)
        assert torch.equal(r["lut"]["y"], y_one)
    half = dispatch.make_lut_spec(book.numpy(), fan_in=w_idx.shape[0] // 2)
    assert half.s != spec.s


# --- routes and collectives ---------------------------------------------------------

def test_block_matmuls_take_col_or_row(tp2):
    """Every block matmul of every serve ran on the col or row route (the
    fused w1/w3 launch counts two col products), none replicated and none
    local."""
    routes = tp2[0]["routes"]
    for be in ("dense", "codebook", "lut"):
        assert routes.get(f"{be}.col", 0) > 0
        assert routes.get(f"{be}.row", 0) > 0
        # wq, wk, wv, w1, w3 against wo, w2
        assert routes[f"{be}.col"] * 2 == routes[f"{be}.row"] * 5
    assert not [k for k in routes
                if k.endswith(".replicated") or k.endswith(".local")]


def test_decode_and_verify_collectives_are_bounded(tiny, tp2):
    """The largest payload of a decode or verify step's collectives is
    O(B·H·hd·Lq): within 4 × B·H·hd·Lq f32 bytes and a sixteenth of one
    layer's cache (B·S·KV·hd f32), as the reference's
    ``collective_bounds`` holds it; six collectives a layer."""
    cfg = tiny["cfg"]
    layer_cache = BYTES_B * BYTES_S * cfg.n_kv * cfg.hd * 4
    for r in tp2:
        for what, lq in (("decode", 1), ("verify", BYTES_K1)):
            got, calls = r["bytes"][what]
            unit = BYTES_B * cfg.n_heads * cfg.hd * 4 * lq
            assert 0 < got <= 4 * unit, (what, got, unit)
            assert got * 16 <= layer_cache, (what, got)
            assert sum(calls.values()) == 6 * cfg.n_layers, calls
            assert calls["all_gather"] == calls["pmax"] == cfg.n_layers


# --- the join ---------------------------------------------------------------------

@pytest.mark.parametrize("what", ["decode", "verify"])
def test_join_matches_reference(tiny, tp2, what):
    """The joined output of layer 0 over 2 ranks' S-slices within 1e-5 of
    the reference's mesh-less ``attn_decode_cached``/``attn_verify_cached``
    on the same cache, and the ranks' slices after the writes (the fresh
    rows on their owning rank only) equal to the reference's cache."""
    import jax.numpy as jnp
    from repro.models import attention as RA
    from repro.models import transformer as RT

    cfg = tiny["cfg"]
    inp = _join_inputs(tiny["trees"])
    p_l = jax_layer(tiny["params"]["blocks"]["attn"], 0)
    pos = jnp.asarray(inp["pos"])
    if what == "decode":
        out, k, v, _ = RA.attn_decode_cached(
            p_l, jnp.asarray(inp["x1"]), RT.attn_cfg(cfg), pos=pos[:, None],
            insert_at=pos, valid_len=pos + 1, k_all=jnp.asarray(inp["k"]),
            v_all=jnp.asarray(inp["v"]), layer=0)
    else:
        out, k, v, _ = RA.attn_verify_cached(
            p_l, jnp.asarray(inp["x4"]), RT.attn_cfg(cfg),
            pos=pos[:, None] + jnp.arange(4)[None], insert_at=pos,
            valid_len=pos, k_all=jnp.asarray(inp["k"]),
            v_all=jnp.asarray(inp["v"]), layer=0)
    for r in tp2:
        np.testing.assert_allclose(r["join"][what][0].numpy(),
                                   np.asarray(out), rtol=0, atol=1e-5)
    for i, want in ((1, k), (2, v)):
        got = torch.cat([r["join"][what][i] for r in tp2], dim=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def jax_layer(tree, i):
    return {k: jax_layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# --- refusals ---------------------------------------------------------------------

class _Stand:
    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


@pytest.mark.parametrize("mesh_shape,kw", [
    ({"data": 2}, dict(max_len=64)),
    ({"data": 1, "model": 2}, dict(max_len=63)),
    ({"data": 1, "model": 2}, dict(max_len=6, spec=K)),
], ids=["no_model_axis", "max_len", "spec_room"])
def test_mesh_checks_match_reference(tiny, mesh_shape, kw):
    """The reference's checks of a mesh, with its exception and text (a
    stand-in mesh: the checks run before any placement)."""
    from repro.models.model_zoo import build
    from repro.serving import ServeEngine, SpecConfig

    k = kw.pop("spec", None)
    with pytest.raises(ValueError) as want:
        ServeEngine(build(tiny["cfg"]), tiny["params"], mesh=_Stand(
            mesh_shape), spec=SpecConfig(draft="ngram", k=k) if k else None,
            **kw)
    coords = {a: 0 for a in mesh_shape}
    with pytest.raises(ValueError) as got:
        TEngine(tbuild(tiny_cfg(TC.get("qwen3-1.7b"))), tiny["trees"]["p"],
                device="cpu", mesh=Mesh(mesh_shape, coords),
                spec=TSpec(draft="ngram", k=k) if k else None, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("what", ["paged", "moe", "probes", "model_draft"])
def test_later_slices_refused_under_a_mesh(tiny, what):
    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0})
    cfg = tiny_cfg(TC.get("qwen3-1.7b"))
    params = tiny["trees"]["p"]
    kw = {"paged": dict(paged=True), "probes": dict(probes=True),
          "model_draft": dict(spec=TSpec(draft="model", k=K,
                                         draft_params=params,
                                         draft_backend="dense"))
          }.get(what, {})
    if what == "moe":
        cfg = TC.get("qwen3-moe-30b-a3b").reduced()
        params = tbuild(cfg).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError,
                       match="later tensor-parallel slice"):
        TEngine(tbuild(cfg), params, max_len=64, device="cpu", mesh=mesh,
                **kw)


# --- the launcher -------------------------------------------------------------------

_WALL = re.compile(r"in \d+\.\d+s|\d+\.\d+ tok/s|\d+\.\d+ ms/request")


def _launch(argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TL.main(argv + ["--device", "cpu"])
    return [_WALL.sub("<wall>", ln) for ln in buf.getvalue().splitlines()]


@pytest.mark.parametrize("flags", ["--compress --backend lut",
                                   "--spec-draft ngram --spec-k 3"])
def test_launcher_tp2_prints_the_tp1_lines(flags):
    """``--tp 2 --device cpu`` prints the lines of the port's own ``--tp
    1`` run (whose lines are held against the reference's launcher by
    tests/test_torch_launch.py), wall figures masked."""
    argv = ["--arch", "qwen3-1.7b", "--reduced", "--requests", "4",
            "--max-new", "6"] + flags.split()
    one, two = _launch(argv), _launch(argv + ["--tp", "2"])
    assert two == one
    assert one[-1].startswith("sample:")
    assert any(ln.startswith("[serve]") for ln in one)


# --- the kernels at the sharded shapes (the card) -----------------------------------

# qwen3-1.7b's block matmuls on one of 2 ranks: col wq 2048 × 1024, wk/wv
# 2048 × 512, w1/w3 2048 × 3072; row wo 1024 × 2048, w2 3072 × 2048
TP2_SITES = ((2048, 1024), (2048, 512), (2048, 3072), (1024, 2048),
             (3072, 2048))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 20])
def test_cuda_kernels_at_tp2_shapes(m):
    """Needs a GPU and nvcc: codebook_matmul (within its parity limit),
    lut_matmul (bit-exact) at every sharded site, and codebook_swiglu
    at the w1/w3 shard bit-equal to the unfused chain (two codebook_matmul,
    act_quant with its multiplier) and to the plain epilogue of those
    accumulators; int8 ids of a 256-entry codebook, bf16 x."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm

    g = torch.Generator(device="cuda").manual_seed(m)
    book = torch.randn(256, generator=g, device="cuda") * 0.05
    for k, n in TP2_SITES:
        x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
        wi = torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                           dtype=torch.int8)
        got = cm.codebook_matmul_cuda(x, wi, book)
        want = cm.codebook_matmul_plain(x, wi, book)
        assert bool(((got - want).abs()
                     <= cm.parity_tolerance(x, wi, book)).all())
        a = torch.randint(0, 4096, (m, k), generator=g, device="cuda",
                          dtype=torch.int32)
        tab = torch.randint(-2 ** 20, 2 ** 20, (4096, 256), generator=g,
                            device="cuda", dtype=torch.int32)
        assert torch.equal(lm.lut_matmul_cuda(a, wi, tab),
                           lm.lut_matmul_plain(a, wi, tab))
    k, n = TP2_SITES[2]
    x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
    w1, w3 = (torch.randint(-128, 128, (k, n), generator=g, device="cuda",
                            dtype=torch.int8) for _ in range(2))
    got = cm.codebook_swiglu_cuda(x, w1, book, w3, book, "relu6", 32)
    gate = cm.codebook_matmul_cuda(x, w1, book)
    up = cm.codebook_matmul_cuda(x, w3, book)
    chain = aq.act_quant_cuda(gate.to(x.dtype), "relu6", 32,
                              form="act_apply", with_index=False,
                              mul=up.to(x.dtype))[0]
    plain = cm.swiglu_epilogue_plain(gate, up, x.dtype, "relu6", 32)
    torch.cuda.synchronize()
    for want in (chain, plain):
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
