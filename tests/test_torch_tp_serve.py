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

The same spawns serve the paged cache (each rank an in-page slice of the
pool: dense, codebook and lut, codebook with n-gram spec and at
act_levels 32, dense on int8 pages; prompts that share a page and repeat
one, so that prefix hits and copy-on-write happen) and the moe family
(the reduced qwen3-moe's 8 experts: EP; 3 experts: TP within expert) at
tp 2, and paged codebook and the paged MoE at tp 4; tokens, hit pages
and CoW copies must equal both mesh-less engines'.  Units: one layer's
paged decode, verify (straddling a page) and prefill chunk on the ranks'
in-page slices of a random pool (f32 and int8 pages) against the
reference's mesh-less functions, each rank's written slice against the
reference pool's; ``moe_apply`` in both regimes against the reference's
at act_levels 0 and 32; ``moe_param_specs`` against the reference's.

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
# bf16 cases held to chip_smoke.py's witness (``tp_one_process``); the
# paged ones (page PAGE, PAGED_PROMPTS) on bf16 and int8 pages
BF16_CASES = ["dense-int8/plain", "codebook/spec", "lut-a32/plain",
              "codebook/paged", "lut-int8/paged"]
BYTES_B, BYTES_S, BYTES_K1 = 4, 256, 4   # the collective-bound step shape


# the paged cache and the moe family, in f32: case → (model, backend,
# act_levels, page dtype (None: the contiguous cache), n-gram spec).  The
# prompts share a full page (prefix hits), and the third repeats the first,
# admitted after it retired: it hits the first's registered tail page and
# copies it on write.
PAGE = 8
SYSTEM = list(range(20, 20 + PAGE))
PAGED_PROMPTS = [SYSTEM + p for p in (PROMPTS[0], PROMPTS[1], PROMPTS[0],
                                      PROMPTS[3])]
PAGED_MOE = {"dense/paged": ("dense", "dense", 0, "bf16", False),
          "codebook/paged": ("dense", "codebook", 0, "bf16", False),
          "lut/paged": ("dense", "lut", 0, "bf16", False),
          "codebook/paged-spec": ("dense", "codebook", 0, "bf16", True),
          "dense/paged-int8": ("dense", "dense", 0, "int8", False),
          "codebook-a32/paged": ("dense", "codebook", 32, "bf16", False),
          "moe/contiguous": ("moe", "dense", 0, None, False),
          "moe/paged": ("moe", "dense", 0, "bf16", False),
          "moe3/contiguous": ("moe3", "dense", 0, None, False)}
TP4_PAGED_MOE = ["codebook/paged", "moe/paged"]
MOE_UNIT = [(8, 0), (8, 32), (3, 0), (3, 32)]    # (experts, act_levels)


def tiny_cfg(cfg):
    return cfg.reduced().replace(n_layers=2, d_model=64, n_kv=2, d_ff=128,
                                 head_dim=16, dtype="float32")


def tiny_moe_cfg(cfg, model: str = "moe"):
    """The reduced qwen3-moe (8 experts, top 2: EP at tp 2 and 4) at the
    tiny width; "moe3" has 3 experts (TP within expert)."""
    cfg = cfg.reduced().replace(n_layers=2, d_model=64, n_kv=2, d_ff=64,
                                head_dim=16)
    return cfg.replace(n_experts=3) if model == "moe3" else cfg


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


def _serve_case_cfg(pkg, model: str, levels: int):
    return (tiny_cfg(pkg.get("qwen3-1.7b")) if model == "dense" else
            tiny_moe_cfg(pkg.get("qwen3-moe-30b-a3b"), model)).replace(
                act_levels=levels)


def _serve_case(engine, prompts) -> tuple:
    """A serve's tokens, and the pool's hit pages and copy-on-write copies
    (None on the contiguous cache)."""
    toks = engine.serve(prompts, max_new=MAX_NEW)
    st = engine.pool.stats if engine.paged else None
    return toks, (st.hit_pages, st.cow_copies) if st else None


def _port_serve_case(trees, mesh, cases) -> dict:
    out = {}
    for case in cases:
        model, be, levels, pages, spec = PAGED_MOE[case]
        tree = trees[model] if model != "dense" else \
            trees["p" if be == "dense" else "cp"]
        e = TEngine(tbuild(_serve_case_cfg(TC, model, levels)), tree,
                    max_len=MAX_LEN, max_batch=2, backend=be, device="cpu",
                    paged=pages is not None, page_size=PAGE,
                    kv_dtype=pages or "bf16",
                    spec=TSpec(draft="ngram", k=K) if spec else None,
                    mesh=mesh)
        out[case] = _serve_case(e, PAGED_PROMPTS)
    return out


# one layer's paged attention on a random pool: the slots' page tables, the
# decode/verify positions (slot 0's verify straddles its first page)
PJ_PAGES = 6
PJ_TABLE = [[3, 1], [2, 5]]
PJ_POS = [5, 11]


def _paged_join_inputs():
    rng = np.random.default_rng(11)
    cfg = tiny_cfg(TC.get("qwen3-1.7b"))
    shape = (1, PJ_PAGES, PAGE, cfg.n_kv, cfg.hd)
    f = np.float32
    # bf16-representable scales
    sc = torch.from_numpy(rng.uniform(0.005, 0.05, shape[:-1]).astype(f)).to(
        torch.bfloat16).to(torch.float32).numpy()
    return {"x1": rng.standard_normal((2, 1, cfg.d_model)).astype(f),
            "x4": rng.standard_normal((2, 4, cfg.d_model)).astype(f),
            "xc": rng.standard_normal((1, PAGE, cfg.d_model)).astype(f),
            "k": rng.standard_normal(shape).astype(f),
            "v": rng.standard_normal(shape).astype(f),
            "kq": rng.integers(-127, 128, shape).astype(np.int8),
            "vq": rng.integers(-127, 128, shape).astype(np.int8),
            "ks": sc, "vs": sc[:, ::-1].copy()}


def _paged_join_args(what: str) -> dict:
    """The numpy arguments (but the pools) of one paged call."""
    pos = np.array(PJ_POS, np.int32)
    pt = np.array(PJ_TABLE, np.int32)
    if what == "decode":
        return dict(pos=pos[:, None], page_table=pt,
                    write_pid=pt[np.arange(2), pos // PAGE],
                    write_off=pos % PAGE, valid_len=pos)
    if what == "verify":
        ppos = pos[:, None] + np.arange(4, dtype=np.int32)[None]
        return dict(pos=ppos, page_table=pt,
                    write_pid=pt[np.arange(2)[:, None], ppos // PAGE],
                    write_off=ppos % PAGE, valid_len=pos)
    return dict(pos=(PAGE + np.arange(PAGE, dtype=np.int32))[None],
                page_table=pt[:1], write_pid=pt[0, 1], past_len=PAGE)


def _paged_pools(inp, kv: str, tp: int = 1, rank: int = 0) -> dict:
    """The pools (and int8 scales) of ``kv`` ('f32' or 'int8'): rank
    ``rank`` of ``tp``'s in-page slice, each its own contiguous tensor."""
    n = PAGE // tp
    names = ("k", "v") if kv == "f32" else ("kq", "vq", "ks", "vs")
    return {k: np.ascontiguousarray(inp[k][:, :, rank * n:(rank + 1) * n])
            for k in names}


def _paged_join_case(trees, mesh) -> dict:
    """Layer 0's paged decode, verify and prefill chunk on this rank's
    in-page slice of a random pool, f32 and int8 pages: the outputs and
    the rank's pools after the writes."""
    cfg = tiny_cfg(TC.get("qwen3-1.7b"))
    e = TEngine(tbuild(cfg), trees["p"], max_len=MAX_LEN, device="cpu",
                mesh=mesh)
    p_l = TT._layer(e.params["blocks"], 0)["attn"]
    inp = _paged_join_inputs()
    fn = {"decode": TA.attn_decode_paged, "verify": TA.attn_verify_paged,
          "prefill": TA.attn_prefill_chunk}
    x = {"decode": "x1", "verify": "x4", "prefill": "xc"}
    out = {}
    for what in fn:
        for kv in ("f32", "int8"):
            pools = {k: torch.from_numpy(a) for k, a in _paged_pools(
                inp, kv, mesh.tp, mesh.coords["model"]).items()}
            if kv == "int8":
                pools["ks"] = pools["ks"].to(torch.bfloat16)
                pools["vs"] = pools["vs"].to(torch.bfloat16)
            args = {k: torch.as_tensor(a) for k, a in
                    _paged_join_args(what).items()}
            if what == "prefill":
                args = {**args, "write_pid": int(args["write_pid"]),
                        "past_len": int(args["past_len"])}
            names = ("k", "v") if kv == "f32" else ("kq", "vq")
            y = fn[what](p_l, torch.from_numpy(inp[x[what]]),
                         TT.attn_cfg(cfg), k_pool=pools[names[0]],
                         v_pool=pools[names[1]], layer=0,
                         scales=None if kv == "f32" else (pools["ks"],
                                                          pools["vs"]),
                         backend=e.bk, **args)
            out[what, kv] = (y, pools)
    return out


def _moe_unit_inputs(E: int, levels: int):
    """(MoE config keywords, params, x) of a ``moe_apply`` case: T = 16
    tokens in 2 chunks, capacity drops in each."""
    rng = np.random.default_rng(E * 100 + levels)
    d, f = 64, 64
    kw = dict(d_model=d, d_ff=f, n_experts=E, top_k=2, token_chunks=2,
              act_levels=levels)
    std = np.float32(d ** -0.5)
    p = {"router": {"w": rng.standard_normal((d, E)).astype(np.float32)
                    * std},
         "w1": rng.standard_normal((E, d, f)).astype(np.float32) * std,
         "w3": rng.standard_normal((E, d, f)).astype(np.float32) * std,
         "w2": rng.standard_normal((E, f, d)).astype(np.float32)
         * np.float32(f ** -0.5)}
    return kw, p, rng.standard_normal((2, 8, d)).astype(np.float32)


def _moe_unit_case(mesh) -> dict:
    """``moe_apply`` over the mesh on this rank's expert slices (EP at 8
    experts, TP within expert at 3) for each MOE_UNIT case."""
    from repro_torch.distributed.sharding import local_slice
    from repro_torch.models import moe as TM

    out = {}
    for E, levels in MOE_UNIT:
        kw, p, x = _moe_unit_inputs(E, levels)
        cfg = TM.MoEConfig(**kw)
        specs = TM.moe_param_specs(cfg, mesh.tp)
        loc = {k: local_slice(torch.from_numpy(p[k]), specs[k], mesh)
               for k in ("w1", "w3", "w2")}
        loc["router"] = {"w": torch.from_numpy(p["router"]["w"])}
        out[E, levels] = TM.moe_apply(loc, torch.from_numpy(x), cfg, mesh)
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
        paged = case.endswith("/paged")
        e = TEngine(tbuild(base.replace(kv_quant=kvq and not paged,
                                        act_levels=levels)),
                    trees["p"] if be == "dense" else trees["cp"],
                    max_len=MAX_LEN, max_batch=4, backend=be, device="cpu",
                    spec=TSpec(draft="ngram", k=K) if spec else None,
                    paged=paged, page_size=PAGE,
                    kv_dtype="int8" if kvq else "bf16", mesh=mesh)
        rec = []
        S.tp_record(e, rec)
        with (S.tp_one_process(torch.bfloat16) if one_process
              else contextlib.nullcontext()):
            out[case] = (e.serve(PAGED_PROMPTS if paged else PROMPTS,
                                 max_new=MAX_NEW), rec)
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
            "join": _join_case(trees, mesh),
            "paged_moe": _port_serve_case(trees, mesh, PAGED_MOE),
            "paged_join": _paged_join_case(trees, mesh),
            "moe_unit": _moe_unit_case(mesh)}


def rank_tp4(rank: int, path: str) -> dict:
    trees = torch.load(path, weights_only=True)
    mesh = make_local_mesh(1, 4)
    return {"tokens": _port_tokens(trees, mesh, TP4_CASES),
            "paged_moe": _port_serve_case(trees, mesh, TP4_PAGED_MOE)}


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
    moe = {m: build(_serve_case_cfg(C, m, 0)).init(jax.random.PRNGKey(0))
           for m in ("moe", "moe3")}
    trees = {n: from_jax_params(jax.tree_util.tree_map(np.asarray, t), "cpu")
             for n, t in (("p", params), ("cp", cp), *moe.items())}
    trees["bf16"] = _bf16_trees()
    path = str(tmp_path_factory.mktemp("tp") / "trees.pt")
    torch.save(trees, path)
    return {"cfg": cfg, "params": params, "cp": cp, "moe": moe,
            "trees": trees, "path": path,
            "tmp": str(tmp_path_factory.mktemp("ranks"))}


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


@pytest.fixture(scope="module")
def paged_moe(tiny):
    """The PAGED_MOE cases on the port's mesh-less engine and on the
    reference's."""
    import repro.configs as C
    from repro.models.model_zoo import build
    from repro.serving import ServeEngine, SpecConfig

    ref = {}
    for case, (model, be, levels, pages, spec) in PAGED_MOE.items():
        tree = tiny["moe"][model] if model != "dense" else \
            tiny["params" if be == "dense" else "cp"]
        e = ServeEngine(build(_serve_case_cfg(C, model, levels)), tree,
                        max_len=MAX_LEN, max_batch=2, backend=be,
                        paged=pages is not None, page_size=PAGE,
                        kv_dtype=pages or "bf16",
                        spec=SpecConfig(draft="ngram", k=K) if spec
                        else None)
        ref[case] = _serve_case(e, PAGED_PROMPTS)
    return {"port": _port_serve_case(tiny["trees"], None, PAGED_MOE),
            "reference": ref}


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


@pytest.mark.parametrize("case", list(PAGED_MOE))
def test_tp2_paged_and_moe_equal_meshless_and_reference(tp2, paged_moe, case):
    """Each case at tp 2 (the paged cache's in-page slices, the MoE's EP
    and TP-within-expert regimes): tokens, prefix-hit pages and
    copy-on-write copies equal to both mesh-less engines'."""
    want = paged_moe["reference"][case]
    assert paged_moe["port"][case] == want
    if want[1] is not None:
        assert want[1][0] > 0 and want[1][1] > 0      # hits and CoW happen
    for r in tp2:
        assert r["paged_moe"][case] == want


@pytest.mark.parametrize("case", TP4_PAGED_MOE)
def test_tp4_paged_and_moe_equal_reference(tp4, paged_moe, case):
    """At tp 4 (page 8: 2 rows a rank; 2 experts a rank)."""
    for r in tp4:
        assert r["paged_moe"][case] == paged_moe["reference"][case]


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


@pytest.mark.parametrize("what", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_join_matches_reference(tiny, tp2, what, kv):
    """Layer 0's paged decode, verify (slot 0's four tokens straddle a
    page) and prefill chunk over 2 ranks' in-page slices of a random pool
    within 1e-5 of the reference's mesh-less functions on the whole pool,
    and each rank's pools after the writes equal to its slice of the
    reference's, the trash page 0 aside (int8 codes and scales bit-equal;
    f32 within 1e-5: the two packages' projections round apart)."""
    import jax.numpy as jnp
    from repro.models import attention as RA
    from repro.models import transformer as RT

    inp = _paged_join_inputs()
    pools = {k: jnp.asarray(a) for k, a in _paged_pools(inp, kv).items()}
    if kv == "int8":
        pools["ks"] = pools["ks"].astype(jnp.bfloat16)
        pools["vs"] = pools["vs"].astype(jnp.bfloat16)
    names = ("k", "v") if kv == "f32" else ("kq", "vq")
    fn = {"decode": RA.attn_decode_paged, "verify": RA.attn_verify_paged,
          "prefill": RA.attn_prefill_chunk}[what]
    x = {"decode": "x1", "verify": "x4", "prefill": "xc"}[what]
    args = {k: jnp.asarray(a) for k, a in _paged_join_args(what).items()}
    out, k, v, sc = fn(jax_layer(tiny["params"]["blocks"]["attn"], 0),
                       jnp.asarray(inp[x]), RT.attn_cfg(tiny["cfg"]),
                       k_pool=pools[names[0]], v_pool=pools[names[1]],
                       layer=0, scales=None if kv == "f32"
                       else (pools["ks"], pools["vs"]), **args)
    want = dict(zip(names, (k, v)))
    if kv == "int8":
        want.update(ks=sc[0], vs=sc[1])
    n = PAGE // len(tp2)
    for r, got in enumerate(tp2):
        y, pools_r = got["paged_join"][what, kv]
        np.testing.assert_allclose(y.numpy(), np.asarray(out), rtol=0,
                                   atol=1e-5)
        for name, w in want.items():
            a = pools_r[name][:, 1:].float().numpy()
            b = np.asarray(w[:, 1:, r * n:(r + 1) * n].astype(jnp.float32))
            if kv == "int8":
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("experts,levels", MOE_UNIT)
def test_moe_apply_regimes_match_reference(tp2, experts, levels):
    """``moe_apply`` over 2 ranks, EP at 8 experts (4 a rank) and TP within
    expert at 3 (f cut in two), within 1e-5 of the reference's mesh-less
    ``moe_apply`` on the whole params, at act_levels 0 and 32, with
    capacity drops in both token chunks."""
    import jax
    import jax.numpy as jnp
    from repro.models import moe as JM

    kw, p, x = _moe_unit_inputs(experts, levels)
    want = np.asarray(JM.moe_apply(jax.tree_util.tree_map(jnp.asarray, p),
                                   jnp.asarray(x), JM.MoEConfig(**kw)))
    for r in tp2:
        np.testing.assert_allclose(r["moe_unit"][experts, levels].numpy(),
                                   want, rtol=0, atol=1e-5)
    assert torch.equal(tp2[0]["moe_unit"][experts, levels],
                       tp2[1]["moe_unit"][experts, levels])


@pytest.mark.parametrize("tp", [1, 2, 3, 16])
def test_moe_param_specs_match_reference(tp):
    """qwen3-moe's 128 experts: EP at tp 2 and 16, TP within expert at 1
    and 3; with and without FSDP's ``data`` axis."""
    import jax
    from repro.models import moe as JM
    from repro_torch.models import moe as TM

    for fsdp in (True, False):
        kw = dict(d_model=2048, d_ff=768, n_experts=128, top_k=8, fsdp=fsdp)
        want = jax.tree_util.tree_map(
            tuple, JM.moe_param_specs(JM.MoEConfig(**kw), tp),
            is_leaf=lambda t: isinstance(t, jax.sharding.PartitionSpec))
        assert TM.moe_param_specs(TM.MoEConfig(**kw), tp) == want


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
    ({"data": 1, "model": 2}, dict(max_len=64, paged=True, page_size=15)),
], ids=["no_model_axis", "max_len", "spec_room", "page_size"])
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


@pytest.mark.parametrize("what", ["sched_state", "paged_probes", "probes",
                                  "model_draft"])
def test_later_slices_refused_under_a_mesh(tiny, what):
    """Under a mesh the engine refuses only what the reference refuses,
    with its exception and text (which no mesh changes): the step-level
    API on a speculative engine (n-gram, and a model draft) and probes
    with speculative decoding (contiguous and paged)."""
    from repro.models.model_zoo import build
    from repro.serving import ServeEngine, SpecConfig

    mesh = Mesh({"data": 1, "model": 2}, {"data": 0, "model": 0})
    draft = what == "model_draft"

    def kw(params, spec_cls):
        spec = spec_cls(draft="model", k=K, draft_params=params,
                        draft_backend="dense") if draft \
            else spec_cls(draft="ngram", k=K)
        return {"sched_state": dict(spec=spec),
                "paged_probes": dict(spec=spec, paged=True, page_size=8,
                                     probes=True),
                "probes": dict(spec=spec, probes=True),
                "model_draft": dict(spec=spec)}[what]

    def refusal(make):
        with pytest.raises(NotImplementedError) as e:
            eng = make()
            if what in ("sched_state", "model_draft"):
                eng.sched_state()
        return str(e.value)

    want = refusal(lambda: ServeEngine(build(tiny["cfg"]), tiny["params"],
                                       max_len=64,
                                       **kw(tiny["params"], SpecConfig)))
    got = refusal(lambda: TEngine(tbuild(tiny_cfg(TC.get("qwen3-1.7b"))),
                                  tiny["trees"]["p"], max_len=64,
                                  device="cpu", mesh=mesh,
                                  **kw(tiny["trees"]["p"], TSpec)))
    assert got == want


# --- the launcher -------------------------------------------------------------------

_WALL = re.compile(r"in \d+\.\d+s|\d+\.\d+ tok/s|\d+\.\d+ ms/request")


def _launch(argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TL.main(argv + ["--device", "cpu"])
    return [_WALL.sub("<wall>", ln) for ln in buf.getvalue().splitlines()]


@pytest.mark.parametrize("flags", ["--compress --backend lut",
                                   "--spec-draft ngram --spec-k 3",
                                   "--compress --backend codebook --paged "
                                   "--page-size 8",
                                   "--arch qwen3-moe-30b-a3b --paged"])
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


@pytest.mark.cuda
@pytest.mark.parametrize("page_loc", [8, 2])
def test_cuda_gather_pages_at_rank_slices(page_loc):
    """Needs a GPU and nvcc: ``gather_pages_many`` on one rank's in-page
    slice of a qwen3-1.7b layer's pools (page 16 at tp 2: 8 rows; page 8
    at tp 4: 2 rows; 8 kv heads of 128), bf16 K/V and int8 K/V with their
    bf16 scales in one launch, bit-exact against the plain version, page
    ids out of range included (clamped)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the CUDA kernels run only on the card")
    from repro_torch.kernels import page_gather as pg

    g = torch.Generator(device="cuda").manual_seed(page_loc)
    n_pages, shape = 64, (64, page_loc, 8, 128)
    table = torch.randint(-2, n_pages + 2, (4, 32), generator=g,
                          device="cuda", dtype=torch.int32)
    bf = [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
          for _ in range(2)]
    i8 = [torch.randint(-127, 128, shape, generator=g, device="cuda",
                        dtype=torch.int8) for _ in range(2)]
    sc = [torch.rand(shape[:-1], generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2)]
    for pools in (bf, i8 + sc):
        got = pg.page_gather_many_cuda(pools, table)
        want = pg.page_gather_many_plain(pools, table)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
