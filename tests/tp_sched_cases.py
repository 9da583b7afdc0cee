"""The cases of ``tests/test_torch_tp_sched.py``, written once for both
packages (``Pkg``): the port's ranks run them under a mesh, and the
reference runs them mesh-less in children of the tensor-parallel rig
(``tp_rig.run_under_devices``: two children, ``reference_serve_moe``
and ``reference_launch_probes``), beside the test's own work.

Nothing here imports JAX at module level: the port's ranks import this
module to find the cases.  The reference side rebuilds its params from
fixed seeds in every child (``jax_trees``), so every process scores the
same params; one child shares its params with the others and with the
test, which bridges them to the port (``share_trees``, ``wait_trees``).
Every entry point of a child returns JSON-serialisable data.
"""

from __future__ import annotations

PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14]]
MAX_NEW = 6
MAX_LEN = 64
PAGE = 8
K = 3                                  # draft tokens a round
MOE_LEVELS = 32          # the experts' activation, whose tap a mesh fences
# the contended contiguous engine: 9 rows a rank at tp 2, so that the
# request swapped at position 10 keeps rows on both ranks
CONTIG_SCHED = dict(max_len=18, max_batch=2)
# the fleet: 2 replicas of CONTENDED_ENGINE_KW, r0 drained (migrating) at
# FLEET_DRAIN, r2 joined at FLEET_SCALE, a tier of FLEET_TIER_PAGES whole
# pages; a trace of 10 requests behind a 2-page shared prompt
FLEET_DRAIN, FLEET_SCALE, FLEET_TIER_PAGES = 0.15, 0.2, 2
# probes: case → (backend, act_levels, paged, int8 pages)
PROBES = {"dense/contig": ("dense", 0, False, False),
          "dense/paged": ("dense", 0, True, False),
          "codebook/contig": ("codebook", 0, False, False),
          "codebook/paged": ("codebook", 0, True, False),
          "lut/contig": ("lut", 0, False, False),
          "lut/paged": ("lut", 0, True, False),
          "dense/paged-int8": ("dense", 0, True, True),
          "codebook-a32/contig": ("codebook", 32, False, False)}
# the launcher: name → argv after --arch qwen3-1.7b --reduced ({dir}: the
# run's own output directory); the --server one preempts, and its drain
# migrates a running request
LAUNCH = {"server_fleet_probes": "--server --paged --traffic poisson --rate "
                                 "60 --requests 10 --max-batch 2 "
                                 "--priority-levels 2 --replicas 2 "
                                 "--drain-at 0.15:r0 --migrate-on-drain "
                                 "--probes --metrics-out {dir}/metrics.json "
                                 "--numerics-out {dir}/numerics.json",
          "spec_model": "--spec-draft model --compress --backend codebook "
                        "--requests 4 --max-batch 2 --max-new 8"}


def tiny_cfg(cfg):
    """The tiny dense qwen3 of ``tests/test_torch_tp_serve.py``."""
    return cfg.reduced().replace(n_layers=2, d_model=64, n_kv=2, d_ff=128,
                                 head_dim=16, dtype="float32")


def moe_cfg(cfg, levels: int = MOE_LEVELS):
    """The reduced qwen3-moe-30b-a3b (8 experts, top 2: EP at tp 2) at the
    tiny width of ``tests/test_torch_tp_serve.py``, at ``levels``."""
    return cfg.reduced().replace(n_layers=2, d_model=64, n_kv=2, d_ff=64,
                                 head_dim=16, act_levels=levels)


def launch_argv(name: str, out_dir: str) -> list:
    return (["--arch", "qwen3-1.7b", "--reduced"]
            + LAUNCH[name].format(dir=out_dir).split())


class Pkg:
    """One package's serving API (``jax_side``: the reference's)."""

    def __init__(self, jax_side: bool):
        if jax_side:
            import repro.configs as configs
            from repro.models.model_zoo import build
            from repro.serving import (Fleet, ServeEngine, SharedPrefixTier,
                                       SpecConfig, server)
            self.engine_kw = {}
        else:
            from repro_torch import configs
            from repro_torch.models.model_zoo import build
            from repro_torch.serving import (Fleet, ServeEngine,
                                             SharedPrefixTier, SpecConfig,
                                             server)
            self.engine_kw = {"device": "cpu"}
        self.configs, self.build, self.server = configs, build, server
        self.Fleet, self.ServeEngine = Fleet, ServeEngine
        self.SharedPrefixTier, self.SpecConfig = SharedPrefixTier, SpecConfig

    def engine(self, model, params, mesh=None, **kw):
        if mesh is not None:
            kw["mesh"] = mesh
        return self.ServeEngine(model, params, **self.engine_kw, **kw)

    def dense_model(self, levels: int = 0):
        return self.build(tiny_cfg(self.configs.get("qwen3-1.7b")).replace(
            act_levels=levels))


def sched_record(srv, rep) -> dict:
    """What ``tp_serve_cases.sched_trace_case`` records of a replay."""
    return {"events": [list(e) for e in srv.sched.events],
            "streams": {str(h.rid): list(h.tokens)
                        for h in srv.sched.handles.values()},
            "preemptions": rep.preemptions,
            "pages_swapped_out": rep.pages_swapped_out,
            "admission_order": rep.admission_order}


def sched_case(P, trees, mesh, paged: bool) -> dict:
    """The contended trace through ``Server.replay``, on the paged cache
    (``CONTENDED_ENGINE_KW``) or on the contiguous one."""
    model = P.dense_model()
    kw = P.server.CONTENDED_ENGINE_KW if paged else CONTIG_SCHED
    srv = P.server.Server(P.engine(model, trees["p"], mesh, **kw))
    return sched_record(srv, srv.replay(P.server.contended_trace(
        1, model.cfg.vocab)))


def fleet_case(P, trees, mesh) -> dict:
    """Two replicas, r0 drained with migration, r2 scaled in, a shared
    tier that evicts."""
    model = P.dense_model()
    cfg = model.cfg
    page_bytes = 2 * cfg.n_layers * PAGE * cfg.n_kv * cfg.hd * 4

    def mk():
        return P.engine(model, trees["p"], mesh,
                        **P.server.CONTENDED_ENGINE_KW)

    trace = P.server.poisson_trace(
        0, 10, rate=40.0, vocab=cfg.vocab, plen=(2, 9), max_new=(2, 10),
        priorities=(0, 1), shared_prefix=list(range(30, 30 + 2 * PAGE)))
    tier = P.SharedPrefixTier(capacity_bytes=FLEET_TIER_PAGES * page_bytes)
    fleet = P.Fleet({"r0": mk(), "r1": mk()}, migrate_on_drain=True,
                    shared_prefix_tier=tier)
    rep = fleet.replay(trace, drain_at=[(FLEET_DRAIN, "r0")],
                       scale_at=[(FLEET_SCALE, "r2", mk)])
    return {"digest": fleet.event_digest(), "replicas": fleet.replica_stats(),
            "tier": fleet.shared_tier_stats(),
            "streams": {str(k): list(h.tokens)
                        for k, h in sorted(fleet.handles.items())},
            "migrated": [fleet.n_migrated, fleet.n_migrated_pages],
            "preemptions": rep.preemptions,
            "pages_swapped_out": rep.pages_swapped_out}


def probe_case(P, trees, mesh, case: str, probes: bool = True):
    """One PROBES case's serve: its tokens and ``numerics()`` (its tokens
    alone with probes off)."""
    be, levels, paged, int8 = PROBES[case]
    kw = dict(paged=True, page_size=PAGE,
              kv_dtype="int8" if int8 else "bf16") if paged else {}
    e = P.engine(P.dense_model(levels), trees["p" if be == "dense" else "cp"],
                 mesh, max_len=MAX_LEN, max_batch=2, backend=be,
                 probes=probes, **kw)
    toks = e.serve(PROMPTS, max_new=MAX_NEW)
    return {"tokens": toks, "numerics": e.numerics()} if probes else toks


def moe_case(P, trees, mesh) -> dict:
    """The reduced qwen3-moe at act_levels 32, the contended trace through
    a probed ``Server``: events, streams and counters."""
    model = P.build(moe_cfg(P.configs.get("qwen3-moe-30b-a3b")))
    e = P.engine(model, trees["moe"], mesh, probes=True,
                 **P.server.CONTENDED_ENGINE_KW)
    srv = P.server.Server(e)
    rec = sched_record(srv, srv.replay(P.server.contended_trace(
        1, model.cfg.vocab)))
    return {"events": rec["events"], "streams": rec["streams"],
            "numerics": e.numerics()}


def draft_case(P, trees, mesh, paged: bool) -> dict:
    """The codebook target with its model draft: the same params on the
    lut backend at 512 levels."""
    spec = P.SpecConfig(draft="model", k=K, draft_params=trees["cp"],
                        draft_backend="lut", lut_levels=512)
    kw = dict(paged=True, page_size=PAGE) if paged else {}
    e = P.engine(P.dense_model(), trees["cp"], mesh, max_len=MAX_LEN,
                 max_batch=2, backend="codebook", spec=spec, **kw)
    toks = e.serve(PROMPTS, max_new=MAX_NEW)
    ss = e.spec_stats
    return {"tokens": toks, "stats": [ss.rounds, ss.proposed, ss.accepted]}


def serve_cases(P, trees, mesh) -> dict:
    """Every case but the probes and the launcher."""
    return {"sched": {m: sched_case(P, trees, mesh, m == "paged")
                      for m in ("paged", "contig")},
            "fleet": fleet_case(P, trees, mesh),
            "moe": moe_case(P, trees, mesh),
            "draft": {m: draft_case(P, trees, mesh, m == "paged")
                      for m in ("contig", "paged")}}


# --- the reference's side (JAX) ----------------------------------------------

def jsonable(x):
    """``x`` as the rig's JSON round trip gives it back (numpy scalars and
    arrays as Python numbers and lists, tuples as lists)."""
    import json

    def plain(o):
        return o.item() if getattr(o, "ndim", 1) == 0 else o.tolist()

    return json.loads(json.dumps(x, default=plain))


def jax_trees() -> dict:
    """The reference's tiny dense params, their k-means |W| 256 index form
    and the tiny qwen3-moe's params, from fixed seeds."""
    import jax

    import repro.configs as C
    from repro.core.quantizer import (WeightQuantConfig, cluster_params,
                                      init_state)
    from repro.models.model_zoo import build
    from repro.serving import to_codebook_params

    params = build(tiny_cfg(C.get("qwen3-1.7b"))).init(jax.random.PRNGKey(0))
    wq = WeightQuantConfig(num_weights=256, method="kmeans")
    pq, state = cluster_params(params, wq, init_state(wq), 1000,
                               jax.random.PRNGKey(1))
    cp = to_codebook_params(pq, wq, state, min_size=1024)
    moe = build(moe_cfg(C.get("qwen3-moe-30b-a3b"))).init(
        jax.random.PRNGKey(0))
    return {"p": params, "cp": cp, "moe": moe}


def share_trees(path: str) -> dict:
    """``jax_trees()``, and the same trees as numpy in a pickle at
    ``path`` (written whole, then renamed into place) for the processes
    that ``wait_trees``."""
    import os
    import pickle

    import jax
    import numpy as np

    try:
        trees = jax_trees()
    except BaseException:
        open(path + ".failed", "w").close()
        raise
    with open(path + ".part", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, trees), f)
    os.replace(path + ".part", path)
    return trees


def wait_trees(path: str, alive=None, timeout: float = 300.0) -> dict:
    """The numpy trees ``share_trees`` writes at ``path``, once they are
    there; raises when their maker failed, ``alive()`` turns False, or
    ``timeout`` seconds pass."""
    import os
    import pickle
    import time

    t0 = time.monotonic()
    while not os.path.exists(path):
        if os.path.exists(path + ".failed") or (alive and not alive()) \
                or time.monotonic() - t0 > timeout:
            raise RuntimeError(f"no params at {path}: their maker failed "
                               "or took too long")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def reference_cases(group: str, trees_path: str) -> dict:
    """The reference's mesh-less runs of ``group``: 'serve'
    (``serve_cases``; it makes the params and shares them at
    ``trees_path``) or 'probes' (every PROBES case, on the shared
    params)."""
    P = Pkg(True)
    if group == "probes":
        import jax
        import jax.numpy as jnp

        trees = jax.tree_util.tree_map(jnp.asarray, wait_trees(trees_path))
        return jsonable({c: probe_case(P, trees, None, c) for c in PROBES})
    return jsonable(serve_cases(P, share_trees(trees_path), None))


def compile_cache(cache_dir: str) -> None:
    """Keep every executable this child compiles in ``cache_dir`` (its
    own), so that an engine built again on the same shapes (the fleet's
    replicas, each case's engines) loads what an earlier one compiled."""
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def reference_serve_moe(trees_path: str, cache_dir: str, tp: int = 2) -> dict:
    """One child's work (under ``tp`` forced host devices): the 'serve'
    group mesh-less, which shares the params, then ``moe_server_probes``
    under the mesh."""
    compile_cache(cache_dir)
    return {"serve": reference_cases("serve", trees_path),
            "moe_mesh": moe_server_probes(tp)}


def reference_launch_probes(out_dir: str, trees_path: str,
                            cache_dir: str) -> dict:
    """The other child's work: the launcher on each LAUNCH argv, then the
    'probes' group on the params the first child shares (there by
    then)."""
    compile_cache(cache_dir)
    return {"launch": reference_launches(out_dir),
            "probes": reference_cases("probes", trees_path)}


def reference_launches(out_dir: str) -> dict:
    """The stdout of the reference's mesh-less launcher on each LAUNCH
    argv (its weights: the reduced qwen3 from ``PRNGKey(0)``), its files
    under ``out_dir``/name."""
    import contextlib
    import io
    import os
    import sys

    from repro.launch import serve as RS
    out = {}
    for name in LAUNCH:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        saved, buf = sys.argv, io.StringIO()
        sys.argv = ["serve.py"] + launch_argv(name, d)
        try:
            with contextlib.redirect_stdout(buf):
                RS.main()
        finally:
            sys.argv = saved
        out[name] = buf.getvalue()
    return out


def moe_server_probes(tp: int = 2) -> dict:
    """``moe_case`` on one reference engine under a (1, tp) mesh: its
    shard_map drops the experts' activation tap, so its counters, not the
    mesh-less ones, are what a mesh counts."""
    import jax

    from repro.distributed.compat import make_mesh
    P = Pkg(True)
    model = P.build(moe_cfg(P.configs.get("qwen3-moe-30b-a3b")))
    params = model.init(jax.random.PRNGKey(0))
    return jsonable(moe_case(P, {"moe": params},
                             make_mesh((1, tp), ("data", "model"))))
