"""Tensor-parallel serving above the engine: the step-level API with the
``AsyncScheduler``, ``Server`` and ``Fleet`` over it, the numerics probes
and the model draft under ``ServeEngine(mesh=)``, and ``launch/serve.py
--tp 2`` with ``--server``, ``--probes`` and ``--spec-draft model``, on
gloo ranks on the CPU, each held against the reference's mesh-less engine
(or launcher) on the same params.

One module-scoped spawn of 2 ranks (``run_ranks``: a ``file://``
rendezvous under pytest's temporary directory) runs every case on the f32
tiny qwen3 of ``tests/test_torch_tp_serve.py`` (2 layers, d 64, 4 heads,
kv 2, ff 128, k-means |W| 256) and the reduced qwen3-moe (8 experts: EP),
params carried across by the bridge.  On the CPU every f32 tp=2 case
equals tp=1, so the checks are exact but where stated:

* the contended trace (``serving/server.contended_trace``) through
  ``Server.replay`` on the paged cache (``CONTENDED_ENGINE_KW``) and on
  the contiguous cache (max_batch 2, two priorities): events, streams,
  preemptions (> 0, so pages or a slot's rows are swapped out and back),
  pages swapped out and admission order;
* a 2-replica ``Fleet`` with a drain that migrates, a scale-up and a
  ``SharedPrefixTier`` that evicts: the event digest, ``replica_stats``,
  ``shared_tier_stats`` (bytes included: whole pages) and the streams;
* probes on dense, codebook and lut × contiguous and paged, dense on int8
  pages and codebook at act_levels 32: tokens equal to the probes-off
  run; the integer counters equal the reference's ``numerics()``,
  ``acc_max`` and ``headroom_bits`` within rel 1e-3 (abs 1e-6);
  ``kv_err_max`` 0 under the mesh, and > 0 in the int8 row of the
  mesh-less port engine;
* the reduced qwen3-moe at act_levels 32 through ``Server.replay`` with
  probes: tokens and events equal the reference's mesh-less run, the
  counters one reference run under 2 forced host devices
  (``tp_rig.run_under_devices`` on ``tp_sched_cases``), whose shard_map
  drops the experts' activation tap;
* the model draft (codebook target, lut draft at 512 levels, k 3) on the
  contiguous and paged caches: tokens and ``spec_stats``;
* ``python -m repro_torch.launch.serve --tp 2`` with ``--server``
  (replicas, a migrating drain, a preemption) and ``--probes``, and with
  ``--spec-draft model``: the reference's mesh-less launcher's lines, the
  wall-clock figures masked, and rank 0's metrics and numerics files;
  ``launch/serve.ranks_agree``, which holds the ranks' lines equal.

The reference runs in two children of ``tests/tp_rig.py``, started
first and run beside the ranks (``tests/tp_sched_cases.py`` has the cases
both packages run).  JAX is imported by the ``runs`` fixture's work only
(the launcher's weights): the ranks import this module to find their
function.
"""

import concurrent.futures
import contextlib
import copy
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tp_sched_cases as C  # noqa: E402
from repro_torch.launch import serve as TL  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, run_ranks  # noqa: E402

EXACT = ("tokens", "matmul_calls", "act_sat", "act_total", "page_oob",
         "widx_neg", "widx_oob")


def _masked(text: str, out_dir: str) -> list:
    """A launcher's stdout lines, the wall-clock figures and the output
    directory masked, and the telemetry's kernels line dropped (each
    package counts its own kernels: the port's CPU run records none, and
    says "nothing recorded" where it has no other line)."""
    return [TL.WALL.sub("<wall>", ln).replace(out_dir, "<dir>")
            for ln in text.splitlines()
            if not ln.startswith("[telemetry] kernels:")
            and ln != "[telemetry] nothing recorded"]


# --- what a rank runs ----------------------------------------------------------

def rank_tp2(rank: int, path: str) -> dict:
    trees = torch.load(path, weights_only=True)
    mesh = make_local_mesh(1, 2)
    P = C.Pkg(False)
    out = C.serve_cases(P, trees, mesh)
    out["probes"] = {c: C.probe_case(P, trees, mesh, c) for c in C.PROBES}
    out["plain"] = {c: C.probe_case(P, trees, mesh, c, probes=False)
                    for c in C.PROBES}
    return C.jsonable(out)


# --- the runs (the parent process) ---------------------------------------------

@contextlib.contextmanager
def _rank_threads():
    """Within: ``run_ranks`` gives each of 2 ranks one intra-op thread
    (the tiny models gain nothing from more, and idle threads spin
    against the reference's children)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _launch_params():
    """The reference launcher's weights (the reduced qwen3 from
    ``PRNGKey(0)``) bridged to the port, on the CPU."""
    import jax

    import repro.configs as RC
    from repro.models.model_zoo import build
    from repro_torch.bridge import from_jax_params

    return from_jax_params(jax.tree_util.tree_map(np.asarray, build(
        RC.get("qwen3-1.7b").reduced()).init(jax.random.PRNGKey(0))), "cpu")


def _port_launch(name: str, out_dir: str, params) -> str:
    """The port's ``main`` on LAUNCH ``name`` at ``--tp 2 --device cpu``,
    on ``params`` (the reference launcher's weights), its files under
    ``out_dir``: its stdout."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TL, "init_params",
                   lambda model, device: copy.deepcopy(params))
        with contextlib.redirect_stdout(buf):
            TL.main(C.launch_argv(name, out_dir)
                    + ["--tp", "2", "--device", "cpu"])
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run the tests read, once.  The reference's runs are two
    children of the rig, started first (two at a time: the suite runs
    beside them): ``reference_serve_moe`` under 2 forced host devices
    (its mesh-less cases, which share the params, then ``moe_case`` under
    the mesh) and ``reference_launch_probes`` (its launcher on each
    LAUNCH argv, then the probes cases), each with a compilation cache of
    its own under the temporary directory.  Meanwhile this process runs the
    port's launcher (its own 2 ranks), and a thread bridges the
    reference's tiny params (``jax_trees``, which the first child shares)
    and runs ``rank_tp2`` on 2 ranks."""
    pytest.importorskip("jax")
    from repro_torch.bridge import from_jax_params
    from tp_rig import run_under_devices

    ref_dir = str(tmp_path_factory.mktemp("ref_launch"))
    shared = str(tmp_path_factory.mktemp("shared") / "jax_trees.pkl")
    caches = [str(tmp_path_factory.mktemp("jax_cache")) for _ in range(2)]
    jobs = {"serve_moe": ("reference_serve_moe", {"trees_path": shared,
                                                  "cache_dir": caches[0]}, 2),
            "launch_probes": ("reference_launch_probes",
                              {"out_dir": ref_dir, "trees_path": shared,
                               "cache_dir": caches[1]}, 1)}
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
        ref = {k: pool.submit(run_under_devices, f"tp_sched_cases:{fn}", kw,
                              n_devices=n)
               for k, (fn, kw, n) in jobs.items()}
        tree_dir = str(tmp_path_factory.mktemp("tp"))
        rank_dir = str(tmp_path_factory.mktemp("ranks"))
        port_dir = str(tmp_path_factory.mktemp("port_launch"))

        def bridged_ranks():
            trees = {n: from_jax_params(t, "cpu")
                     for n, t in C.wait_trees(
                         shared, lambda: not ref["serve_moe"].done()).items()}
            path = os.path.join(tree_dir, "trees.pt")
            torch.save(trees, path)
            return trees, run_ranks(rank_tp2, 2, (path,), tmp_dir=rank_dir)

        with _rank_threads():
            ranks = pool.submit(bridged_ranks)
            launch, params = {}, _launch_params()
            for name in C.LAUNCH:
                os.makedirs(os.path.join(port_dir, name))
                launch[name] = _port_launch(
                    name, os.path.join(port_dir, name), params)
            trees, tp2 = ranks.result()
        ref = {k: v for f in ref.values() for k, v in f.result().items()}
        return {"ref": ref, "launch": launch, "trees": trees, "tp2": tp2,
                "dirs": {"port": port_dir, "ref": ref_dir}}


@pytest.fixture(scope="module")
def tp2(runs):
    return runs["tp2"]


@pytest.fixture(scope="module")
def reference(runs):
    return runs["ref"]


# --- the launcher ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(C.LAUNCH))
def test_launcher_tp2_prints_reference_lines(name, runs):
    """``--tp 2 --device cpu`` prints the reference's mesh-less launcher's
    lines on the same weights, the wall-clock figures masked (the
    launcher itself holds every rank's lines to rank 0's)."""
    port = os.path.join(runs["dirs"]["port"], name)
    ref = os.path.join(runs["dirs"]["ref"], name)
    got = _masked(runs["launch"][name], port)
    assert got == _masked(runs["ref"]["launch"][name], ref)
    assert got[-1].startswith("sample:")
    if name == "server_fleet_probes":
        text = "\n".join(got)
        assert "[numerics]" in text and "drain migration: 0 " not in text
        assert "[server] 0 preemptions" not in text
        # rank 0's files: the metrics snapshot (every byte count whole)
        # and the numerics equal the reference's, kernels aside
        for f in ("metrics.json", "numerics.json"):
            with open(os.path.join(port, f)) as a, \
                    open(os.path.join(ref, f)) as b:
                want, have = json.load(b), json.load(a)
            want.pop("kernels", None)
            have.pop("kernels", None)
            assert have == want, f


def test_launcher_raises_when_a_rank_parts():
    """``--tp`` holds every rank's report lines to rank 0's, the
    wall-clock figures masked: a rank whose lines part raises."""
    a = ["[serve] 24 tokens in 1.25s (19.2 tok/s on cpu, backend=dense, "
         "slots=4, 52.1 ms/request)", "sample: [1] -> [2, 3]"]
    b = [a[0].replace("1.25s", "1.40s").replace("19.2", "17.1"), a[1]]
    assert TL.ranks_agree([a, b]) == a
    with pytest.raises(RuntimeError, match="rank 1's report parts"):
        TL.ranks_agree([a, [b[0], "sample: [1] -> [2, 4]"]])
    with pytest.raises(RuntimeError, match="1 lines"):
        TL.ranks_agree([a, a[:1]])


# --- the scheduler and the fleet ------------------------------------------------

@pytest.mark.parametrize("mode", ["paged", "contig"])
def test_sched_replay_equals_reference(tp2, reference, mode):
    """``sched_trace_case``'s contract at tp 2: the event log, admission
    order, preemptions, pages swapped out and every stream equal the
    reference's mesh-less replay; the contended trace preempts, so a
    request's pages (one ``page_gather`` of the rank's slices) or its
    slot's rows go out to a host blob and come back."""
    want = reference["serve"]["sched"][mode]
    assert want["preemptions"] > 0
    if mode == "paged":
        assert want["pages_swapped_out"] > 0
    for r in tp2:
        assert r["sched"][mode] == want


def test_fleet_drain_migrate_scale_tier_equal_reference(tp2, reference):
    """Two tensor-parallel replicas on the same ranks: a drain that
    migrates running requests (their rank-sliced blobs to the same
    survivor on every rank), a scale-up that is routed to, and a shared
    tier that counts whole pages and evicts: digest, replica and tier
    stats, streams, migration and swap counts equal the reference's."""
    want = reference["serve"]["fleet"]
    assert want["migrated"][0] > 0 and want["migrated"][1] > 0
    assert want["tier"]["evictions"] > 0 and want["tier"]["hits"] > 0
    assert want["replicas"]["r2"]["routed"] > 0
    assert want["preemptions"] > 0
    for r in tp2:
        assert r["fleet"] == want


def test_ranks_agree(tp2):
    """Every rank makes the same host decisions, tokens and counters."""
    assert tp2[0] == tp2[1]


# --- the probes ---------------------------------------------------------------

@pytest.mark.parametrize("case", list(C.PROBES))
def test_probes_equal_reference(tp2, reference, case):
    """Tokens with probes on equal the probes-off run; the integer
    counters equal the reference's mesh-less ``numerics()`` exactly (a
    rank's slices summed, replicated inputs counted once), ``acc_max`` and
    ``headroom_bits`` within rel 1e-3; the KV error reads 0 under the mesh
    (the reference's shard_map drops the ``quantize_kv`` tap)."""
    want = reference["probes"][case]
    for r in tp2:
        got = r["probes"][case]
        assert got["tokens"] == r["plain"][case] == want["tokens"]
        n, w = got["numerics"], want["numerics"]
        for k in EXACT:
            assert n[k] == w[k], (k, n[k], w[k])
        for k in ("acc_max", "headroom_bits"):
            for a, b in zip(n[k], w[k]):
                assert a == pytest.approx(b, rel=1e-3, abs=1e-6), k
        assert max(n["kv_err_max"]) == 0.0
    be, levels, _, _ = C.PROBES[case]
    if be != "dense":
        assert min(want["numerics"]["matmul_calls"]) > 0
    if be == "lut" or levels:
        assert min(want["numerics"]["act_total"]) > 0


def test_probes_int8_meshless_port_reads_kv_error(runs):
    """The int8 row's KV tap is live without a mesh: the port's mesh-less
    engine reads a KV error > 0 where the mesh reads 0."""
    got = C.probe_case(C.Pkg(False), runs["trees"], None, "dense/paged-int8")
    assert max(got["numerics"]["kv_err_max"]) > 0.0


def test_moe_server_probes_fence(tp2, reference):
    """The reduced qwen3-moe (EP) at act_levels 32 through a probed
    ``Server``: tokens and events equal the reference's mesh-less run;
    the counters equal one reference run under 2 forced host devices,
    whose shard_map drops the experts' activation tap (which the mesh-less
    run counts)."""
    want = reference["serve"]["moe"]
    mesh_ref = reference["moe_mesh"]
    assert mesh_ref["streams"] == want["streams"]
    assert min(want["numerics"]["act_total"]) > 0
    assert max(mesh_ref["numerics"]["act_total"]) == 0
    for r in tp2:
        got = r["moe"]
        assert got["streams"] == want["streams"]
        assert got["events"] == want["events"]
        n, w = got["numerics"], mesh_ref["numerics"]
        for k in EXACT + ("kv_err_max",):
            assert n[k] == w[k], (k, n[k], w[k])


# --- the model draft --------------------------------------------------------------

@pytest.mark.parametrize("mode", ["contig", "paged"])
def test_model_draft_equals_reference(tp2, reference, mode):
    """The codebook target sharded, its lut draft (512 levels, its own
    grid from the whole tree) unsharded on every rank with a whole cache:
    tokens and spec stats (rounds, proposed, accepted) equal the
    reference's."""
    want = reference["serve"]["draft"][mode]
    assert want["stats"][2] > 0
    for r in tp2:
        assert r["draft"][mode] == want
