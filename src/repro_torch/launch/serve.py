"""Serving launcher, the port's copy of ``repro/launch/serve.py``: builds a
model with seeded random weights, optionally compresses them to
codebook-index form (paper §4 / DESIGN.md §2), and serves a request stream
through the continuous-batching ServeEngine (DESIGN.md §3).

Knobs:
    --device {cuda,cpu}              where to run; unset = the GPU (fails
                                     without one); cpu runs every kernel's
                                     plain PyTorch version
    --backend {dense,codebook,lut}   matmul path for index-form weights
    --max-batch N                    slot-pool width (continuous batching)
    --requests N                     queue length (> max-batch exercises
                                     join/leave slot reuse)
    --uniform                        use the single fixed-batch generate()
                                     instead of the slot-pool serve()
    --paged                          paged KV cache (DESIGN.md §8): chunked
                                     prefill + page-gated admission
    --page-size N                    tokens per cache page (paged mode)
    --kv-dtype {bf16,int8}           page storage: model float dtype or
                                     int8 + per-token-per-head scales
    --prefix-cache / --no-prefix-cache
                                     content-addressed prompt-page sharing
    --spec-draft {none,ngram,model}  speculative decoding (DESIGN.md §9):
                                     parameter-free n-gram self-draft, or a
                                     lower-tier model draft (the SAME
                                     compressed params through the coarse
                                     lut grid; needs --compress)
    --spec-k N                       draft tokens per verify round
    --top-k / --top-p                sampling filters (temperature > 0)
    --tp N                           tensor parallelism over a (1, N)
                                     mesh (DESIGN.md §10): N ranks
                                     spawned over gloo, each on
                                     cuda:(rank % cards) (every rank on
                                     the one card of a one-card machine)
                                     or the CPU under --device cpu; the
                                     dense and moe families on the
                                     contiguous cache or --paged (each
                                     rank an in-page slice of the pool),
                                     plain, n-gram or model-draft spec,
                                     --server (the scheduler, and the
                                     fleet with its drains, migration,
                                     scale-ups and shared tier) and
                                     --probes; the decode step runs
                                     eager
    --server                         long-running request-server mode
                                     (DESIGN.md §11): a traffic trace plays
                                     through the virtual-clock
                                     AsyncScheduler — arrival-time
                                     admission, priorities, streaming,
                                     swap-out preemption — and a
                                     TTFT/TPOT/SLO report prints after the
                                     drain.  The wall clock is only read
                                     HERE; serving/ itself is clockless.
    --replicas N                     --server only: a Fleet over N
                                     independent engine replicas
                                     (DESIGN.md §15) — load- and
                                     prefix-aware routing, fleet-level
                                     report aggregation
    --route-policy {prefix,round_robin}
                                     fleet routing policy
    --drain-at T:REP                 drain replica REP at virtual time T
                                     (repeatable): stop admitting, let its
                                     running requests finish
    --scale-at T:REP                 join a fresh replica REP at virtual
                                     time T (repeatable)
    --migrate-on-drain               drain-time KV migration: a draining
                                     replica expels its queued/preempted/
                                     running requests — KV swap blobs
                                     included — and the router rehomes
                                     them to survivors, instead of the
                                     drain finishing them in place
    --shared-prefix-tier             fleet-level content-addressed prefix
                                     page tier: a replica that misses a
                                     cached prompt prefix locally adopts
                                     the pages a peer already computed
                                     instead of recomputing prefill
    --shed-policy {none,defer,slo,all}
                                     admission backpressure when EVERY
                                     admitting replica is over
                                     --shed-threshold: defer arrivals in
                                     place, shed best-effort traffic
                                     (slo), or shed everything
    --shed-threshold P               replica pressure (pool page / busy
                                     slot fraction) above which admission
                                     backpressure engages
    --probes                         numerics probes (DESIGN.md §14):
                                     per-layer activation-saturation,
                                     int32-accumulator-headroom, and int8-KV
                                     round-trip-error counters, counted
                                     inside the captured decode step; a
                                     summary block prints after the run
    --numerics-out PATH              write the full numerics summary JSON
                                     there after the run (needs --probes)
    --traffic {poisson,replay}       synthetic seeded Poisson arrivals, or
                                     a JSON trace from --trace-file
    --rate R                         poisson arrivals per virtual second
    --priority-levels N              priority classes 0..N-1 (uniform)
    --quantum N                      decode tokens per scheduling round
    --no-preempt                     disable preemption (head-of-line
                                     waits instead of swapping victims)
    --slo-ttft / --slo-tpot          per-request SLOs for the report

The weights come from ``init_params`` (a generator seeded with 0).  For the
same weights every printed line is the reference launcher's but for the
wall-clock figures (seconds, tok/s, ms/request) and the numerics KV error
(float K/V round differently, by about 1e-6).

Smoke runs on the CPU (drop ``--device cpu`` to run them on the GPU):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --compress --requests 8 --max-batch 4 --max-new 16 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --paged --kv-dtype int8 --requests 8 --max-batch 4 \
        --max-new 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --spec-draft ngram --spec-k 4 --requests 8 --max-new 24 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --server --traffic poisson --rate 40 --requests 16 \
        --paged --priority-levels 2 --slo-ttft 0.3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --server --replicas 3 --paged --rate 80 --requests 24 \
        --drain-at 0.4:r0 --scale-at 0.6:r3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --server --replicas 4 --paged --rate 120 --requests 32 \
        --migrate-on-drain --shared-prefix-tier --shed-policy slo \
        --drain-at 0.3:r0 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --compress --backend codebook --tp 2 --requests 8 \
        --max-new 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --compress --backend codebook --tp 2 --paged \
        --requests 8 --max-new 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-moe-30b-a3b --reduced --tp 2 --paged --requests 8 \
        --max-new 16 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --tp 2 --server --replicas 2 --paged --probes \
        --requests 8 --drain-at 0.1:r0 --migrate-on-drain --device cpu

With ``--tp N`` the parent builds (and compresses) the weights and prints
the ``[memory]`` row, hands the weights to the N ranks in a file, and
prints the report lines rank 0 made (``_serve_rank``), after checking that
every rank made the same lines but for the wall-clock figures (``WALL``).
Only rank 0 writes ``--metrics-out``, ``--trace-out`` and
``--numerics-out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import tempfile
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.core.export import kv_cache_bytes, memory_report
from repro_torch.core.quantizer import (cluster_params, codebook_indices,
                                        init_state)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh, run_ranks
from repro_torch.models.model_zoo import build
from repro_torch.serving import ServeEngine, SpecConfig, to_codebook_params


def init_params(model, device):
    """The launcher's weights: ``model.init`` drawn from a generator on
    ``device`` seeded with 0."""
    return model.init(torch.Generator(device=device).manual_seed(0), device)


# the wall-clock figures of the report lines (seconds, tok/s, ms/request)
WALL = re.compile(r"in \d+\.\d+s|\d+\.\d+ tok/s|\d+\.\d+ ms/request")


def report_numerics(engine, out_path="", write=True):
    """One-block probe summary (worst layer of each series) + optional
    full JSON dump — shared by batch and --server modes.  ``write`` False
    (a rank but the first) prints the same lines and dumps to
    ``os.devnull``."""
    num = engine.numerics()
    hr = min(num["headroom_bits"] or [31.0])
    sat = max(num["sat_rate"] or [0.0])
    kv = max(num["kv_err_max"] or [0.0])
    print(f"[numerics] {num['backend']}: {num['tokens']:.0f} tokens probed, "
          f"sat rate max {100 * sat:.2f}%, acc headroom min {hr:.1f} bits, "
          f"kv err max {kv:.4f}, page_oob {num['page_oob']:.0f}, "
          f"widx neg/oob {num['widx_neg']}/{num['widx_oob']}")
    if out_path:
        with open(out_path if write else os.devnull, "w") as f:
            json.dump(num, f, indent=1, sort_keys=True)
        print(f"[numerics] report -> {out_path}")


def _parse_at(specs, what):
    """['0.5:r0', ...] -> [(0.5, 'r0'), ...] for --drain-at/--scale-at."""
    out = []
    for s in specs:
        t, _, rep = s.partition(":")
        if not rep:
            raise SystemExit(f"{what} wants TIME:REPLICA, got {s!r}")
        out.append((float(t), rep))
    return out


def run_server(args, engine, cfg, mk_engine, write=True):
    """--server mode: drain a traffic trace through the scheduler (one
    Server, or a Fleet over --replicas of them) and report.  The ONLY
    wall-clock reads live here, outside serving/.  ``write`` False (a
    rank but the first) prints the same lines and exports to
    ``os.devnull``: every rank makes the same calls, since a snapshot
    reads the probes, which under a mesh is a collective."""
    from repro_torch.serving.server import Server, load_trace, poisson_trace

    if args.traffic == "replay":
        if not args.trace_file:
            raise SystemExit("--traffic replay needs --trace-file")
        trace = load_trace(args.trace_file)
    else:
        trace = poisson_trace(
            args.seed, args.requests, rate=args.rate, vocab=cfg.vocab,
            plen=(min(2, args.prompt_len), args.prompt_len),
            max_new=(min(2, args.max_new), args.max_new),
            priorities=tuple(range(args.priority_levels)),
            slo_ttft=args.slo_ttft, slo_tpot=args.slo_tpot)
    if not trace:
        raise SystemExit("--server got an empty trace (check --requests / "
                         "--trace-file)")
    tel = None
    if args.metrics_out or args.trace_out or args.probes:
        from repro_torch.serving.telemetry import Telemetry
        tel = Telemetry()
    fleet = None
    if (args.replicas > 1 or args.drain_at or args.scale_at
            or args.migrate_on_drain or args.shared_prefix_tier
            or args.shed_policy != "none"):
        from repro_torch.serving import Fleet
        engines = {f"r{i}": engine if i == 0 else mk_engine()
                   for i in range(args.replicas)}
        fleet = Fleet(engines, quantum=args.quantum, preempt=args.preempt,
                      telemetry=tel, policy=args.route_policy,
                      migrate_on_drain=args.migrate_on_drain,
                      shared_prefix_tier=args.shared_prefix_tier,
                      shed_policy=args.shed_policy,
                      shed_threshold=args.shed_threshold)
        scale = [(t, rep, mk_engine)
                 for t, rep in _parse_at(args.scale_at, "--scale-at")]
        t0 = time.perf_counter()
        rep = fleet.replay(trace,
                           drain_at=_parse_at(args.drain_at, "--drain-at"),
                           scale_at=scale)
        wall = time.perf_counter() - t0
    else:
        srv = Server(engine, quantum=args.quantum, preempt=args.preempt,
                     telemetry=tel)
        t0 = time.perf_counter()
        rep = srv.replay(trace)
        wall = time.perf_counter() - t0
    print(f"[server] {rep.n_requests} requests / {rep.n_tokens} tokens "
          f"drained in {wall:.2f}s wall ({rep.n_tokens / wall:.1f} tok/s), "
          f"virtual makespan {rep.makespan:.3f}s")
    print(f"[server] ttft p50/p99 {rep.p50_ttft:.3f}/{rep.p99_ttft:.3f}s, "
          f"tpot p50/p99 {rep.p50_tpot:.3f}/{rep.p99_tpot:.3f}s "
          f"(virtual clock)")
    print(f"[server] {rep.preemptions} preemptions, "
          f"{rep.pages_swapped_out} pages swapped out / "
          f"{rep.pages_swapped_in} back in, SLO attainment "
          f"{100 * rep.slo_attainment:.0f}%")
    print(f"[server] admission order: {rep.admission_order}")
    if fleet is not None:
        for r, s in sorted(fleet.replica_stats().items()):
            print(f"[fleet] {r}: {s['routed']} routed"
                  + (", draining" if s["draining"] else "")
                  + f", {s['preemptions']} preemptions, swap out/in "
                  f"{s['pages_swapped_out']}/{s['pages_swapped_in']} pages"
                  + (f", {s['migrated_out']} migrated out"
                     if s["migrated_out"] else ""))
        if args.migrate_on_drain:
            print(f"[fleet] drain migration: {fleet.n_migrated} requests / "
                  f"{fleet.n_migrated_pages} KV pages rehomed to survivors")
        if args.shed_policy != "none":
            print(f"[fleet] backpressure ({args.shed_policy} @ "
                  f"{args.shed_threshold:.2f}): {rep.n_shed} requests shed, "
                  f"{fleet.n_deferred} deferred")
        tier = fleet.shared_tier_stats()
        if tier is not None:
            print(f"[fleet] shared prefix tier: {tier['hits']} page hits / "
                  f"{tier['misses']} misses, {tier['puts']} puts, "
                  f"{tier['evictions']} evictions, {tier['entries']} entries "
                  f"({tier['bytes'] / 1e6:.2f}MB)")
        if engine.paged:
            print(f"[fleet] routing policy {args.route_policy}: fleet-wide "
                  f"prefix hit rate {100 * fleet.prefix_hit_rate():.0f}%, "
                  f"event digest {fleet.event_digest()[:16]}")
    elif engine.paged:
        st = engine.pool.stats
        print(f"[kv] pool peak {st.peak_pages_in_use}/"
              f"{engine.pool.usable_pages} pages, prefix hit rate "
              f"{100 * st.hit_rate:.0f}%, swap out/in "
              f"{st.swapped_out_pages}/{st.swapped_in_pages} pages")
    if tel is not None:
        if args.metrics_out:
            tel.export_metrics(args.metrics_out if write else os.devnull)
            print(f"[telemetry] metrics snapshot -> {args.metrics_out}")
        if args.trace_out:
            tel.export_trace(args.trace_out if write else os.devnull)
            print(f"[telemetry] Perfetto trace -> {args.trace_out} "
                  "(open at https://ui.perfetto.dev)")
        print(tel.summary())
    if args.probes:
        report_numerics(engine, args.numerics_out, write)
    # request 0 may have been shed under backpressure; sample any survivor
    h = (next(iter(fleet.handles.values())) if fleet is not None
         else srv.sched.handles[0])
    print("sample:", h.prompt, "->", h.tokens)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--backend", default="dense",
                    choices=("dense", "codebook", "lut"))
    ap.add_argument("--n-weights", type=int, default=1000)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--uniform", action="store_true",
                    help="fixed-batch generate() instead of the slot pool")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: chunked prefill, prefix caching, "
                         "page-gated admission (serve() only)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"))
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--spec-draft", default="none",
                    choices=("none", "ngram", "model"),
                    help="speculative decoding draft (DESIGN.md §9)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per verify round")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (DESIGN.md §10)")
    ap.add_argument("--server", action="store_true",
                    help="request-server mode (DESIGN.md §11): drain a "
                         "traffic trace through the AsyncScheduler")
    ap.add_argument("--traffic", default="poisson",
                    choices=("poisson", "replay"))
    ap.add_argument("--rate", type=float, default=40.0,
                    help="poisson arrivals per virtual second")
    ap.add_argument("--trace-file", default="",
                    help="JSON trace for --traffic replay "
                         "(serving.server.save_trace format)")
    ap.add_argument("--priority-levels", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=1,
                    help="--server only: serve through a FleetRouter over "
                         "N independent engine replicas (DESIGN.md §15)")
    ap.add_argument("--route-policy", default="prefix",
                    choices=("prefix", "round_robin"),
                    help="fleet routing: longest cached prompt prefix "
                         "(ties: load, then free pages) or round-robin")
    ap.add_argument("--drain-at", action="append", default=[],
                    metavar="T:REP",
                    help="drain replica REP at virtual time T (repeatable), "
                         "e.g. --drain-at 0.5:r0")
    ap.add_argument("--scale-at", action="append", default=[],
                    metavar="T:REP",
                    help="join a fresh replica named REP at virtual time T "
                         "(repeatable), e.g. --scale-at 0.8:r4")
    ap.add_argument("--migrate-on-drain", action="store_true",
                    help="drained replicas expel queued/preempted/running "
                         "requests (KV swap blobs included) and the router "
                         "rehomes them to survivors")
    ap.add_argument("--shared-prefix-tier", action="store_true",
                    help="fleet-level content-addressed prefix page tier: "
                         "local prefix misses adopt pages a peer computed "
                         "instead of recomputing prefill (needs --paged)")
    ap.add_argument("--shed-policy", default="none",
                    choices=("none", "defer", "slo", "all"),
                    help="admission backpressure when every admitting "
                         "replica is over --shed-threshold")
    ap.add_argument("--shed-threshold", type=float, default=0.95,
                    help="replica pressure in [0, 1] above which "
                         "--shed-policy engages")
    ap.add_argument("--quantum", type=int, default=1,
                    help="decode tokens per scheduling round")
    ap.add_argument("--preempt", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--slo-ttft", type=float, default=None)
    ap.add_argument("--slo-tpot", type=float, default=None)
    ap.add_argument("--metrics-out", default="",
                    help="--server only: write the telemetry registry "
                         "snapshot (canonical JSON) here after the drain")
    ap.add_argument("--trace-out", default="",
                    help="--server only: write a Perfetto/Chrome "
                         "trace.json of request/slot lifecycle spans "
                         "(virtual-clock time) here after the drain")
    ap.add_argument("--probes", action="store_true",
                    help="in-graph numerics probes (DESIGN.md §14): "
                         "saturation / accumulator-headroom / KV-error "
                         "counters threaded through the jitted decode")
    ap.add_argument("--numerics-out", default="",
                    help="write the numerics summary JSON here after the "
                         "run (needs --probes)")
    ap.add_argument("--seed", type=int, default=0,
                    help="traffic/workload PRNG seed")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the GPU, and "
                         "fail without one; 'cpu' runs the kernels' plain "
                         "PyTorch versions)")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.paged and args.uniform:
        ap.error("--paged serves through the slot pool; drop --uniform")
    if args.spec_draft != "none" and args.uniform:
        ap.error("speculative decoding runs through serve(); drop --uniform")
    if args.spec_draft == "model" and not args.compress:
        ap.error("--spec-draft model drafts with the compressed params "
                 "through the lut backend; add --compress")
    if args.server and args.uniform:
        ap.error("--server schedules through the slot pool; drop --uniform")
    if args.server and args.spec_draft != "none":
        ap.error("the scheduler drives plain decode rounds; drop "
                 "--spec-draft for --server")
    if (args.metrics_out or args.trace_out) and not args.server:
        ap.error("--metrics-out/--trace-out report the scheduler drain; "
                 "add --server")
    if args.numerics_out and not args.probes:
        ap.error("--numerics-out reports the probe counters; add --probes")
    if ((args.replicas > 1 or args.drain_at or args.scale_at
         or args.migrate_on_drain or args.shared_prefix_tier
         or args.shed_policy != "none") and not args.server):
        ap.error("--replicas/--drain-at/--scale-at/--migrate-on-drain/"
                 "--shared-prefix-tier/--shed-policy drive the fleet "
                 "router; add --server")
    if args.replicas < 1:
        ap.error("--replicas wants at least 1")
    if args.shared_prefix_tier and not args.paged:
        ap.error("--shared-prefix-tier shares prefix PAGES; add --paged")
    if not 0.0 <= args.shed_threshold <= 1.0:
        ap.error("--shed-threshold wants a pressure fraction in [0, 1]")
    if args.probes and args.spec_draft != "none":
        ap.error("numerics probes instrument the plain decode loops; drop "
                 "--spec-draft for --probes")
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.tp > 1:
        _check_tp(ap, args)
    dev = resolve_device(args.device)
    model = build(cfg)
    params = init_params(model, dev)

    if args.compress:
        wq = cfg.quantized(n_weights=args.n_weights).wq
        params, qstate = cluster_params(params, wq, init_state(wq),
                                        wq.interval)
        cparams = to_codebook_params(params, wq, qstate)
        idx_tree, _ = codebook_indices(params, wq, qstate)
        del params
        # end-to-end claim: weights AND serving state (dense float slab vs
        # the paged int8 cache sized for the actual tokens in flight)
        max_len = args.prompt_len + args.max_new + 8
        fpb = 4 if cfg.dtype == "float32" else 2
        kv_fp = kv_cache_bytes(cfg.n_layers, cfg.n_kv, cfg.hd,
                               args.max_batch * max_len, dtype_bytes=fpb)
        # page rounding is per request (each reserves whole pages), not on
        # the aggregate token count
        kv_packed = min(args.requests, args.max_batch) * kv_cache_bytes(
            cfg.n_layers, cfg.n_kv, cfg.hd,
            args.prompt_len + args.max_new,
            quant=True, page_size=args.page_size)
        rep = memory_report(idx_tree, wq.num_weights, max(cfg.act_levels, 32),
                            kv_fp_bytes=kv_fp, kv_packed_bytes=kv_packed)
        del idx_tree
        print("[memory]", rep.row())
        params = cparams
    elif args.backend != "dense":
        ap.error(f"--backend {args.backend} needs --compress (index-form "
                 "weights)")

    spec = None
    if args.spec_draft != "none":
        spec = SpecConfig(
            draft=args.spec_draft, k=args.spec_k,
            # the model draft is the paper's lower tier: the SAME index-form
            # params contracted through a coarse integer grid
            draft_params=params if args.spec_draft == "model" else None,
            draft_backend="lut", lut_levels=512)
    max_len = (args.prompt_len + args.max_new + 8
               + (args.spec_k if spec else 0))
    max_len += (-max_len) % args.tp       # the cache S axis shards over tp
    if args.tp > 1:
        for line in _serve_tp(args, cfg, params, spec, max_len, dev):
            print(line)
        return

    def mk_engine():
        return _engine(args, model, params, spec, max_len, dev)

    engine = mk_engine()
    if args.server:
        run_server(args, engine, cfg, mk_engine)
        return
    serve_batch(args, engine, spec, dev)


def _engine(args, model, params, spec, max_len: int, dev, mesh=None):
    """The engine the flags ask for (a tensor-parallel rank's with
    ``mesh``)."""
    return ServeEngine(model, params, max_len=max_len,
                       temperature=args.temperature, backend=args.backend,
                       max_batch=args.max_batch, paged=args.paged,
                       page_size=args.page_size, kv_dtype=args.kv_dtype,
                       prefix_cache=args.prefix_cache, top_k=args.top_k,
                       top_p=args.top_p, spec=spec, probes=args.probes,
                       device=dev, mesh=mesh)


def serve_batch(args, engine, spec, dev, write=True):
    """The batch mode: a warm-up call, then the timed ``serve`` (or
    ``generate`` under --uniform) of --requests seeded prompts, and its
    report lines (``write`` as ``report_numerics``'s)."""
    cfg = engine.model.cfg
    rng = np.random.default_rng(args.seed)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, args.prompt_len)]
               for _ in range(args.requests)]

    # the same call warms up first: on the GPU it runs the eager steps and
    # captures the decode graphs, which the timed call replays
    warm = engine.generate if args.uniform else engine.serve
    warm(prompts, args.max_new)
    if args.paged:
        engine.pool.reset_stats()
    if spec is not None:
        engine.spec_stats.reset()
    if args.probes:
        engine.reset_probes()          # count only the timed run below

    t0 = time.perf_counter()
    if args.uniform:
        outs = engine.generate(prompts, max_new=args.max_new)
    else:
        outs = engine.serve(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0
    toks = args.requests * args.max_new
    mode = "uniform" if args.uniform else f"slots={args.max_batch}"
    if args.paged:
        mode += f", paged({args.page_size}t/{args.kv_dtype})"
    print(f"[serve] {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s on "
          f"{dev.type}, backend={args.backend}, {mode}, "
          f"{dt / args.requests * 1e3:.1f} ms/request)")
    if args.paged:
        st, pool = engine.pool.stats, engine.pool
        # the whole pool's bytes: a tensor-parallel rank's pool is its
        # in-page slice, 1/shards of each page
        page_b = pool.bytes_per_page() * pool.shards
        print(f"[kv] paged pool: peak "
              f"{st.peak_pages_in_use}/{pool.usable_pages} pages "
              f"({page_b * st.peak_pages_in_use / 1e6:.3f}MB"
              f" peak vs {engine.dense_cache_bytes() / 1e6:.3f}MB dense slab), "
              f"prefix hit rate {100 * st.hit_rate:.0f}%, "
              f"{st.cow_copies} CoW, {st.evictions} evictions"
              + (f", {st.truncated_pages} pages rolled back"
                 if spec else ""))
    if spec is not None:
        ss = engine.spec_stats
        print(f"[spec] {args.spec_draft} draft, k={args.spec_k}: "
              f"{ss.rounds} rounds, acceptance "
              f"{100 * ss.acceptance_rate:.0f}%, "
              f"{ss.tokens_per_round:.1f} tokens/round")
    if args.probes:
        report_numerics(engine, args.numerics_out, write)
    print("sample:", outs[0][:args.prompt_len], "->",
          outs[0][args.prompt_len:])


# --- tensor parallelism ------------------------------------------------------

def _check_tp(ap, args) -> None:
    """The reference's --page-size check (argparse's exit code 2)."""
    if args.paged and args.page_size % args.tp:
        ap.error(f"--page-size {args.page_size} must be a multiple of "
                 f"--tp {args.tp} (each shard owns an S-slice of every "
                 "page)")


def _serve_tp(args, cfg, params, spec, max_len: int, dev) -> list:
    """Serve through ``args.tp`` ranks (``run_ranks``: spawned processes
    over gloo), the weights handed over in a file (a model draft's too:
    the same tree, whole on every rank); returns the report lines rank 0
    made, after holding every rank's to them but for the wall-clock
    figures (``WALL``)."""
    if spec is not None:
        spec = dataclasses.replace(spec, draft_params=None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params.pt")
        torch.save(params, path)
        outs = run_ranks(_serve_rank, args.tp,
                         (args, cfg, path, spec, max_len, dev.type),
                         tmp_dir=tmp)
    return ranks_agree(outs)


def ranks_agree(outs: list) -> list:
    """Rank 0's report lines (``outs[0]``), once every rank's equal them
    but for the wall-clock figures (``WALL``); a rank whose lines part
    raises ``RuntimeError`` naming its first differing line."""
    want = [WALL.sub("<wall>", ln) for ln in outs[0]]
    for rank, lines in enumerate(outs[1:], 1):
        got = [WALL.sub("<wall>", ln) for ln in lines]
        if got != want:
            a, b = next(((a, b) for a, b in zip(got, want) if a != b),
                        (f"{len(got)} lines", f"{len(want)}"))
            raise RuntimeError(f"rank {rank}'s report parts from rank 0's: "
                               f"{a!r} against {b!r}")
    return outs[0]


def _serve_rank(rank: int, args, cfg, path: str, spec, max_len: int,
                dev_type: str) -> list:
    """One rank of ``--tp``: a (1, tp) mesh, the weights on this rank's
    device (cuda:(rank % cards), or the CPU), a tensor-parallel engine
    (a model draft on the same weights, whole) and the batch mode, or
    --server with every replica's engine on this rank's mesh; returns its
    printed lines.  Only rank 0 writes the report files."""
    dev = (torch.device("cuda", rank % torch.cuda.device_count())
           if dev_type == "cuda" else torch.device("cpu"))
    mesh = make_local_mesh(1, args.tp)
    params = torch.load(path, map_location=dev, weights_only=True)
    if spec is not None and spec.draft == "model":
        spec = dataclasses.replace(spec, draft_params=params)
    model = build(cfg)

    def mk_engine():
        return _engine(args, model, params, spec, max_len, dev, mesh)

    engine = mk_engine()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if args.server:
            run_server(args, engine, cfg, mk_engine, write=rank == 0)
        else:
            serve_batch(args, engine, spec, dev, write=rank == 0)
    return buf.getvalue().splitlines()


if __name__ == "__main__":
    main()
