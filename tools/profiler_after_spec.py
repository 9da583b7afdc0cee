#!/usr/bin/env python3
"""Which serve leaves the next torch.profiler sessions without device
activity: a bisection on the card.

    python3 tools/profiler_after_spec.py [--layers 28] [--sessions 4]
        [--cases default,full_n,...]

Builds the kernels once, then runs one child process a case, each with a
CUDA context of its own.  A child makes qwen3-1.7b at full width
(``--layers`` of its layers, random weights from a seed, compressed to
|W| = 1000), takes two profiler sessions of a probe, then runs its
triggers in order, each followed by ``--sessions`` sessions of the probe.
A session is taken as ``chip_smoke.py``'s ``kernel_ms`` takes one (host
and device activity, 50 ms idle before and after, three probe calls); the
probe is ``ops.kmeans_stats`` on 2^28 values, which reads its overflow
flag back, and one ``codebook_matmul`` at 4 x 2048 x 6144.  A session
counts the device events that start after a host mark set just before
the probe's calls; it is empty when it holds none.

Triggers:

* ``base_graph``: a codebook engine's graph serve, 4 requests x 8 tokens;
  ``spec_ngram_eager``, ``spec_ngram_graph``, ``spec_lut_graph``: a
  codebook target with an n-gram or lut draft, k = 4, the same requests;
  each engine freed before the sessions; ``spec_lut_kept``: the last, its
  engine and graphs alive during the sessions;
* ``kmeans_big``: 20 unprofiled ``kmeans_stats`` calls on 2^30 values;
  ``probe_full_n``: the probe's kmeans_stats from then on at the working
  point's n = 1.72e9, as ``chip_smoke.py`` times the clustering event;
* ``cycles``: 20 times a baseline and a lut-draft spec engine made,
  served on the graph route and freed, two sessions after every fifth;
  ``cycles_base``, ``cycles_spec``: the baseline or the spec engine
  alone; ``cycles_eager``: both, served eagerly;
* ``trivial_destroy``, ``trivial_keep``: 200 CUDA graphs of one
  elementwise op captured and replayed, each destroyed after its replay
  or all kept alive, two sessions after every fiftieth;
* ``idle``: 100 s asleep, two sessions every 25 s; ``idle_margins``: the
  same with 0.05 and with 0.3 s idle before and after the calls;
  ``idle_warm``: three sessions as they are and three that first launch
  512 tiny kernels inside the session, before the probe's mark;
* ``launches``: 4 million launches of one tiny elementwise kernel, two
  sessions after every million.

The cases (``CASES``) run these under the default environment, in two
orders, and under ``TEARDOWN_CUPTI=0`` (torch's own setting when
``torch.compile`` captures CUDA graphs: CUPTI is then not torn down after
each session), set before the process starts or (``no_teardown_late``)
by the process itself after its first two sessions.

Prints each case's lines as it ends and, last, one JSON object {case:
{trigger: [device events a session]}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = ("base_graph", "spec_ngram_eager", "spec_ngram_graph",
       "spec_lut_graph", "spec_lut_kept", "kmeans_big")
LONG = ("probe_full_n", "spec_lut_graph", "cycles")
CASES = {
    "default": ({}, ALL),
    "default_spec_first": ({}, ("spec_lut_graph", "spec_ngram_graph",
                                "base_graph", "kmeans_big")),
    "no_teardown": ({"TEARDOWN_CUPTI": "0"}, ALL),
    "no_teardown_late": ({"LATE": "1"}, ALL),
    "full_n": ({}, LONG),
    "full_n_no_teardown": ({"TEARDOWN_CUPTI": "0"}, LONG),
    "cycles_base": ({}, ("cycles_base",)),
    "cycles_spec": ({}, ("cycles_spec",)),
    "cycles_eager": ({}, ("cycles_eager",)),
    "trivial_destroy": ({}, ("trivial_destroy",)),
    "trivial_keep": ({}, ("trivial_keep",)),
    "idle": ({}, ("idle",)),
    "idle_margins": ({}, ("idle_margins",)),
    "idle_warm": ({}, ("idle_warm",)),
    "launches": ({}, ("launches",)),
}


def child(layers: int, sessions: int, triggers: list[str]) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.kernels import ops
    from repro_torch.kernels.kmeans1d import finite_extremes
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine, SpecConfig, \
        to_codebook_params

    dev = torch.device("cuda", 0)
    cfg = configs.get("qwen3-1.7b").replace(n_layers=layers)
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    wq = cfg.quantized(n_weights=1000).wq
    pq, state = cluster_params(params, wq, init_state(wq), wq.interval)
    cp = to_codebook_params(pq, wq, state)
    del params, pq
    g = torch.Generator(device=dev).manual_seed(1)
    v = torch.randn(1 << 28, device=dev, generator=g)
    c = torch.linspace(-3, 3, 1000, device=dev)
    ext = finite_extremes(v)
    x = torch.randn(4, 2048, device=dev, generator=g).to(torch.bfloat16)
    w1 = cp["blocks"]["mlp"]["w1"]
    wi, book = w1["w_idx"][0], w1["codebook"][0]

    arrays = [v, ext]

    def probe():
        ops.kmeans_stats(arrays[0], c, arrays[1])
        ops.codebook_matmul(x, wi, book)

    seen = {}

    spare = torch.zeros(16, device=dev)

    def session(margin: float = 0.05, warm: int = 0) -> int:
        """Device events in one session with ``margin`` seconds idle before
        and after the probe calls; the kinds it lacks against the first
        session's are kept in ``seen["missing"]``, and in
        ``seen["shift_ms"]`` the first device event's start less the start
        of the host's mark around the calls (a device event cannot start
        before its launch: a negative shift is the profiler's placement
        of device time against host time)."""
        from torch.profiler import record_function
        probe()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(warm):
                spare.add_(1.0)
            time.sleep(margin)
            with record_function("probe_mark"):
                for _ in range(3):
                    probe()
                torch.cuda.synchronize()
            time.sleep(margin)
        evs = prof.events()
        mark = [e.time_range.start for e in evs if e.name == "probe_mark"]
        dev_starts = [e.time_range.start for e in evs
                      if e.device_type == DeviceType.CUDA]
        seen["shift_ms"] = (round((min(dev_starts) - mark[0]) / 1e3, 3)
                            if mark and dev_starts else None)
        kinds = {}
        for e in evs:                # the probe's: from the mark on
            if e.device_type == DeviceType.CUDA and mark \
                    and e.time_range.start >= mark[0]:
                kinds[e.name[:40]] = kinds.get(e.name[:40], 0) + 1
        first = seen.setdefault("first", kinds)
        seen["missing"] = {k: n - kinds.get(k, 0) for k, n in first.items()
                           if kinds.get(k, 0) != n}
        return sum(kinds.values())

    reqs = [[(7 * i + 3 * j) % 5000 + 11 for j in range(5 + 3 * i)]
            for i in range(2)] + [[101, 202, 303] * 5, [17] * 9]

    def engine(draft):
        sp = None if draft is None else (
            SpecConfig(draft="ngram", k=4) if draft == "ngram" else
            SpecConfig(draft="model", k=4, draft_params=cp,
                       draft_backend="lut"))
        return ServeEngine(model, cp, backend="codebook", max_len=128,
                           max_batch=4, device=dev, spec=sp)

    kept = []

    def run(trigger: str) -> None:
        if trigger == "probe_full_n":
            big = torch.randn(1_720_000_000, device=dev, generator=g)
            arrays[:] = [big, finite_extremes(big)]
            return
        if trigger in ("idle", "idle_margins", "idle_warm"):
            for i in range(4):
                time.sleep(25)
                line = f"  {25 * (i + 1)} s idle: device events a session"
                for m, w in ({"idle": ((0.05, 0),),
                              "idle_margins": ((0.05, 0), (0.3, 0)),
                              "idle_warm": ((0.05, 0), (0.05, 512))}
                             [trigger]):
                    got = []
                    for _ in range(3 if trigger == "idle_warm" else 2):
                        got.append((session(m, w), seen["shift_ms"]))
                    line += (f"; margin {m} s, {w} warm-up launches "
                             f"(events, shift ms) {got}")
                print(line, flush=True)
            return
        if trigger == "launches":
            y = torch.zeros(16, device=dev)
            for i in range(4):
                for _ in range(1_000_000):
                    y.add_(1.0)
                torch.cuda.synchronize()
                print(f"  {i + 1}M launches: device events a session "
                      f"{[session() for _ in range(2)]}", flush=True)
            return
        if trigger.startswith("trivial"):
            y = torch.zeros(1 << 20, device=dev)
            for i in range(200):
                side = torch.cuda.Stream(dev)
                with torch.cuda.stream(side):
                    gr = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(gr, stream=side):
                        y.mul_(0.5).add_(1.0)
                gr.replay()
                if trigger == "trivial_keep":
                    kept.append(gr)
                del gr
                if i % 50 == 49:
                    print(f"  graph {i + 1}: device events a session "
                          f"{[session() for _ in range(2)]}", flush=True)
            return
        if trigger.startswith("cycles"):
            drafts = {"cycles": (None, "lut"), "cycles_base": (None,),
                      "cycles_spec": ("lut",),
                      "cycles_eager": (None, "lut")}[trigger]
            for i in range(20):
                for draft in drafts:
                    e = engine(draft)
                    e._graphs = trigger != "cycles_eager"
                    e.serve(reqs, max_new=8)
                    del e
                    gc.collect()
                    torch.cuda.empty_cache()
                if i % 5 == 4:
                    print(f"  cycle {i + 1}: device events a session "
                          f"{[session() for _ in range(2)]}; missing "
                          f"{seen['missing']}", flush=True)
            return
        if trigger == "kmeans_big":
            big = torch.randn(1 << 30, device=dev, generator=g)
            for _ in range(20):
                ops.kmeans_stats(big, c, finite_extremes(big))
            torch.cuda.synchronize()
            return
        draft = {"base_graph": None, "spec_ngram_eager": "ngram",
                 "spec_ngram_graph": "ngram", "spec_lut_graph": "lut",
                 "spec_lut_kept": "lut"}[trigger]
        e = engine(draft)
        e._graphs = trigger != "spec_ngram_eager"
        e.serve(reqs, max_new=8)
        torch.cuda.synchronize()
        if trigger == "spec_lut_kept":
            kept.append(e)

    out = {"start": [session() for _ in range(2)]}
    print(f"start: device events a session {out['start']}", flush=True)
    if os.environ.get("LATE"):
        os.environ["TEARDOWN_CUPTI"] = "0"
    for trig in triggers:
        t = time.time()
        run(trig)
        secs = time.time() - t
        out[trig] = [session() for _ in range(sessions)]
        print(f"after {trig} ({secs:.1f} s): device events a session "
              f"{out[trig]}; missing in the last {seen['missing']}",
              flush=True)
        kept.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated cases to run (default: all)")
    ap.add_argument("--child", default=None,
                    help="comma-separated triggers: run them in this process")
    args = ap.parse_args()
    if args.child is not None:
        res = child(args.layers, args.sessions, args.child.split(","))
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("profiler_after_spec: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    summary = {}
    for case in args.cases.split(","):
        env, triggers = CASES[case]
        t = time.time()
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--layers",
             str(args.layers), "--sessions", str(args.sessions), "--child",
             ",".join(triggers)], env={**os.environ, **env},
            capture_output=True, text=True, cwd=ROOT, timeout=600)
        res = next((json.loads(ln[7:]) for ln in p.stdout.splitlines()
                    if ln.startswith("RESULT ")), None)
        summary[case] = res if res is not None else {
            "exit": p.returncode, "stderr": p.stderr[-2000:]}
        lines = [f"== {case} {env} ({time.time() - t:.1f} s, exit "
                 f"{p.returncode})"]
        lines += [ln for ln in p.stdout.splitlines()
                  if not ln.startswith("RESULT ")]
        if p.returncode:
            lines.append(p.stderr[-3000:])
        print("\n".join(lines), flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
