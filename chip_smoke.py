#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. environment: card name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` kernel compiled with nvcc for sm_90a, in
   parallel;
3. kernel parity: each kernel against its plain PyTorch version at every
   row count the main path gives it and every (K, N) site of the model
   (lut bit-exact, codebook within 16 × a summation-order estimate, which
   weights left unrounded to bf16 must fail);
4. main path: qwen3-1.7b at full width and depth, random weights from a
   seeded generator, compressed to |W| = 1000 (laplacian_l1, global) and
   served through ``ServeEngine.serve``/``generate`` with the codebook and
   lut backends, kernel launch counts checked, logits held against the
   dense backend, and a reduced model held against the CPU path;
5. kernel timings at the decode (M=4) and prefill (M=32) shapes, with the
   bound, the plain version's and the library call's times.

The last two lines are the kernels JSON and ``{"ok": true, "device": ...}``.
Exits non-zero without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks of the H100 SXM (NVIDIA data sheet, dense, at 700 W).
# int32 is not on the data sheet: 132 SMs × 64 INT32 lanes × the 1.98 GHz
# boost clock of the Hopper white paper.
H100_SXM = {"bytes": 3.35e12, "bf16": 989e12, "f32": 67e12,
            "int32": 132 * 64 * 1.98e9}
TPU_KERNELS = {
    "codebook_matmul": "src/repro/kernels/codebook_matmul.py:55",
    "lut_matmul": "src/repro/kernels/lut_matmul.py:58",
}
SITES = {"wq": (2048, 2048), "wk": (2048, 1024), "wv": (2048, 1024),
         "wo": (2048, 2048), "w1": (2048, 6144), "w3": (2048, 6144),
         "w2": (6144, 2048)}
MAIN_SHAPE = (4, 2048, 6144)     # the JSON's headline: decode, w1/w3 site
N_BOOK = 1000
MAX_BATCH = 4
LEVELS = 4096


def log(*a):
    print(*a, flush=True)


def peaks_for(name: str) -> dict:
    """The published peaks of the card, which bound_ms divides by."""
    if "H100" in name and "HBM3" in name:
        return H100_SXM
    raise RuntimeError(f"no published peaks for {name!r}: bound_ms is "
                       "computed for the H100 SXM only")


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# --- phase 3: kernel parity --------------------------------------------------

def path_rows(prompts, max_batch: int) -> list[int]:
    """Every row count M the main path gives the kernels: decode over
    ``max_batch`` slots, serve's one-request prefills at each prompt's
    bucket, generate's and the logits check's prefill of the first four
    prompts, the timed 1 × 32 prefill, and a single row."""
    from repro_torch.serving.engine import _bucket
    rows = {1, max_batch, 32, 4 * _bucket(max(len(p) for p in prompts[:4]))}
    return sorted(rows | {_bucket(len(p)) for p in prompts})


def parity(dev, rows) -> dict:
    """Each kernel against its plain version at every M of ``rows`` and
    every (K, N) site of the model, so every rows-per-block instance and
    K split the main path takes is checked: lut bit-exact, codebook within
    ``parity_tolerance`` (16 × the summation-order estimate), which the
    plain version without the cast of weights to bf16 must fail."""
    import torch
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels._common import canonical_idx
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"codebook_matmul": 0.0, "lut_matmul": 0.0}
    share = 0.0                                # worst err / limit
    cases = [(M, K, N) for M in rows for K, N in sorted(set(SITES.values()))]
    cases.append((3, 100, 130))                       # ragged edges
    for M, K, N in cases:
        for idt, W in ((torch.int8, 256), (torch.int16, N_BOOK)):
            if idt == torch.int8:                     # ids ≥ 128 negative
                wi = torch.randint(-128, 128, (K, N), generator=g,
                                   device=dev).to(idt)
            else:
                wi = torch.randint(0, W, (K, N), generator=g,
                                   device=dev).to(idt)
            book = torch.randn(W, generator=g, device=dev) * 0.05
            for xdt in (torch.float32, torch.bfloat16):
                x = torch.randn(M, K, generator=g, device=dev).to(xdt)
                got = cm.codebook_matmul_cuda(x, wi, book)
                want = cm.codebook_matmul_plain(x, wi, book)
                tol = cm.parity_tolerance(x, wi, book)
                err = (got - want).abs()
                s = (err / tol).max().item()
                if s > 1:
                    raise AssertionError(
                        f"codebook_matmul M={M} K={K} N={N} {idt} {xdt}: "
                        f"max err {err.max().item()} at {s:.3f} of the "
                        "limit")
                share = max(share, s)
                worst["codebook_matmul"] = max(worst["codebook_matmul"],
                                               err.max().item())
                if xdt == torch.bfloat16:
                    no_cast = x.float() @ book[canonical_idx(wi, W).long()]
                    if bool(((no_cast - want).abs() <= tol).all()):
                        raise AssertionError(
                            f"M={M} K={K} N={N} {idt}: the codebook limit "
                            "passes weights left unrounded to bf16")
            a = torch.randint(0, LEVELS, (M, K), generator=g, device=dev,
                              dtype=torch.int32)
            tab = torch.randint(-(1 << 20), 1 << 20, (LEVELS, W), generator=g,
                                device=dev, dtype=torch.int32)
            got = lm.lut_matmul_cuda(a, wi, tab)
            want = lm.lut_matmul_plain(a, wi, tab)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"lut_matmul M={M} K={K} N={N} {idt}: "
                                     "not bit-exact")
    # overflow-adjacent: |T| near 2^25, 2048 terms → sums wrap int32
    a = torch.randint(0, 9, (5, 2048), generator=g, device=dev,
                      dtype=torch.int32)
    wi = torch.randint(-128, 128, (2048, 70), generator=g, device=dev
                       ).to(torch.int8)
    tab = torch.randint(-(1 << 25), 1 << 25, (9, 256), generator=g,
                        device=dev, dtype=torch.int32)
    if not torch.equal(lm.lut_matmul_cuda(a, wi, tab),
                       lm.lut_matmul_plain(a, wi, tab)):
        raise AssertionError("lut_matmul overflow-adjacent case not exact")
    log(f"[parity] M in {rows} × {len(set(SITES.values()))} (K, N) sites, "
        f"and M=3 K=100 N=130; int8/int16 ids × f32/bf16 x: codebook max "
        f"abs err {worst['codebook_matmul']:.3e}, at most {share:.4f} of "
        f"its limit ({16 * share:.3f} × the summation-order estimate); "
        f"uncast weights fail the limit in every bf16 case; lut bit-exact "
        f"incl. wrap-around")
    return worst


# --- phase 4: the main path ---------------------------------------------------

def prompts_for(n: int, vocab: int):
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(8, 49, n)
    return [rng.integers(0, vocab, int(n_)).tolist() for n_ in lens]


def reduced_against_cpu(dev):
    """A reduced qwen3 (2 layers, f32, |W|=256) through every backend on
    the card and on the CPU: greedy tokens must agree."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import (WeightQuantConfig,
                                            cluster_params, init_state)
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine, to_codebook_params
    cfg = configs.get("qwen3-1.7b").reduced().replace(n_layers=2)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    wq = WeightQuantConfig(num_weights=256)
    pq, st = cluster_params(params, wq, init_state(wq), wq.interval)
    cp = to_codebook_params(pq, wq, st, min_size=1024)
    cp_dev = _to(cp, dev)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 11]
    for be in ("dense", "codebook", "lut"):
        on_cpu = ServeEngine(model, cp, max_len=64, backend=be,
                             device="cpu").generate(prompts, max_new=8)
        on_dev = ServeEngine(model, cp_dev, max_len=64, backend=be,
                             device=dev).generate(prompts, max_new=8)
        if on_cpu != on_dev:
            raise AssertionError(f"reduced model, {be}: card tokens "
                                 f"{on_dev} != CPU tokens {on_cpu}")
    log("[reduced] 2-layer qwen3: dense/codebook/lut tokens on the card "
        "equal the CPU path's")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def device_time(fn, top: int = 5):
    """Device time of one call from torch.profiler's CUDA activity:
    (busy ms summed over kernels and copies, [(name, ms, count)] of the
    largest).  Busy time over wall time gives the device's idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op (aten::index) also carries the
    # device time of the kernel it launched, which would count it twice
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    evs.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    return busy, [(e.key[:48], e.self_device_time_total / 1e3, e.count)
                  for e in evs[:top]]


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def main_path(dev, prompts) -> tuple[dict, dict]:
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine, to_codebook_params

    cfg = configs.get("qwen3-1.7b")
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    (params, t_init) = timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    wq = cfg.quantized(n_weights=N_BOOK).wq
    (pq_st, t_cl) = timed(lambda: cluster_params(params, wq, init_state(wq),
                                                 wq.interval))
    del params
    pq, state = pq_st
    cp, t_cp = timed(lambda: to_codebook_params(pq, wq, state))
    del pq
    w1 = cp["blocks"]["mlp"]["w1"]
    assert w1["w_idx"].dtype == torch.int16, w1["w_idx"].dtype
    assert tuple(w1["w_idx"].shape) == (28, 2048, 6144)
    assert tuple(w1["codebook"].shape) == (28, N_BOOK)
    assert tuple(cp["embed"]["w_idx"].shape) == (152064, 2048)
    log(f"[main] qwen3-1.7b {cfg.n_layers}L d={cfg.d_model} ff={cfg.d_ff} "
        f"vocab={cfg.vocab} (padded {cfg.padded_vocab}) {cfg.dtype}: init "
        f"{t_init:.2f}s, cluster {t_cl:.2f}s, to_codebook {t_cp:.2f}s; "
        f"w_idx int16, codebook {N_BOOK} entries")

    kw = dict(max_len=128, max_batch=MAX_BATCH, device=dev)
    eng = {be: ServeEngine(model, cp, backend=be, **kw)
           for be in ("dense", "codebook", "lut")}
    per_fwd = 7 * cfg.n_layers
    runs, tokens = {}, {}

    def drive(be, n_serve, n_generate):
        """serve n_serve requests, then generate for n_generate (if any),
        counting launches over both; tok/s is serve's alone."""
        e = eng[be]
        ops.reset_launch_counts()
        f0 = e.n_forwards
        out, secs = timed(lambda: e.serve(prompts[:n_serve], max_new=16))
        if n_generate:
            timed(lambda: e.generate(prompts[:n_generate], max_new=16))
        counts = ops.launch_counts()
        runs[be] = (secs, counts, e.n_forwards - f0, n_serve * 16)
        tokens[be] = out

    drive("codebook", 8, 4)
    drive("lut", 4, 0)
    for be, (secs, counts, fwd, n_tok) in runs.items():
        name = f"{be}_matmul"
        other = "lut_matmul" if be == "codebook" else "codebook_matmul"
        if counts[name] != per_fwd * fwd or counts[other] != 0:
            raise AssertionError(f"{be}: launches {counts} over {fwd} "
                                 f"forwards, want {per_fwd}×{fwd}")
        log(f"[main] {be}: {fwd} forwards, {counts[name]} {name} launches "
            f"(= 7 × {cfg.n_layers} × {fwd}); serve: {n_tok} tokens in "
            f"{secs:.3f}s → {n_tok / secs:.1f} tok/s")
    launches = {f"{be}_matmul": r[1][f"{be}_matmul"] for be, r in runs.items()}

    tokens["dense"] = eng["dense"].serve(prompts, max_new=16)
    for seq in tokens["codebook"] + tokens["lut"]:
        if not all(0 <= t < cfg.vocab for t in seq):
            raise AssertionError("token id out of range")
    for be in ("codebook", "lut"):
        got, ref = tokens[be], tokens["dense"][:len(tokens[be])]
        same = sum(a == b for g_, r_ in zip(got, ref)
                   for a, b in zip(g_, r_))
        total = sum(len(r_) for r_ in ref)
        log(f"[main] token agreement {be} vs dense: {same}/{total}")

    # prefill logits: codebook and lut against the dense backend
    toks, lens = eng["dense"]._pad_prompts(prompts[:4])
    lg = {be: e._prefill(toks, lens)[0][:, -1, :cfg.vocab].float()
          for be, e in eng.items()}
    if not all(bool(torch.isfinite(v).all()) for v in lg.values()):
        raise AssertionError("non-finite prefill logits")
    scale = lg["dense"].abs().max().item()
    for be in ("codebook", "lut"):
        d = (lg[be] - lg["dense"]).abs().max().item()
        agree = (lg[be].argmax(-1) == lg["dense"].argmax(-1)).sum().item()
        log(f"[main] prefill logits {be} vs dense: max |Δ| {d:.4e} "
            f"(max |logit| {scale:.4e}), argmax agree {agree}/4")
        # bf16 activations: a 1-ulp (2^-8) rounding flip anywhere in 28
        # layers moves logits by a few bf16 ulps of their range; a wrong
        # kernel moves them by O(range).  5% of the range separates the two.
        # lut carries no limit here: its activations snap to levels sized
        # for the embedding's fan-in, coarse enough to move logits by a
        # large share of their range; the lut kernel is held bit-exact in
        # parity and the reduced model's tokens to the CPU path's instead.
        if be == "codebook" and d > 0.05 * scale:
            raise AssertionError(f"codebook logits differ from dense by {d}")

    # step timings (after the counted runs)
    stats = {"peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    t32, l32 = eng["dense"]._pad_prompts([(prompts[0] * 4)[:32]])
    for be, e in eng.items():
        pre = [timed(lambda: e._prefill(t32, l32))[1] for _ in range(4)][1:]
        cache = e.model.init_cache(4, 128, dtype=torch.bfloat16, device=dev)
        cache["pos"][:] = 40
        last = np.zeros(4, np.int64)
        dec = [timed(lambda: e._decode(last, cache))[1] for _ in range(6)][1:]
        stats[be] = {"prefill_ms": 1e3 * sorted(pre)[len(pre) // 2],
                     "decode_step_ms": 1e3 * sorted(dec)[len(dec) // 2]}
        if be in runs:
            stats[be]["serve_tok_s"] = runs[be][3] / runs[be][0]
        busy, top = device_time(lambda: e._decode(last, cache))
        idle = 1 - busy / stats[be]["decode_step_ms"] if busy else None
        stats[be].update(decode_device_ms=busy or None,
                         decode_idle_share=idle, decode_top_kernels=top)
        log(f"[main] {be}: prefill 1×32 tokens {stats[be]['prefill_ms']:.2f}"
            f" ms, decode step (4 slots, pos 40) "
            f"{stats[be]['decode_step_ms']:.2f} ms, device busy "
            + (f"{busy:.2f} ms (idle share {idle:.3f}); top: "
               + "; ".join(f"{k} {ms:.3f}ms×{n}" for k, ms, n in top)
               if busy else "not measured (the profiler saw no device time)"))
    x = torch.randn(4, 1, cfg.d_model, device=dev).to(torch.bfloat16)
    stats["tied_logits_ms"] = time_ms(lambda: L.embed_logits(cp["embed"], x),
                                      reps=10)
    log(f"[main] tied logits (4×2048 @ dequantized 152064×2048 f32): "
        f"{stats['tied_logits_ms']:.3f} ms; peak memory "
        f"{stats['peak_mem_gib']:.2f} GiB")
    return stats, launches


# --- phase 5: kernel timings --------------------------------------------------

def kernel_times(dev, peaks: dict) -> dict:
    """Per (M, site): kernel, plain and library times and the bound.

    Four copies of each operand set are cycled, so the 2 × 25 MB of ids
    of the widest site do not sit in the 50 MB L2 from the previous call,
    as they would not on the serving path."""
    import torch
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm
    g = torch.Generator(device=dev).manual_seed(1)
    res = {"codebook_matmul": [], "lut_matmul": []}
    for M in (4, 32):
        for site, (K, N) in SITES.items():
            sets = []
            for _ in range(4):
                wi = torch.randint(0, N_BOOK, (K, N), generator=g, device=dev
                                   ).to(torch.int16)
                book = torch.randn(N_BOOK, generator=g, device=dev) * 0.05
                x = torch.randn(M, K, generator=g, device=dev
                                ).to(torch.bfloat16)
                a = torch.randint(0, LEVELS, (M, K), generator=g, device=dev,
                                  dtype=torch.int32)
                tab = torch.randint(-(1 << 20), 1 << 20, (LEVELS, N_BOOK),
                                    generator=g, device=dev,
                                    dtype=torch.int32)
                w_deq = book[wi.long()].to(torch.bfloat16)
                sets.append((x, wi, book, a, tab, w_deq))
            it = [0]

            def cyc(f):
                def run():
                    s = sets[it[0] % 4]
                    it[0] += 1
                    return f(s)
                return run
            # codebook: bytes = x + ids + codebook + f32 out; 2MKN bf16 ops
            nbytes = M * K * 2 + K * N * 2 + N_BOOK * 4 + M * N * 4
            b_bytes = nbytes / peaks["bytes"]
            b_ops = 2 * M * K * N / peaks["bf16"]
            res["codebook_matmul"].append({
                "M": M, "K": K, "N": N, "site": site,
                "ms": time_ms(cyc(lambda s: cm.codebook_matmul_cuda(*s[:3]))),
                "plain_ms": time_ms(cyc(
                    lambda s: cm.codebook_matmul_plain(*s[:3])), reps=5),
                "library_ms": time_ms(cyc(lambda s: torch.matmul(s[0],
                                                                 s[5]))),
                "bound_ms": 1e3 * max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
            # lut: bytes = a_idx + ids + the table entries these inputs
            # address + int32 out; 2MKN int32 ops (address add, accumulate)
            x, wi, book, a, tab, _ = sets[0]
            touched = torch.zeros(LEVELS * N_BOOK, dtype=torch.bool,
                                  device=dev)
            for k0 in range(0, K, 64):
                addr = (a[:, k0:k0 + 64, None] * N_BOOK
                        + wi[None, k0:k0 + 64, :].to(torch.int32))
                touched[addr.reshape(-1).long()] = True
            nbytes = (M * K * 4 + K * N * 2 + int(touched.sum()) * 4
                      + M * N * 4)
            b_bytes = nbytes / peaks["bytes"]
            b_ops = 2 * M * K * N / peaks["int32"]
            res["lut_matmul"].append({
                "M": M, "K": K, "N": N, "site": site,
                "ms": time_ms(cyc(lambda s: lm.lut_matmul_cuda(s[3], s[1],
                                                               s[4]))),
                "plain_ms": time_ms(cyc(lambda s: lm.lut_matmul_plain(
                    s[3], s[1], s[4])), reps=3, warm=1),
                "library_ms": None,
                "bound_ms": 1e3 * max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
            del sets
    for name, rows in res.items():
        for M in (4, 32):
            rs = [r for r in rows if r["M"] == M]
            log(f"[time] {name} M={M}: " + ", ".join(
                f"{r['site']} {r['ms']:.4f}ms (bound {r['bound_ms']:.4f} "
                f"{r['bound_by']}, plain {r['plain_ms']:.3f}"
                + (f", library {r['library_ms']:.4f}"
                   if r["library_ms"] is not None else "") + ")"
                for r in rs))
            layer = {k: sum(r[k] for r in rs)
                     for k in ("ms", "plain_ms", "bound_ms")}
            lib = (f", library {sum(r['library_ms'] for r in rs):.4f} ms"
                   if rs[0]["library_ms"] is not None else "")
            log(f"[time] {name} M={M} one layer (7 sites): kernel "
                f"{layer['ms']:.4f} ms, bound {layer['bound_ms']:.4f} ms, "
                f"plain {layer['plain_ms']:.3f} ms{lib}")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[env] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; allow_tf32 matmul/cudnn = "
        f"{torch.backends.cuda.matmul.allow_tf32}/"
        f"{torch.backends.cudnn.allow_tf32}")
    peaks = peaks_for(name)
    dev = torch.device("cuda", 0)

    t = time.time()
    build.build_all()
    log(f"[build] {', '.join(build.SOURCES)} with nvcc "
        f"{' '.join(build.NVCC_FLAGS)}: {time.time() - t:.1f}s")

    from repro_torch import configs
    prompts = prompts_for(8, configs.get("qwen3-1.7b").vocab)
    worst = parity(dev, path_rows(prompts, MAX_BATCH))
    reduced_against_cpu(dev)
    ops.reset_launch_counts()
    stats, launches = main_path(dev, prompts)
    times = kernel_times(dev, peaks)

    kernels = []
    for kname in ("codebook_matmul", "lut_matmul"):
        head = next(r for r in times[kname]
                    if (r["M"], r["K"], r["N"]) == MAIN_SHAPE)
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": TPU_KERNELS[kname],
            "launches": launches[kname],
            "max_abs_err": worst[kname],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {"M": MAIN_SHAPE[0], "K": MAIN_SHAPE[1],
                      "N": MAIN_SHAPE[2], "ids": "int16", "x": "bfloat16"},
            "shapes": times[kname]})
    log(f"[done] {time.time() - t_start:.1f}s in all; main path "
        + json.dumps(stats))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
