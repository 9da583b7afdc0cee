#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. environment: card name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` kernel (codebook_matmul, lut_matmul,
   page_gather) compiled with nvcc for sm_90a, in parallel;
3. kernel parity: each matmul kernel against its plain PyTorch version at
   every row count the serving paths give it and every (K, N) site of the
   model (lut bit-exact, codebook within 16 × a summation-order estimate,
   which weights left unrounded to bf16 must fail); page_gather bit-exact
   on int8/bf16/f32 K/V pages, bf16 scale pages and a 15-byte page, at the
   decode and prefill-chunk page tables, with out-of-range ids;
4. reduced model: a 2-layer qwen3 serves contiguous and paged (bf16 and
   int8 pages) through every backend on the card and on the CPU, with
   equal greedy tokens;
5. contiguous path: qwen3-1.7b at full width and depth, random weights
   from a seeded generator, compressed to |W| = 1000 (laplacian_l1,
   global) and served through ``ServeEngine.serve``/``generate`` with the
   codebook and lut backends, kernel launch counts checked, logits held
   against the dense backend;
6. paged path: the same model served by ``ServeEngine(paged=True)``, page
   16, to 8 chat requests sharing a 96-token system prompt: codebook with
   int8 and with bf16 pages, lut with int8 pages.  page_gather and matmul
   launches per forward, prefix-cache hits, the pool's refcounts and a
   second serve's tokens are checked, and the paged bf16 prefill logits are
   held against the contiguous engine's;
7. kernel timings: the matmuls at the decode (M=4) and prefill (M=32)
   shapes, page_gather at the decode and prefill-chunk page tables, with
   the bound, the plain version's and the library call's times.

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
    "page_gather": "src/repro/kernels/page_gather.py:37",
}
SITES = {"wq": (2048, 2048), "wk": (2048, 1024), "wv": (2048, 1024),
         "wo": (2048, 2048), "w1": (2048, 6144), "w3": (2048, 6144),
         "w2": (6144, 2048)}
MAIN_SHAPE = (4, 2048, 6144)     # the JSON's headline: decode, w1/w3 site
N_BOOK = 1000
MAX_BATCH = 4
LEVELS = 4096
PAGE = 16                        # tokens per page of the paged path
PAGED_MAX_LEN = 512              # 32 pages per slot
SYSTEM_LEN = 96                  # the shared system prompt: 6 full pages
N_PAGES = 1 + MAX_BATCH * PAGED_MAX_LEN // PAGE     # the engine's default


def log(*a):
    print(*a, flush=True)


def peaks_for(name: str) -> dict:
    """The published peaks of the card, which bound_ms divides by."""
    if "H100" in name and "HBM3" in name:
        return H100_SXM
    raise RuntimeError(f"no published peaks for {name!r}: bound_ms is "
                       "computed for the H100 SXM only")


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Device ms per call of ``fn``, from CUDA events around ``reps`` calls.

    The calls are queued behind a device-side sleep, so the card runs them
    back to back: a call that takes the card less time than the host takes
    to issue it (page_gather: a few µs on the card, tens of µs of Python)
    would otherwise time the host.  When the sleep ends before the host has
    queued every call, it is doubled and the timing taken again."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 24                         # about 8 ms at 1.98 GHz
    while True:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        queued = not e0.query()              # the card was still asleep
        torch.cuda.synchronize()
        if queued or cycles >= 1 << 30:
            return e0.elapsed_time(e1) / reps
        cycles *= 2


# --- phase 3: kernel parity --------------------------------------------------

def path_rows(prompts, paged_prompts, max_batch: int) -> list[int]:
    """Every row count M the serving paths give the matmul kernels: decode
    over ``max_batch`` slots, the contiguous serve's one-request prefills at
    each prompt's bucket (the paged prompts' too: the contiguous engine
    they are compared with serves them), generate's and the logits check's
    prefill of the first four prompts, the timed 1 × 32 prefill, a paged
    prefill chunk of ``PAGE`` rows, and a single row."""
    from repro_torch.serving.engine import _bucket
    rows = {1, max_batch, 32, PAGE,
            4 * _bucket(max(len(p) for p in prompts[:4]))}
    return sorted(rows | {_bucket(len(p)) for p in prompts + paged_prompts})


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


# the page shapes of the paged path: int8, bf16 and f32 K/V pages of
# qwen3-1.7b (16 tokens × 8 KV heads × hd 128), bf16 scale pages, and a
# 15-byte page whose copies cannot all be 16-byte vectors
GATHER_CASES = (((PAGE, 8, 128), "int8"), ((PAGE, 8, 128), "bfloat16"),
                ((PAGE, 8, 128), "float32"), ((PAGE, 8), "bfloat16"),
                ((3, 5), "int8"))
GATHER_TABLES = ((MAX_BATCH, PAGED_MAX_LEN // PAGE),      # decode
                 (1, PAGED_MAX_LEN // PAGE))              # prefill chunk


def gather_parity(dev) -> float:
    """page_gather against its plain version, bit for bit, on one layer's
    view of a (3, n_pages, ...) pool, int32 and int64 page tables holding
    0, negatives and ids ≥ n_pages.  Returns the max abs error (0)."""
    import torch
    from repro_torch.kernels import page_gather as pg
    g = torch.Generator(device=dev).manual_seed(2)
    n = 0
    for shape, dt in GATHER_CASES:
        full = torch.randint(-128, 128, (3, N_PAGES) + shape, generator=g,
                             device=dev).to(getattr(torch, dt))
        for B, P in GATHER_TABLES:
            pt = torch.randint(-4, N_PAGES + 5, (B, P), generator=g,
                               device=dev, dtype=torch.int32)
            pt[0, :3] = torch.tensor([0, -1, N_PAGES], device=dev)
            for ids in (pt, pt.long()):
                got = pg.page_gather_cuda(full[1], ids)
                want = pg.page_gather_plain(full[1], ids)
                torch.cuda.synchronize()
                if got.shape != want.shape or not torch.equal(
                        got.view(torch.uint8), want.view(torch.uint8)):
                    raise AssertionError(f"page_gather {shape} {dt} table "
                                         f"{(B, P)}: not bit-exact")
                n += 1
    log(f"[parity] page_gather bit-exact in {n} cases: pages "
        + ", ".join(f"{s} {d}" for s, d in GATHER_CASES)
        + f" × tables {GATHER_TABLES} × int32/int64 ids, with 0, negative "
        f"and ≥ n_pages ({N_PAGES}) ids")
    return 0.0


# --- phases 4-6: the reduced model, the contiguous and the paged path ---------

def prompts_for(n: int, vocab: int):
    import numpy as np
    rng = np.random.default_rng(0)
    lens = rng.integers(8, 49, n)
    return [rng.integers(0, vocab, int(n_)).tolist() for n_ in lens]


def chat_prompts(n: int, vocab: int):
    """A chat deployment's shape: one shared system prompt of SYSTEM_LEN
    tokens (6 full pages), then a user part of 8–48 tokens per request."""
    import numpy as np
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, SYSTEM_LEN).tolist()
    lens = rng.integers(8, 49, n)
    return [system + rng.integers(0, vocab, int(n_)).tolist() for n_ in lens]


def reduced_against_cpu(dev):
    """A reduced qwen3 (2 layers, f32, |W|=256) through every backend on
    the card and on the CPU, contiguous and paged (page 4, max_batch 2,
    bf16 and int8 pages): greedy tokens must agree."""
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
    paged = prompts + [[300, 2, 5, 7, 1, 8], [1, 2, 3, 4, 5, 6, 7]]
    for be in ("dense", "codebook", "lut"):
        for kv in ("bf16", "int8"):
            kw = dict(max_len=64, max_batch=2, backend=be, paged=True,
                      page_size=4, kv_dtype=kv)
            on_cpu = ServeEngine(model, cp, device="cpu", **kw).serve(
                paged, max_new=8)
            on_dev = ServeEngine(model, cp_dev, device=dev, **kw).serve(
                paged, max_new=8)
            if on_cpu != on_dev:
                raise AssertionError(f"reduced model, paged {be} {kv}: card "
                                     f"tokens {on_dev} != CPU tokens "
                                     f"{on_cpu}")
    log("[reduced] 2-layer qwen3: dense/codebook/lut tokens on the card "
        "equal the CPU path's, contiguous and paged (bf16 and int8 pages)")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def device_time(fn, top: int = 5, match: str = "page_gather"):
    """Device time of one call from torch.profiler's CUDA activity:
    (busy ms summed over kernels and copies, [(name, ms, count)] of the
    largest, ms of the kernels whose name holds ``match``).  Busy time over
    wall time gives the device's idle share."""
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
    matched = sum(e.self_device_time_total for e in evs
                  if match in e.key) / 1e3
    return busy, [(e.key[:48], e.self_device_time_total / 1e3, e.count)
                  for e in evs[:top]], matched


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def compressed_model(dev):
    """qwen3-1.7b at full width and depth, random weights from a seeded
    generator, compressed to |W| = N_BOOK: (cfg, model, index-form params)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import to_codebook_params

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
    return cfg, model, cp


def main_path(dev, cfg, model, cp, prompts) -> tuple[dict, dict]:
    """The contiguous path: serve/generate with codebook and lut, launch
    counts, logits against dense, step timings."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.serving import ServeEngine

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
        busy, top, _ = device_time(lambda: e._decode(last, cache))
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


def _pool_clean(pool) -> bool:
    """No page is referenced except by its prefix-cache registration."""
    return all(int(pool.ref[p]) == (1 if p in pool.key_of else 0)
               for p in range(pool.n_pages))


def paged_path(dev, cfg, model, cp, chats) -> tuple[dict, dict]:
    """The paged path at full width: ServeEngine(paged=True), page PAGE,
    max_len PAGED_MAX_LEN, MAX_BATCH slots, 16 new tokens per request.
    Each run is counted alone: page_gather launches must be gathers per
    layer (4 for int8 pages: K, V and their scales; 2 for bf16) × layers ×
    forwards, matmul launches 7 × layers × forwards."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeEngine

    kw = dict(paged=True, page_size=PAGE, max_len=PAGED_MAX_LEN,
              max_batch=MAX_BATCH, device=dev)
    n_l = cfg.n_layers
    eng, tokens, launches, stats = {}, {}, {}, {}
    for be, kv, n in (("codebook", "int8", 8), ("codebook", "bf16", 8),
                      ("lut", "int8", 4)):
        e = eng[be, kv] = ServeEngine(model, cp, backend=be, kv_dtype=kv,
                                      **kw)
        pool = e.pool
        ops.reset_launch_counts()
        f0 = e.n_forwards
        first, secs = timed(lambda: e.serve(chats[:n], max_new=16))
        fwd1 = e.n_forwards - f0
        if not _pool_clean(pool):
            raise AssertionError(f"paged {be} {kv}: pages still referenced "
                                 "after serve")
        hits1 = pool.stats.hit_pages
        again, secs2 = timed(lambda: e.serve(chats[:n], max_new=16))
        counts = ops.launch_counts()
        fwd = e.n_forwards - f0
        if not _pool_clean(pool):
            raise AssertionError(f"paged {be} {kv}: pages still referenced "
                                 "after the second serve")
        if hits1 <= 0 or pool.stats.hit_pages - hits1 <= hits1:
            raise AssertionError(f"paged {be} {kv}: hit pages {hits1} then "
                                 f"{pool.stats.hit_pages - hits1}")
        if again != first:
            raise AssertionError(f"paged {be} {kv}: the second serve's "
                                 "tokens differ from the first's")
        per_gather = 4 if kv == "int8" else 2
        other = "lut_matmul" if be == "codebook" else "codebook_matmul"
        if (counts["page_gather"] != per_gather * n_l * fwd
                or counts[f"{be}_matmul"] != 7 * n_l * fwd
                or counts[other] != 0):
            raise AssertionError(f"paged {be} {kv}: launches {counts} over "
                                 f"{fwd} forwards")
        for seq in first:
            if not all(0 <= t < cfg.vocab for t in seq):
                raise AssertionError("token id out of range")
        tokens[be, kv] = first
        for k_ in ("page_gather", f"{be}_matmul"):
            launches[k_] = launches.get(k_, 0) + counts[k_]
        st = pool.stats
        stats[f"{be}_{kv}"] = {
            "requests": n, "forwards": fwd, "serve_s": secs,
            "serve_again_s": secs2, "serve_tok_s": 16 * n / secs,
            "hit_pages_first": hits1, "hit_pages_again": st.hit_pages - hits1,
            "miss_pages": st.miss_pages, "cow_copies": st.cow_copies,
            "peak_pages_in_use": st.peak_pages_in_use,
            "pool_bytes": pool.bytes_total(),
            "slab_bytes": e.dense_cache_bytes()}
        log(f"[paged] {be} {kv} pages: {n} requests twice, {fwd} forwards "
            f"({fwd1} in the first serve), {counts['page_gather']} "
            f"page_gather launches (= {per_gather} × {n_l} × {fwd}), "
            f"{counts[f'{be}_matmul']} {be}_matmul (= 7 × {n_l} × {fwd}); "
            f"first serve {16 * n} tokens in {secs:.3f}s → "
            f"{16 * n / secs:.1f} tok/s, again {secs2:.3f}s with the same "
            f"tokens; hit pages {hits1} then {st.hit_pages - hits1}, miss "
            f"{st.miss_pages}, CoW {st.cow_copies}, peak pages "
            f"{st.peak_pages_in_use}/{pool.usable_pages}; pool "
            f"{pool.bytes_total()} B vs contiguous slab "
            f"{e.dense_cache_bytes()} B")

    # paged bf16 last-chunk logits against the contiguous engine's prefill
    contig = ServeEngine(model, cp, backend="codebook", max_len=PAGED_MAX_LEN,
                         max_batch=MAX_BATCH, device=dev)
    e = eng["codebook", "bf16"]
    worst, scale, agree = 0.0, 0.0, 0
    for p in chats[:4]:
        adm = e.pool.admit(p, 1)
        lg_p = e._chunked_prefill(e.pool, p, adm)[0, -1, :cfg.vocab].float()
        e.pool.retire(adm)
        toks, lens = contig._pad_prompts([p])
        lg_c = contig._prefill(toks, lens)[0][0, -1, :cfg.vocab].float()
        if not (bool(torch.isfinite(lg_p).all())
                and bool(torch.isfinite(lg_c).all())):
            raise AssertionError("non-finite prefill logits")
        worst = max(worst, (lg_p - lg_c).abs().max().item())
        scale = max(scale, lg_c.abs().max().item())
        agree += int(lg_p.argmax() == lg_c.argmax())
    log(f"[paged] prefill logits, paged bf16 pages (chunks of {PAGE}) vs "
        f"contiguous: max |Δ| {worst:.4e} (max |logit| {scale:.4e}), argmax "
        f"agree {agree}/4")
    # bf16 activations and bf16 K/V on both sides; they differ in the
    # order of the softmax sums (chunks of 16 against one flash pass) and
    # flash's bf16 rounding of P: rounding noise of a few bf16 ulps of the
    # range.  A wrong page or a wrong mask moves logits by O(range).  The
    # 5 %-of-range limit of the contiguous codebook-vs-dense check
    # separates the two here too.
    if worst > 0.05 * scale:
        raise AssertionError(f"paged bf16 logits differ from contiguous by "
                             f"{worst}")
    want = contig.serve(chats, max_new=16)
    for key, got in tokens.items():
        ref = want[:len(got)]
        same = sum(a == b for g_, r_ in zip(got, ref) for a, b in zip(g_, r_))
        log(f"[paged] token agreement {key[0]} {key[1]} pages vs contiguous "
            f"codebook: {same}/{sum(len(r_) for r_ in ref)}")
    stats["prefill_logits"] = {"max_abs_diff": worst, "max_abs_logit": scale,
                               "argmax_agree": agree}

    # step timings on a fresh pool: 4 slots at pos 120, 32 pages each
    e = eng["codebook", "int8"]
    pool = model.init_paged_cache(N_PAGES, PAGE, torch.int8, device=dev)
    pt = torch.arange(1, N_PAGES, dtype=torch.int32,
                      device=dev).reshape(MAX_BATCH, -1)
    cache = {**pool, "page_table": pt,
             "pos": torch.full((MAX_BATCH,), 120, dtype=torch.int32,
                               device=dev)}
    last = np.zeros(MAX_BATCH, np.int64)
    logits = e._decode(last, cache)[0]
    if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise AssertionError("non-finite paged decode logits")
    dec = [timed(lambda: e._decode(last, cache))[1] for _ in range(6)][1:]
    busy, top, pg_ms = device_time(lambda: e._decode(last, cache))
    batch = {"tokens": torch.zeros((1, PAGE), dtype=torch.int64, device=dev),
             "start": SYSTEM_LEN, "length": PAGE, "page_row": pt[0],
             "write_pid": int(pt[0, SYSTEM_LEN // PAGE])}
    with torch.no_grad():
        pre = [timed(lambda: model.prefill_chunk(e.params, batch, pool,
                                                 e.bk))[1]
               for _ in range(6)][1:]
    c_cache = model.init_cache(MAX_BATCH, PAGED_MAX_LEN, dtype=torch.bfloat16,
                               device=dev)
    c_cache["pos"][:] = 120
    c_dec = [timed(lambda: contig._decode(last, c_cache))[1]
             for _ in range(6)][1:]
    c_busy, c_top, _ = device_time(lambda: contig._decode(last, c_cache))
    med = lambda xs: 1e3 * sorted(xs)[len(xs) // 2]           # noqa: E731
    stats["steps"] = {
        "paged_int8_decode_ms": med(dec), "paged_int8_device_ms": busy or None,
        "page_gather_device_ms": pg_ms or None,
        "page_gather_share": pg_ms / busy if busy else None,
        "paged_int8_top_kernels": top,
        "paged_prefill_chunk_ms": med(pre),
        "contiguous_decode_ms": med(c_dec),
        "contiguous_device_ms": c_busy or None,
        "contiguous_top_kernels": c_top}
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[paged] codebook decode step, 4 slots at pos 120, max_len "
        f"{PAGED_MAX_LEN}: paged int8 {med(dec):.2f} ms, device busy "
        + (f"{busy:.2f} ms of which page_gather {pg_ms:.3f} ms "
           f"({pg_ms / busy:.3f}; {4 * n_l} launches, "
           f"{1e3 * pg_ms / (4 * n_l):.2f} us each); top: "
           + "; ".join(f"{k} {ms:.3f}ms×{n}" for k, ms, n in top)
           if busy else "not measured (the profiler saw no device time)")
        + f" | contiguous bf16 {med(c_dec):.2f} ms, device busy "
        + (f"{c_busy:.2f} ms" if c_busy else "not measured")
        + f" | paged prefill chunk 1×{PAGE} at start {SYSTEM_LEN}: "
        f"{med(pre):.2f} ms; peak memory {stats['peak_mem_gib']:.2f} GiB")
    return stats, launches


def gather_times(dev, peaks: dict) -> list:
    """page_gather per call at the decode (4 × 32) and prefill-chunk
    (1 × 32) page tables: kernel, plain and library times and the bound.

    The pool is a full (layers, n_pages, ...) pool and every call gathers
    from the next layer's slice, so the 28 slices (59 MB of int8 K pages)
    do not sit in the 50 MB L2 as they would not on the serving path.  The
    tables hold distinct live pages, as a full batch's do.  Library: one
    advanced-indexing call on ids clamped beforehand; the plain version is
    the same call after the cast and clamp of the ids."""
    import torch
    from repro_torch.kernels import page_gather as pg
    g = torch.Generator(device=dev).manual_seed(3)
    n_l, res = 28, []
    for shape, dt in (((PAGE, 8, 128), "int8"), ((PAGE, 8, 128), "bfloat16"),
                      ((PAGE, 8), "bfloat16")):
        full = torch.randint(-128, 128, (n_l, N_PAGES) + shape, generator=g,
                             device=dev).to(getattr(torch, dt))
        page_bytes = full[0, 0].numel() * full.element_size()
        for B, P in GATHER_TABLES:
            perm = torch.randperm(N_PAGES - 1, generator=g, device=dev) + 1
            pt = perm[:B * P].reshape(B, P).to(torch.int32)
            ids = pt.long()
            it = [0]

            def cyc(f):
                def run():
                    it[0] += 1
                    return f(full[it[0] % n_l])
                return run
            nbytes = 2 * B * P * page_bytes + B * P * 4
            res.append({
                "B": B, "P": P, "page": list(shape), "dtype": dt,
                "page_bytes": page_bytes,
                "ms": time_ms(cyc(lambda pool: pg.page_gather_cuda(pool, pt)),
                              reps=56),
                "plain_ms": time_ms(cyc(
                    lambda pool: pg.page_gather_plain(pool, pt)), reps=56),
                "library_ms": time_ms(cyc(lambda pool: pool[ids]), reps=56),
                "bound_ms": 1e3 * nbytes / peaks["bytes"],
                "bound_by": "bytes"})
        del full
    for r in res:
        log(f"[time] page_gather {r['B']}×{r['P']} pages {tuple(r['page'])} "
            f"{r['dtype']} ({r['page_bytes']} B): {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} bytes, plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f})")
    return res


# --- phase 7: kernel timings --------------------------------------------------

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
    vocab = configs.get("qwen3-1.7b").vocab
    prompts, chats = prompts_for(8, vocab), chat_prompts(8, vocab)
    worst = parity(dev, path_rows(prompts, chats, MAX_BATCH))
    worst["page_gather"] = gather_parity(dev)
    reduced_against_cpu(dev)
    cfg, model, cp = compressed_model(dev)
    stats, launches = main_path(dev, cfg, model, cp, prompts)
    p_stats, p_launches = paged_path(dev, cfg, model, cp, chats)
    del model, cp
    times = kernel_times(dev, peaks)
    g_times = gather_times(dev, peaks)

    by_path = {k: {"contiguous": launches.get(k, 0),
                   "paged": p_launches.get(k, 0)} for k in TPU_KERNELS}
    kernels = []
    for kname in ("codebook_matmul", "lut_matmul", "page_gather"):
        if kname == "page_gather":
            head = next(r for r in g_times if r["dtype"] == "int8"
                        and (r["B"], r["P"]) == GATHER_TABLES[0])
            shape = {"B": head["B"], "P": head["P"], "page": head["page"],
                     "dtype": "int8", "pool": [cfg.n_layers, N_PAGES]
                     + head["page"]}
            shapes = g_times
        else:
            head = next(r for r in times[kname]
                        if (r["M"], r["K"], r["N"]) == MAIN_SHAPE)
            shape = {"M": MAIN_SHAPE[0], "K": MAIN_SHAPE[1],
                     "N": MAIN_SHAPE[2], "ids": "int16", "x": "bfloat16"}
            shapes = times[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": TPU_KERNELS[kname],
            "launches": sum(by_path[kname].values()),
            "launches_by_path": by_path[kname],
            "max_abs_err": worst[kname],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": shape, "shapes": shapes})
    log(f"[done] {time.time() - t_start:.1f}s in all; contiguous path "
        + json.dumps(stats))
    log("[done] paged path " + json.dumps(p_stats))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
