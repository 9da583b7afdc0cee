#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. environment: card name and power limit, torch and CUDA versions;
2. build: every ``csrc/*.cu`` kernel (codebook_matmul, lut_matmul,
   page_gather, act_quant, kmeans_assign) compiled with nvcc for sm_90a,
   in parallel;
3. kernel parity: each matmul kernel against its plain PyTorch version at
   every row count the serving paths give it (and 17, across the tensor-
   core route's tile boundary) and every (K, N) site of the model, int8,
   int16 and int32 ids, f32 and bf16 x, on every route (codebook: mma,
   fma; lut: staged rows, L2), each launch run twice and bit-identical
   (lut bit-exact, also on out-of-range ids and wrapping sums; codebook
   within 16 × a summation-order estimate, whose share each route reaches
   is printed, and which weights left unrounded to bf16 must fail);
   page_gather bit-exact on int8/bf16/f32 K/V pages, bf16 scale pages and
   a 15-byte page, at the decode and prefill-chunk page tables, with
   out-of-range ids, and its multi-pool launch bit-identical to one launch a pool; act_quant
   in both forms (4 kinds × |A| 2, 32, 256 × f32/bf16) at every FFN row
   count of the serving paths × 6144 and odd sizes, bit-equal but for
   counted level-boundary ties; kmeans_assign (k 2, 1000, 4096 × n 1,
   4097, 10⁷, values on midpoints, duplicate centers) with exact indices
   and counts, sums within a summation-order limit, bit-identical twice,
   its sums-only form bit-identical to the full form;
4. reduced model: a 2-layer qwen3 serves contiguous and paged (bf16 and
   int8 pages) through every backend on the card and on the CPU, with
   equal greedy tokens; then the same at the paper's working point
   (|A| = 32 activations, k-means |W| = 1000, clustered on the CPU), and
   k-means of its weights on the card against the CPU's;
5. contiguous path: qwen3-1.7b at full width and depth, random weights
   from a seeded generator, compressed to |W| = 1000 (laplacian_l1,
   global) and served through ``ServeEngine.serve``/``generate`` with the
   codebook and lut backends, kernel launch counts checked, logits held
   against the dense backend; lut_matmul replayed on the serving path's own
   activation ids (a captured decode forward and 1 × 32 prefill, 196
   launches each) on its planned route and on each route forced, beside
   random row ids of the same shapes, bit-exact on the middle layer;
6. paged path: the same model served by ``ServeEngine(paged=True)``, page
   16, to 8 chat requests sharing a 96-token system prompt: codebook with
   int8 and with bf16 pages, lut with int8 pages.  page_gather (one
   launch a layer) and matmul launches per forward, prefix-cache hits,
   the pool's refcounts and a second serve's tokens are checked, and the
   paged bf16 prefill logits are held against the contiguous engine's;
7. working point: the same qwen3-1.7b weights at ``quantized(levels=32,
   n_weights=1000, method="kmeans")``: ``cluster_params`` on the card
   (exactly 2 × 25 kmeans_assign launches, the sums-only form), k-means
   MSE beside laplacian_l1's, kmeans_assign at the full n against its
   plain version (and run twice, bit-identical; both forms), its three
   forms timed (search alone, sums only, full), then served through
   codebook and lut (contiguous) and codebook with int8 pages, with 28
   act_quant launches a forward; the kernel held against its plain
   version on one layer's real w1 outputs; decode step and serve
   figures beside phase 5's;
8. kernel timings: the matmuls at M = 1, 4 (decode), 32 (prefill) and 256
   (four 64-token prefills) × the 7 sites of a layer, with the route each
   took (lut: and the other route forced), the bound, the plain version's
   and (codebook) torch.matmul's times, and a K-split sweep at the decode
   shape; page_gather at the decode and prefill-chunk page tables, and
   one paged layer's four pools in one launch against
   four single-pool launches and four library calls,
   act_quant at the decode (4 × 6144) and prefill (32 × 6144) FFN shapes,
   with the bound, the plain version's and the library call's times
   (kmeans_assign's are taken in phase 7, at the full n).

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
    "act_quant": "src/repro/kernels/act_quant.py:35",
    "kmeans_assign": "src/repro/kernels/kmeans1d.py:27",
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
ACT_LEVELS = 32                  # the paper's working point: |A| = 32 ...
D_FF = 6144                      # ... at each FFN of qwen3-1.7b
KM_RTOL = 1e-5                   # k-means codebooks: see centers_agree


def log(*a):
    """Print a line; with CHIP_SMOKE_LOG set, append it to that file too
    (the JSON lines at the end can outgrow a terminal's tail)."""
    print(*a, flush=True)
    path = os.environ.get("CHIP_SMOKE_LOG")
    if path:
        with open(path, "a") as f:
            print(*a, file=f)


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


def time_turns(fns: dict, reps: int) -> dict:
    """``time_ms`` of each callable, taken in turns (in order, then in
    reverse) and averaged: at a few µs a call, the first timing of a
    sequence reads some 0.1 µs high."""
    first = {k: time_ms(f, reps=reps) for k, f in fns.items()}
    second = {k: time_ms(fns[k], reps=reps) for k in reversed(list(fns))}
    return {k: (first[k] + second[k]) / 2 for k in fns}


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


def codebook_plans(x, wi):
    """The route the wrapper plans for these operands and, for bf16 x, the
    route it takes when the rows are not 16-byte aligned (the FMA tile), so
    every route is held against the plain version: [(route, plan or
    None)]."""
    import torch
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import _common
    plans = [(cm.plan_for(x, wi).route, None)]
    if x.dtype == torch.bfloat16:
        alt = _common.codebook_plan(
            x.shape[0], x.shape[1], wi.shape[1], bf16=True, vec_ok=False,
            sms=_common.sm_count(x.device))
        plans.append((alt.route, alt))
    return plans


def lut_plans(a, wi, tab):
    """The route the lut wrapper plans for these operands, then each route
    forced (smem where the rows fit a ring): [(route, plan or None)]."""
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import _common
    args = (a.shape[0], a.shape[1], wi.shape[1])
    kw = dict(n_cols=tab.shape[1], idx_bytes=wi.element_size(),
              sms=_common.sm_count(a.device))
    plans = [("planned " + lm.plan_for(a, wi, tab).route, None),
             ("l2", _common.lut_plan(*args, **kw, route="l2"))]
    try:
        plans.append(("smem", _common.lut_plan(*args, **kw, route="smem")))
    except ValueError:               # rows too long to stage
        pass
    return plans


def lut_out_of_range(g, dev, m, k, n, R, C):
    """A lut case whose flat addresses a·C + w leave the staged row: int16
    w ≥ C (the next row) and w < −C (negative after canonicalization), row
    ids ≥ R and < −R, rows near 2³¹/C whose scaled id wraps int32, and
    table entries near 2²⁵, so that the int32 sums wrap too."""
    import torch
    a = torch.randint(0, R, (m, k), generator=g, device=dev, dtype=torch.int64)
    a[0, ::3] = torch.randint(R, 4 * R, a[0, ::3].shape, generator=g, device=dev)
    a[1, ::5] = torch.randint(-4 * R, -R, a[1, ::5].shape, generator=g,
                              device=dev)
    a[2, ::7] = (1 << 31) // C + torch.randint(-2, 3, a[2, ::7].shape,
                                               generator=g, device=dev)
    w = torch.randint(0, C, (k, n), generator=g, device=dev, dtype=torch.int64)
    w[::4, 0::3] = torch.randint(C, 3 * C, w[::4, 0::3].shape, generator=g,
                                 device=dev)
    w[1::4, 1::3] = torch.randint(-3 * C, -C, w[1::4, 1::3].shape, generator=g,
                                  device=dev)
    w[2::4, 2::3] = torch.randint(-C, 0, w[2::4, 2::3].shape, generator=g,
                                  device=dev)
    t = torch.randint(-(1 << 25), 1 << 25, (R, C), generator=g, device=dev,
                      dtype=torch.int32)
    return a.to(torch.int32), w.to(torch.int16), t


def parity(dev, rows) -> tuple[dict, dict]:
    """Each kernel against its plain version at every M of ``rows`` and
    every (K, N) site of the model, int8, int16 and int32 ids, f32 and bf16
    x, and every route (``codebook_plans``): lut bit-exact, codebook within
    ``parity_tolerance`` (16 × the summation-order estimate), which the
    plain version without the cast of weights to bf16 must fail; every
    launch run twice, bit-identical; lut also on out-of-range ids
    (``lut_out_of_range``).  Returns the worst errors and, per codebook
    route, the largest share of the limit it reached."""
    import torch
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels._common import canonical_idx
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {"codebook_matmul": 0.0, "lut_matmul": 0.0}
    shares, n_cb, n_lut = {}, 0, 0
    cases = [(M, K, N) for M in rows for K, N in sorted(set(SITES.values()))]
    cases += [(3, 100, 130), (40, 100, 130)]          # ragged edges
    for M, K, N in cases:
        for idt, W in ((torch.int8, 256), (torch.int16, N_BOOK),
                       (torch.int32, 5000)):
            if idt == torch.int8:                     # ids ≥ 128 negative
                wi = torch.randint(-128, 128, (K, N), generator=g,
                                   device=dev).to(idt)
            else:
                wi = torch.randint(0, W, (K, N), generator=g,
                                   device=dev).to(idt)
            book = torch.randn(W, generator=g, device=dev) * 0.05
            for xdt in (torch.float32, torch.bfloat16):
                x = torch.randn(M, K, generator=g, device=dev).to(xdt)
                want = cm.codebook_matmul_plain(x, wi, book)
                tol = cm.parity_tolerance(x, wi, book)
                for route, plan in codebook_plans(x, wi):
                    got = cm.codebook_matmul_cuda(x, wi, book, plan=plan)
                    again = cm.codebook_matmul_cuda(x, wi, book, plan=plan)
                    err = (got - want).abs()
                    sh = (err / tol).max().item()
                    if sh > 1:
                        raise AssertionError(
                            f"codebook_matmul {route} M={M} K={K} N={N} {idt} "
                            f"{xdt}: max err {err.max().item()} at {sh:.3f} "
                            "of the limit")
                    if not torch.equal(got, again):
                        raise AssertionError(
                            f"codebook_matmul {route} M={M} K={K} N={N} {idt} "
                            f"{xdt}: two runs differ")
                    key = f"{route} {str(xdt).split('.')[-1]}"
                    shares[key] = max(shares.get(key, 0.0), sh)
                    worst["codebook_matmul"] = max(worst["codebook_matmul"],
                                                   err.max().item())
                    n_cb += 1
                if xdt == torch.bfloat16:
                    no_cast = x.float() @ book[canonical_idx(wi, W).long()]
                    if bool(((no_cast - want).abs() <= tol).all()):
                        raise AssertionError(
                            f"M={M} K={K} N={N} {idt}: the codebook limit "
                            "passes weights left unrounded to bf16")
            C = 256 if idt == torch.int8 else N_BOOK
            lw = wi if idt != torch.int32 else torch.randint(
                0, C, (K, N), generator=g, device=dev).to(idt)
            a = torch.randint(0, LEVELS, (M, K), generator=g, device=dev,
                              dtype=torch.int32)
            tab = torch.randint(-(1 << 20), 1 << 20, (LEVELS, C), generator=g,
                                device=dev, dtype=torch.int32)
            want = lm.lut_matmul_plain(a, lw, tab)
            for route, plan in lut_plans(a, lw, tab):
                got = lm.lut_matmul_cuda(a, lw, tab, plan=plan)
                again = lm.lut_matmul_cuda(a, lw, tab, plan=plan)
                if not (torch.equal(got, want) and torch.equal(got, again)):
                    raise AssertionError(
                        f"lut_matmul {route} M={M} K={K} N={N} {idt}: not "
                        "bit-exact, or two runs differ")
                n_lut += 1
    # overflow-adjacent: |T| near 2^25, 2048 terms → sums wrap int32
    a = torch.randint(0, 9, (5, 2048), generator=g, device=dev,
                      dtype=torch.int32)
    wi = torch.randint(-128, 128, (2048, 70), generator=g, device=dev
                       ).to(torch.int8)
    tab = torch.randint(-(1 << 25), 1 << 25, (9, 256), generator=g,
                        device=dev, dtype=torch.int32)
    oor = [(a, wi, tab)] + [lut_out_of_range(g, dev, *shape) for shape in (
        (6, 300, 40, 9, 65), (MAX_BATCH, 2048, 1024, LEVELS, N_BOOK),
        (32, 2048, 6144, LEVELS, N_BOOK))]
    for args in oor:
        want = lm.lut_matmul_plain(*args)
        for route, plan in lut_plans(*args):
            got = lm.lut_matmul_cuda(*args, plan=plan)
            if not (torch.equal(got, want) and torch.equal(
                    got, lm.lut_matmul_cuda(*args, plan=plan))):
                raise AssertionError(
                    f"lut_matmul {route} out-of-range or wrapping case "
                    f"{tuple(args[0].shape)} x {tuple(args[1].shape)} not "
                    "exact, or two runs differ")
    log(f"[parity] M in {rows} × {len(set(SITES.values()))} (K, N) sites, "
        f"and M=3, 40 at K=100 N=130; int8/int16/int32 ids × f32/bf16 x: "
        f"{n_cb} codebook launches over its routes, each run twice "
        f"bit-identical, max abs err {worst['codebook_matmul']:.3e}; share "
        f"of the limit by route: "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(shares.items()))
        + f"; uncast weights fail the limit in every bf16 case; lut "
        f"bit-exact and bit-identical twice in {n_lut} launches (planned, "
        f"then each route forced), and so in the wrapping case and "
        f"{len(oor) - 1} out-of-range cases (w ≥ C, w < −C, a ≥ R, a < −R, "
        f"a·C past 2³¹)")
    return worst, shares


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
    0, negatives and ids ≥ n_pages (bulk copies, byte copies for the
    15-byte page).  Then the multi-pool launch against
    one single-pool launch a pool, bit for bit: int8, bf16 and f32 K and V
    pages with two bf16 scale pools, and with the 15-byte page among them.
    Returns the max abs error (0)."""
    import torch
    from repro_torch.kernels import page_gather as pg
    g = torch.Generator(device=dev).manual_seed(2)

    def same(a, b):
        return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
            a.view(torch.uint8), b.view(torch.uint8))

    def table(B, P):
        pt = torch.randint(-4, N_PAGES + 5, (B, P), generator=g, device=dev,
                           dtype=torch.int32)
        pt[0, :3] = torch.tensor([0, -1, N_PAGES], device=dev)
        return pt

    def layer_pool(shape, dt):
        return torch.randint(-128, 128, (3, N_PAGES) + shape, generator=g,
                             device=dev).to(getattr(torch, dt))[1]

    n = 0
    for shape, dt in GATHER_CASES:
        pool = layer_pool(shape, dt)
        for B, P in GATHER_TABLES:
            pt = table(B, P)
            for ids in (pt, pt.long()):
                want = pg.page_gather_plain(pool, ids)
                got = pg.page_gather_cuda(pool, ids)
                torch.cuda.synchronize()
                if not same(got, want):
                    raise AssertionError(f"page_gather {shape} {dt} table "
                                         f"{(B, P)}: not bit-exact")
                n += 1
    n_many = 0
    for dt in ("int8", "bfloat16", "float32"):
        kv = [layer_pool((PAGE, 8, 128), dt) for _ in range(2)]
        sc = [layer_pool((PAGE, 8), "bfloat16") for _ in range(2)]
        odd = layer_pool((3, 5), "int8")
        for pools in (kv + sc, kv[:1] + [odd] + sc):
            for B, P in GATHER_TABLES:
                pt = table(B, P)
                for ids in (pt, pt.long()):
                    want = [pg.page_gather_cuda(p, ids) for p in pools]
                    got = pg.page_gather_many_cuda(pools, ids)
                    torch.cuda.synchronize()
                    if not all(same(a, b) for a, b in zip(got, want)):
                        raise AssertionError(
                            f"page_gather_many {dt} table {(B, P)}: not "
                            "bit-identical to single launches")
                    n_many += 1
    log(f"[parity] page_gather bit-exact in {n} cases: pages "
        + ", ".join(f"{s} {d}" for s, d in GATHER_CASES)
        + f" × tables {GATHER_TABLES} × int32/int64 ids, with 0, negative and ≥ n_pages ({N_PAGES}) ids; the multi-pool launch "
        f"bit-identical to one launch a pool in {n_many} cases (int8/bf16/"
        f"f32 K and V pages + two bf16 scale pools, and with the 15-byte "
        f"page among them)")
    return 0.0


ACT_KINDS = ("tanh", "relu6", "sigmoid", "rtanh")


def act_quant_parity(dev, rows) -> tuple[float, int]:
    """act_quant against its plain version, both forms, every kind, |A| 2,
    32 and 256, f32 and bf16 x, at every FFN row count of the serving
    paths × 6144 and at odd sizes (1 element; n no multiple of a block).
    Outputs and indices bit-equal but for ties (``parity_ties``); relu6
    bit-equal everywhere.  Returns (max abs err, ties)."""
    import torch
    from repro_torch.kernels import act_quant as aq
    g = torch.Generator(device=dev).manual_seed(4)
    sizes = [(m, D_FF) for m in rows] + [(1,), (1000003,), (3, 257)]
    worst, ties, n = 0.0, 0, 0
    for shape in sizes:
        base = torch.randn(shape, generator=g, device=dev) * 3
        for xdt in (torch.float32, torch.bfloat16):
            x = base.to(xdt)
            for kind in ACT_KINDS:
                for levels in (2, ACT_LEVELS, 256):
                    for form in aq.FORMS:
                        got = aq.act_quant_cuda(x, kind, levels, form=form)
                        want = aq.act_quant_plain(x, kind, levels, form=form)
                        torch.cuda.synchronize()
                        ties += aq.parity_ties(*got, *want, kind, levels)
                        worst = max(worst, (got[0].float() - want[0].float()
                                            ).abs().max().item())
                        n += 1
    log(f"[parity] act_quant in {n} cases (forms kernel/act_apply × "
        f"{len(ACT_KINDS)} kinds × |A| 2/{ACT_LEVELS}/256 × f32/bf16 × "
        f"shapes {sizes}): bit-equal but for {ties} level-boundary ties "
        f"(each one level apart); relu6 bit-equal; max abs err {worst:.3e}")
    return worst, ties


def kmeans_case(values, centers) -> dict:
    """kmeans_assign kernel against the plain version on one input, in
    both forms: exact indices and counts, a second run bit-identical, the
    sums-only form (given the extremes the full form finds itself)
    bit-identical to the full form's sums and counts, the kernel's sums
    within ``sums_tolerance`` of the f64 sums (the contract) and within
    ``fixed_point_bound`` (its own arithmetic's bound, nearly 10³ times
    tighter at the full n), the plain version's within their worst-case
    ``sums_bound`` (its float atomics repeat their roundings on a
    cluster's few distinct values).  Returns the worst errors: kernel −
    plain, and each against the f64 sums, relative to Σ|v| and as a share
    of each limit."""
    import torch
    from repro_torch.kernels import kmeans1d as km
    n, k = values.numel(), centers.numel()
    got = km.kmeans_assign_cuda(values, centers)
    again = km.kmeans_assign_cuda(values, centers)
    ext = km.finite_extremes(values)
    stats = km.kmeans_stats_cuda(values, centers, ext)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"kmeans_assign n={n} k={k}: two runs differ")
    if not (torch.equal(stats[0], got[1]) and torch.equal(stats[1], got[2])):
        raise AssertionError(f"kmeans_assign n={n} k={k}: the sums-only "
                             "form differs from the full form")
    del again, stats
    want = km.kmeans_assign_plain(values, centers)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
        raise AssertionError(f"kmeans_assign n={n} k={k}: idx or counts "
                             "differ")
    exact, abs_sum, n_c = km.exact_sums(values, want[0], k)
    out = {"max_abs_err": (got[1] - want[1]).abs().max().item()}
    fixed = km.fixed_point_bound(exact, abs_sum, n_c, centers, ext, n)
    for name, sums, limit in (
            ("kernel", got[1], km.sums_tolerance(abs_sum, n_c, n)),
            ("kernel_fixed_point", got[1], fixed),
            ("plain", want[1], km.sums_bound(abs_sum, n_c))):
        err = (sums.double() - exact).abs()
        if bool((err > limit).any()):
            raise AssertionError(f"kmeans_assign n={n} k={k}: {name} sums "
                                 "beyond their limit")
        out[f"{name}_rel_err"] = (err / abs_sum.clamp(min=1e-300)).max().item()
        out[f"{name}_share_of_limit"] = (err / limit.clamp(min=1e-300)
                                         ).max().item()
    return out


def kmeans_parity(dev) -> float:
    """kmeans_assign on Laplace values with midpoints and centers mixed
    in, for k 2, 1000, 4096 × n 1, 4097, 10⁷, sorted centers with and
    without a duplicate pair.  Returns the max abs sums error."""
    import torch
    g = torch.Generator(device=dev).manual_seed(5)
    worst, n = {}, 0
    for k in (2, 1000, 4096):
        for size in (1, 4097, 10 ** 7):
            for dup in (False, True):
                c = torch.sort(torch.randn(k, generator=g, device=dev)
                               * 0.05).values
                if dup and k > 3:
                    c[2] = c[1]
                u = torch.rand(size, generator=g, device=dev) - 0.5
                v = -0.05 * torch.sign(u) * torch.log1p(-2 * u.abs())
                mids = (c[:-1] + c[1:]) / 2.0
                special = torch.cat([mids, c])[:max(size // 4, 1)]
                v[:special.numel()] = special
                v = v[torch.randperm(size, generator=g, device=dev)]
                r = kmeans_case(v.contiguous(), c.contiguous())
                worst = {k_: max(worst.get(k_, 0.0), x) for k_, x in r.items()}
                n += 1
    log(f"[parity] kmeans_assign in {n} cases (k 2/1000/4096 × n 1/4097/"
        f"1e7, midpoints and centers among the values, with and without "
        f"duplicate centers): idx and counts exact, two runs bit-identical, "
        f"the sums-only form bit-identical to the full form; "
        f"sums kernel − plain max abs {worst['max_abs_err']:.3e}; against "
        f"the f64 sums, relative to Σ|v|: kernel "
        f"{worst['kernel_rel_err']:.2e} ({worst['kernel_share_of_limit']:.4f}"
        f" of its tolerance, "
        f"{worst['kernel_fixed_point_share_of_limit']:.4f} of its "
        f"fixed-point bound), plain {worst['plain_rel_err']:.2e} "
        f"({worst['plain_share_of_limit']:.4f} of its bound)")
    return worst["max_abs_err"]


def centers_diff(got, want, values) -> tuple:
    """Two k-means codebooks of the same values: (|Δ| by center, its limit
    by center, values whose index differs).  The limit: KM_RTOL of the
    largest center, plus, where a value near a midpoint fell to the other
    side in some Lloyd step, 4 neighbouring gaps over the center's count."""
    import torch
    from repro_torch.core.clustering import assign_to_centers
    got, want = got.double().cpu(), want.double().cpu()
    scale = want.abs().max().item()
    gi = assign_to_centers(values, got.float().to(values.device))
    wi = assign_to_centers(values, want.float().to(values.device))
    n_c = torch.bincount(wi.long(), minlength=want.numel()).cpu().double()
    gap = torch.maximum(torch.diff(want, prepend=want[:1]),
                        torch.diff(want, append=want[-1:]))
    tol = KM_RTOL * scale + 4 * gap / n_c.clamp(min=1)
    return (got - want).abs(), tol, int((gi != wi).sum())


def centers_agree(got, want, values) -> tuple[int, float]:
    """Two k-means codebooks of the same values, from sums added in other
    orders: each center within KM_RTOL of the largest, or, where a value
    near a midpoint fell to the other side in some Lloyd step, within 4
    neighbouring gaps over the center's count (at most 1 % of centers).
    Returns (values whose index differs, the largest |Δ| over the
    largest center)."""
    d, tol, n_diff = centers_diff(got, want, values)
    scale = want.abs().max().item()
    if bool((d > tol).any()) or float((d > KM_RTOL * scale).double().mean()) \
            > 0.01:
        raise AssertionError(f"k-means codebooks differ: max |Δ| "
                             f"{d.max().item():.3e}, {(d / tol).max():.2f} "
                             "of the limit")
    return n_diff, d.max().item() / scale


def exact_stats(values, centers, extremes=None):
    """A Lloyd step's (sums, counts) with the sums added in f64 and
    rounded to f32 once: the yardstick of the kernel's sums."""
    from repro_torch.core.clustering import assign_to_centers
    from repro_torch.kernels import kmeans1d as km
    v = values.reshape(-1).float()
    sums, _, n_c = km.exact_sums(v, assign_to_centers(v, centers),
                                 centers.numel())
    return sums.float(), n_c.float()


def drift_recorder(stats_fn, iters: int):
    """An ``ops.kmeans_stats`` for ``kmeans1d``'s Lloyd loop that returns
    ``stats_fn``'s (sums, counts) unchanged and carries, per center, a
    limit on how far another k-means of the same values, from the same
    init, may drift from this one through rounding.  Each step adds, per
    center, this run's f32 running sums' worst-case error (``sums_bound``)
    and the kernel's fixed-point error (``fixed_point_bound``), over the
    center's count, and one rounding of each mean; the new centers' sort
    carries the sums with them; a candidate's first step starts from 0.
    A step does not grow the drift it inherits: Lloyd's map in 1-D does
    not expand distances for a log-concave density (Kieffer 1983), which
    is the assumption this limit rests on.  Returns (stats function,
    [(final centers, limit) per candidate])."""
    import torch
    from repro_torch.core.clustering import assign_to_centers
    from repro_torch.kernels import kmeans1d as km
    done, state = [], {"step": 0, "limit": None}

    def stats(values, centers, extremes=None):
        sums, counts = stats_fn(values, centers, extremes)
        v = values.reshape(-1).float()
        k = centers.numel()
        exact, abs_sum, n_c = km.exact_sums(
            v, assign_to_centers(v, centers), k)
        ext = km.finite_extremes(v) if extremes is None else extremes
        step = (km.sums_bound(abs_sum, n_c)
                + km.fixed_point_bound(exact, abs_sum, n_c, centers, ext,
                                       v.numel())) / n_c.clamp(min=1)
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                          centers)
        step = torch.where(n_c > 0, step + 2 * 2.0 ** -24
                           * new.double().abs(), torch.zeros_like(step))
        if state["step"] % iters == 0:
            state["limit"] = torch.zeros_like(step)
        order = torch.sort(new).indices
        state["limit"] = (state["limit"] + step)[order]
        state["step"] += 1
        if state["step"] % iters == 0:
            done.append((new[order], state["limit"]))
        return sums, counts
    return stats, done


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


def reduced_working_point(dev):
    """The reduced qwen3 at the paper's working point (|A| = 32, k-means
    |W| = 1000, global), clustered on the CPU; its index-form params served
    on the card and on the CPU (dense/codebook/lut contiguous, codebook and
    lut with int8 pages): greedy tokens must agree.  Then k-means of the
    same weights on the card against a CPU k-means whose Lloyd steps add
    their sums in f64 and round once (``centers_agree``; the kernel sums
    exactly but for its fixed-point rounding), and beside the CPU path's
    own, whose f32 running sums drift further: held to the rounding those
    sums and the kernel's fixed-point sums can add up over the Lloyd steps
    (``drift_recorder``)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.kernels import ops
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine, to_codebook_params
    cfg = configs.get("qwen3-1.7b").reduced().replace(n_layers=2).quantized(
        levels=ACT_LEVELS, n_weights=N_BOOK, method="kmeans")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    wq = cfg.wq
    stats_fn = ops.kmeans_stats
    ops.kmeans_stats, candidates = drift_recorder(stats_fn, wq.kmeans_iters)
    try:
        pq, st = cluster_params(params, wq, init_state(wq), wq.interval)
    finally:
        ops.kmeans_stats = stats_fn
    cp = to_codebook_params(pq, wq, st)
    cp_dev = _to(cp, dev)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 11, [300, 2, 5, 7, 1, 8]]
    ops.reset_launch_counts()
    n_fwd = 0
    for be, kw in (("dense", {}), ("codebook", {}), ("lut", {}),
                   ("codebook", dict(paged=True, page_size=4,
                                     kv_dtype="int8")),
                   ("lut", dict(paged=True, page_size=4, kv_dtype="int8"))):
        kw = dict(max_len=64, max_batch=2, backend=be, **kw)
        on_cpu = ServeEngine(model, cp, device="cpu", **kw).serve(
            prompts, max_new=8)
        e = ServeEngine(model, cp_dev, device=dev, **kw)
        on_dev = e.serve(prompts, max_new=8)
        n_fwd += e.n_forwards
        if on_cpu != on_dev:
            raise AssertionError(f"reduced working point, {be} {kw}: card "
                                 f"tokens {on_dev} != CPU tokens {on_cpu}")
    counts = ops.launch_counts()
    if counts["act_quant"] != cfg.n_layers * n_fwd:
        raise AssertionError(f"reduced working point: {counts['act_quant']}"
                             f" act_quant launches over {n_fwd} forwards")
    ops.reset_launch_counts()
    _, st_dev = cluster_params(_to(params, dev), wq, init_state(wq),
                               wq.interval)
    if ops.launch_counts()["kmeans_assign"] != 2 * wq.kmeans_iters:
        raise AssertionError(f"reduced k-means: {ops.launch_counts()} "
                             "launches")
    flat = torch.cat([v.reshape(-1).float() for v in _leaves(params)])
    ops.kmeans_stats = exact_stats
    try:
        _, st_exact = cluster_params(params, wq, init_state(wq), wq.interval)
    finally:
        ops.kmeans_stats = stats_fn
    book = st_dev.codebooks[""]
    n_diff, rel = centers_agree(book, st_exact.codebooks[""], flat)
    d, tol, f32_diff = centers_diff(book, st.codebooks[""], flat)
    # the drift from the CPU path's own f32 running sums, held to the
    # rounding carried through the steps of the candidate that won there
    won = [lim for c, lim in candidates
           if torch.equal(c, st.codebooks[""])]
    if len(candidates) != 2 or not won:
        raise AssertionError("reduced k-means: the CPU path's codebook is "
                             "neither candidate's final centers")
    drift = torch.where(d == 0, torch.zeros_like(d), d / won[0])
    if bool((drift > 1).any()):
        raise AssertionError(f"reduced k-means: the card's codebook drifts "
                             f"from the CPU path's f32 one by "
                             f"{drift.max().item():.2f} of the rounding "
                             "carried through the Lloyd steps")
    log(f"[reduced] working point (|A|={ACT_LEVELS}, k-means |W|={N_BOOK}, "
        f"clustered on the CPU): dense/codebook/lut contiguous and "
        f"codebook/lut int8-paged tokens on the card equal the CPU's; "
        f"{counts['act_quant']} act_quant launches (= {cfg.n_layers} × "
        f"{n_fwd} forwards); k-means on the card ({2 * wq.kmeans_iters} "
        f"kmeans_assign launches) vs the CPU with f64 sums: max |Δ center| "
        f"{rel:.3e} of the largest, w_idx differs for {n_diff}/"
        f"{flat.numel()} weights ({n_diff / flat.numel():.2e}); vs the CPU "
        f"path's f32 running sums: max |Δ center| "
        f"{d.max().item() / st.codebooks[''].abs().max().item():.3e}, "
        f"{drift.max().item():.3f} of the rounding its sums and the "
        f"kernel's can carry through the Lloyd steps (at center "
        f"{int(drift.argmax())}; {(d / tol).max().item():.2f} of the "
        f"centers_agree limit), w_idx differs for {f32_diff} weights")


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _to_f32(tree):
    """Float leaves in f32, index leaves as they are (shared, not copied)."""
    import torch
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.to(torch.float32) if tree.is_floating_point() else tree


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


def kernel_ms(fn, match: str, reps: int = 3) -> float:
    """Device ms of one call of ``fn``, which launches each kernel whose
    name holds ``match`` once: the sum of those kernels' mean durations
    over ``reps`` profiled calls.  For a wrapper that syncs with the host
    (the k-means forms read their overflow flag), which ``time_ms`` cannot
    queue behind a device-side sleep."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and match in e.key
           and e.count]
    if not evs:
        raise AssertionError(f"no {match} kernel in the profile")
    return sum(e.self_device_time_total / e.count for e in evs) / 1e3


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
    stats["lut_path_ids"] = lut_path_ids(dev, eng["lut"], prompts, t32, l32,
                                         cfg.n_layers)
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


def lut_path_ids(dev, e, prompts, t32, l32, n_layers) -> dict:
    """lut_matmul on the serving path's own activation ids: every call of a
    4-request serve and of a 1 × 32 prefill through engine ``e`` captured
    (a_idx copied; ids and table are the model's), then one decode forward
    (M = 4) and the prefill forward (M = 32), 7 × n_layers launches each,
    replayed on each lut route, and again with uniformly random row ids of
    the same shapes.  The middle layer's calls are held bit-exact against
    the plain version on both routes.  Returns ms per forward by route and
    ids, and per site of the middle layer."""
    import torch
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import ops
    per_fwd = 7 * n_layers
    calls, orig = [], ops.lut_matmul

    def rec(a, w, t):
        calls.append((a.clone(), w, t))
        return orig(a, w, t)
    ops.lut_matmul = rec
    try:
        e.serve(prompts[:4], max_new=16)
        n_serve = len(calls)
        e._prefill(t32, l32)
    finally:
        ops.lut_matmul = orig
    fwds = [calls[i:i + per_fwd] for i in range(0, n_serve, per_fwd)]
    dec = [f for f in fwds if all(c[0].shape[0] == MAX_BATCH for c in f)]
    pre = calls[n_serve:]
    if not dec or len(pre) != per_fwd or pre[0][0].shape[0] != 32:
        raise AssertionError(f"lut calls captured: {len(calls)}, decode "
                             f"forwards {len(dec)}, prefill {len(pre)}")
    g = torch.Generator(device=dev).manual_seed(11)
    res, mid = {}, n_layers // 2
    for tag, fwd in (("decode", dec[len(dec) // 2]), ("prefill_32", pre)):
        rnd = [(torch.randint(0, LEVELS, a.shape, generator=g, device=dev,
                              dtype=torch.int32), w, t) for a, w, t in fwd]
        for ids, cs in (("path", fwd), ("random", rnd)):
            for route in ("planned", "smem", "l2"):
                plans = [dict((r.split()[0], p) for r, p in lut_plans(*c))
                         [route] for c in cs]
                res[f"{tag} {ids} {route}"] = time_ms(
                    lambda: [lm.lut_matmul_cuda(*c, plan=p)
                             for c, p in zip(cs, plans)], reps=3, warm=1)
        for i in range(7 * mid, 7 * mid + 7):             # the middle layer
            a, w, t = fwd[i]
            want = lm.lut_matmul_plain(a, w, t)
            for route, plan in lut_plans(a, w, t):
                if not torch.equal(lm.lut_matmul_cuda(a, w, t, plan=plan),
                                   want):
                    raise AssertionError(f"lut_matmul {route} on the path's "
                                         f"ids ({tag}, call {i}) not exact")
                res[f"{tag} site {i % 7} {route.split()[0]}"] = time_ms(
                    lambda: lm.lut_matmul_cuda(a, w, t, plan=plan))
        # distinct rows the forward's ids touch, of the table's LEVELS
        res[f"{tag} distinct rows"] = sum(
            int(torch.unique(a).numel()) for a, _, _ in fwd) / len(fwd)
    log("[main] lut_matmul on the path's own ids (a forward = "
        f"{per_fwd} launches; ms a forward by route, path ids then random "
        "row ids): " + "; ".join(
            f"{tag}: " + ", ".join(
                f"{ids} {r} {res[f'{tag} {ids} {r}']:.3f}"
                for ids in ("path", "random") for r in ("planned", "smem", "l2"))
            + f" (distinct row ids a call {res[f'{tag} distinct rows']:.0f}"
            f" of {LEVELS})" for tag in ("decode", "prefill_32")))
    log("[main] lut_matmul on the path's ids, middle layer by site, ms "
        "planned / smem / l2: " + "; ".join(f"{tag} " + ", ".join(
            f"{site} " + "/".join(f"{res[f'{tag} site {j} {r}']:.4f}"
                                  for r in ("planned", "smem", "l2"))
            for j, site in enumerate(SITES)) for tag in ("decode", "prefill_32")))
    return res


def _pool_clean(pool) -> bool:
    """No page is referenced except by its prefix-cache registration."""
    return all(int(pool.ref[p]) == (1 if p in pool.key_of else 0)
               for p in range(pool.n_pages))


def paged_path(dev, cfg, model, cp, chats) -> tuple[dict, dict]:
    """The paged path at full width: ServeEngine(paged=True), page PAGE,
    max_len PAGED_MAX_LEN, MAX_BATCH slots, 16 new tokens per request.
    Each run is counted alone: page_gather launches must be one a layer
    (K, V and, with int8 pages, their scales in one launch) × layers ×
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
        other = "lut_matmul" if be == "codebook" else "codebook_matmul"
        if (counts["page_gather"] != n_l * fwd
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
            f"page_gather launches (= one a layer × {n_l} × {fwd}), "
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
           f"({pg_ms / busy:.3f}; {n_l} launches, "
           f"{1e3 * pg_ms / n_l:.2f} us each); top: "
           + "; ".join(f"{k} {ms:.3f}ms×{n}" for k, ms, n in top)
           if busy else "not measured (the profiler saw no device time)")
        + f" | contiguous bf16 {med(c_dec):.2f} ms, device busy "
        + (f"{c_busy:.2f} ms" if c_busy else "not measured")
        + f" | paged prefill chunk 1×{PAGE} at start {SYSTEM_LEN}: "
        f"{med(pre):.2f} ms; peak memory {stats['peak_mem_gib']:.2f} GiB")
    return stats, launches


def working_point(dev, prompts, chats, base, peaks) -> tuple:
    """Phase 7: the weights of phase 5 at the paper's working point,
    ``quantized(levels=32, n_weights=1000, method="kmeans")``, global.

    Clusters on the card (exactly 2 × kmeans_iters kmeans_assign
    launches), compares the k-means MSE with laplacian_l1's, holds
    kmeans_assign against its plain version at the full n (and times it),
    then serves: codebook (8 requests) and lut (4) contiguous, codebook
    with int8 pages (the 8 chats), with act_quant launches 28 a forward.
    Returns (stats, launches, kmeans timing row)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core import clustering
    from repro_torch.core.activations import ActQuantConfig, act_index
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import kmeans1d as km
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine, to_codebook_params

    cfg = configs.get("qwen3-1.7b").quantized(
        levels=ACT_LEVELS, n_weights=N_BOOK, method="kmeans")
    wq, n_l = cfg.wq, cfg.n_layers
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    ops.reset_launch_counts()
    (pq, state), t_cl = timed(lambda: cluster_params(params, wq,
                                                     init_state(wq),
                                                     wq.interval))
    cl_counts = ops.launch_counts()
    if cl_counts["kmeans_assign"] != 2 * wq.kmeans_iters:
        raise AssertionError(f"cluster_params: {cl_counts} launches, want "
                             f"{2 * wq.kmeans_iters} kmeans_assign")
    stats = {"cluster_s": t_cl, "kmeans_assign_launches":
             cl_counts["kmeans_assign"],
             "cluster_peak_mem_gib": torch.cuda.max_memory_allocated()
             / 2 ** 30}
    book = state.codebooks[""]
    flat = torch.cat([v.reshape(-1) for v in _leaves(params)]).float()
    del params
    n = flat.numel()
    lap = clustering.laplacian_l1_centers(flat, N_BOOK)
    stats.update(n_values=n,
                 mse_kmeans=clustering.quantization_mse(flat, book),
                 mse_laplacian_l1=clustering.quantization_mse(flat, lap))
    km_err = kmeans_case(flat, book)
    bounds = ((book[:-1] + book[1:]) / 2.0).contiguous()
    ext = km.finite_extremes(flat)
    b_ops = 2 * n * int(np.ceil(np.log2(N_BOOK))) / peaks["f32"]
    forms = {}
    # bytes each form must move: values read; idx written (full, search);
    # centers read; sums and counts written (full, stats).  Device time of
    # the kernels alone: the full and sums-only wrappers read the overflow
    # flag after the launch (one sync), and the full form's finds its
    # extremes first
    for form, fn, nbytes in (
            ("search", lambda: km.kmeans_search_cuda(flat, book),
             8 * n + 4 * N_BOOK),
            ("stats", lambda: km.kmeans_stats_cuda(flat, book, ext),
             4 * n + 12 * N_BOOK),
            ("full", lambda: km.kmeans_assign_cuda(flat, book),
             8 * n + 12 * N_BOOK)):
        b_bytes = nbytes / peaks["bytes"]
        forms[form] = {"ms": kernel_ms(fn, "kmeans"),
                       "bound_ms": 1e3 * max(b_bytes, b_ops),
                       "bound_by": ("bytes" if b_bytes >= b_ops
                                    else "operations")}
    # the search form does not sync: CUDA events around queued calls, as
    # every other kernel is timed, check the profiler's reading
    forms["search"]["events_ms"] = time_ms(
        lambda: km.kmeans_search_cuda(flat, book), reps=3, warm=1)
    # the row is the form the clustering event launches (sums only); the
    # others stand under "forms"
    km_row = {"n": n, "k": N_BOOK, "values": "qwen3-1.7b weights, f32",
              "form": "stats (kmeans_stats_cuda)",
              **km_err, **forms["stats"], "forms": forms,
              "plain_ms": time_ms(lambda: km.kmeans_stats_plain(flat, book),
                                  reps=1, warm=1),
              "library_ms": None,
              "partial_library_ms": {"torch.searchsorted": time_ms(
                  lambda: torch.searchsorted(bounds, flat, right=True,
                                             out_int32=True), reps=3,
                  warm=1)}}
    del flat, bounds
    log(f"[point] qwen3-1.7b at quantized(levels={ACT_LEVELS}, "
        f"n_weights={N_BOOK}, method='kmeans'): cluster_params on the card "
        f"{t_cl:.2f}s over {n} values, {cl_counts['kmeans_assign']} "
        f"kmeans_assign launches (= 2 inits × {wq.kmeans_iters}), peak "
        f"memory {stats['cluster_peak_mem_gib']:.2f} GiB; quantization MSE "
        f"k-means {stats['mse_kmeans']:.4e} vs laplacian_l1 "
        f"{stats['mse_laplacian_l1']:.4e}; kmeans_assign at the full n: "
        f"idx/counts exact, two runs bit-identical, sums-only form "
        f"bit-identical to the full form, sums against the f64 "
        f"sums relative to Σ|v|: kernel {km_err['kernel_rel_err']:.2e} "
        f"({km_err['kernel_share_of_limit']:.4f} of its tolerance, "
        f"{km_err['kernel_fixed_point_share_of_limit']:.4f} of its "
        f"fixed-point bound), plain "
        f"{km_err['plain_rel_err']:.2e} ({km_err['plain_share_of_limit']:.4f}"
        f" of its bound)")
    log(f"[time] kmeans_assign n={n} k={N_BOOK}, by form (ms, bound): "
        + ", ".join(f"{f} {r['ms']:.3f} ({r['bound_ms']:.3f} {r['bound_by']})"
                    for f, r in forms.items())
        + f" from the profiler's kernel times; search from CUDA events "
        f"{forms['search']['events_ms']:.3f}"
        + f"; plain {km_row['plain_ms']:.2f}, torch.searchsorted alone "
        f"{km_row['partial_library_ms']['torch.searchsorted']:.3f}")

    cp = to_codebook_params(pq, wq, state)
    del pq
    kw = dict(max_len=128, max_batch=MAX_BATCH, device=dev)
    eng = {be: ServeEngine(model, cp, backend=be, **kw)
           for be in ("dense", "codebook", "lut")}
    eng["paged"] = ServeEngine(model, cp, backend="codebook", paged=True,
                               page_size=PAGE, kv_dtype="int8",
                               max_len=PAGED_MAX_LEN, max_batch=MAX_BATCH,
                               device=dev)
    launches = {}
    for name, reqs in (("codebook", prompts[:8]), ("lut", prompts[:4]),
                       ("paged", chats[:8])):
        e = eng[name]
        be = e.backend
        ops.reset_launch_counts()
        f0 = e.n_forwards
        out, secs = timed(lambda: e.serve(reqs, max_new=16))
        counts, fwd = ops.launch_counts(), e.n_forwards - f0
        want = {"act_quant": n_l * fwd, f"{be}_matmul": 7 * n_l * fwd,
                "page_gather": n_l * fwd if name == "paged" else 0}
        if any(counts[k_] != v for k_, v in want.items()):
            raise AssertionError(f"working point {name}: launches {counts} "
                                 f"over {fwd} forwards, want {want}")
        for seq in out:
            if not all(0 <= t < cfg.vocab for t in seq):
                raise AssertionError("token id out of range")
        for k_, v in want.items():
            launches[k_] = launches.get(k_, 0) + v
        stats[f"{name}_serve_tok_s"] = 16 * len(reqs) / secs
        log(f"[point] {name}: {len(reqs)} requests, {fwd} forwards, "
            f"{counts['act_quant']} act_quant launches (= {n_l} × {fwd}), "
            + ", ".join(f"{counts[k_]} {k_}" for k_ in want
                        if k_ != "act_quant" and want[k_])
            + f"; serve {16 * len(reqs)} tokens in {secs:.3f}s → "
            f"{16 * len(reqs) / secs:.1f} tok/s")
    launches["kmeans_assign"] = cl_counts["kmeans_assign"]

    # prefill logits codebook vs dense, with every FFN input captured: in
    # bf16 as served, then with the same index-form weights in f32
    toks, lens = eng["dense"]._pad_prompts(prompts[:4])
    act = ActQuantConfig("relu6", ACT_LEVELS)

    def compare(engs, tag):
        captured, orig, lg = {}, L.ffn_act, {}
        for be, e in engs.items():
            def capture(x, kind, levels, be=be):
                captured.setdefault(be, []).append(x.detach().clone())
                return orig(x, kind, levels)
            L.ffn_act = capture
            try:
                lg[be] = e._prefill(toks, lens)[0][:, -1, :cfg.vocab].float()
            finally:
                L.ffn_act = orig
        if not all(bool(torch.isfinite(v).all()) for v in lg.values()):
            raise AssertionError("non-finite prefill logits")
        by_layer = [int((act_index(act, a) != act_index(act, b)).sum())
                    for a, b in zip(captured["dense"], captured["codebook"])]
        differ = sum(by_layer)
        total = sum(a.numel() for a in captured["dense"])
        per = captured["dense"][0].numel()
        r = {"prefill_logits_max_abs_diff": (lg["codebook"] - lg["dense"]
                                             ).abs().max().item(),
             "max_abs_logit": lg["dense"].abs().max().item(),
             "argmax_agree": int((lg["codebook"].argmax(-1)
                                  == lg["dense"].argmax(-1)).sum()),
             "ffn_level_differ_share": differ / total,
             "ffn_level_differ_share_by_layer": [b / per for b in by_layer]}
        log(f"[point] {tag} prefill logits codebook vs dense: max |Δ| "
            f"{r['prefill_logits_max_abs_diff']:.4e} (max |logit| "
            f"{r['max_abs_logit']:.4e}), argmax agree {r['argmax_agree']}/4; "
            f"FFN elements on another level: {differ}/{total} "
            f"({differ / total:.2e}) over {len(by_layer)} layers; by layer "
            + ", ".join(f"{b / per:.1e}" for b in by_layer))
        return r, captured

    bf16, captured = compare({be: eng[be] for be in ("dense", "codebook")},
                             "bf16")
    stats.update(bf16)
    # The same weights in f32: dense and codebook then differ only in the
    # order of their f32 sums, 2⁻¹⁶ of bf16's rounding.  At layer 0, where
    # no earlier flip feeds in, that leaves an element on another level
    # about once in a million; a wrong kernel moves a large share there.
    # Deeper layers carry no limit: a flip moves its FFN output by a whole
    # step, and the layers after it amplify that (on an H100 in f32, 1.3e-6
    # of layer 0's elements flipped and 0.10 of layer 27's), so phase 5's
    # 5 %-of-range logit limit, set for smooth activations, does not apply.
    cp32 = _to_f32(cp)
    m32 = build(cfg.replace(dtype="float32"))
    f32, _ = compare({be: ServeEngine(m32, cp32, backend=be, **kw)
                      for be in ("dense", "codebook")}, "f32")
    stats["f32"] = f32
    del cp32, m32
    if f32["ffn_level_differ_share_by_layer"][0] > 1e-4:
        raise AssertionError(
            f"working point in f32: {f32['ffn_level_differ_share_by_layer'][0]}"
            " of layer 0's FFN elements on another level in codebook and "
            "dense")
    # the kernel against its plain version on one layer's real w1 outputs
    x = captured["codebook"][n_l // 2]
    ties = 0
    for form in aq.FORMS:
        got = aq.act_quant_cuda(x, "relu6", ACT_LEVELS, form=form)
        want_ = aq.act_quant_plain(x, "relu6", ACT_LEVELS, form=form)
        ties += aq.parity_ties(*got, *want_, "relu6", ACT_LEVELS)
    log(f"[point] act_quant on layer {n_l // 2}'s real w1 outputs "
        f"{tuple(x.shape)} bf16, both forms: bit-equal to the plain version")
    del captured, x

    # decode step and prefill, as phase 5 times them
    t32, l32 = eng["dense"]._pad_prompts([(prompts[0] * 4)[:32]])
    for be in ("codebook", "lut"):
        e = eng[be]
        pre = [timed(lambda: e._prefill(t32, l32))[1] for _ in range(4)][1:]
        cache = e.model.init_cache(4, 128, dtype=torch.bfloat16, device=dev)
        cache["pos"][:] = 40
        last = np.zeros(4, np.int64)
        dec = [timed(lambda: e._decode(last, cache))[1] for _ in range(6)][1:]
        busy, top, aq_ms = device_time(lambda: e._decode(last, cache),
                                       match="act_quant")
        st = {"prefill_ms": 1e3 * sorted(pre)[len(pre) // 2],
              "decode_step_ms": 1e3 * sorted(dec)[len(dec) // 2],
              "decode_device_ms": busy or None,
              "act_quant_device_ms": aq_ms or None,
              "decode_top_kernels": top}
        st["decode_idle_share"] = (1 - busy / st["decode_step_ms"]
                                   if busy else None)
        stats[be] = st
        b = base.get(be, {})
        log(f"[point] {be}: prefill 1×32 {st['prefill_ms']:.2f} ms "
            f"(phase 5, act_levels 0: {b.get('prefill_ms', 0):.2f}), decode "
            f"step {st['decode_step_ms']:.2f} ms "
            f"({b.get('decode_step_ms', 0):.2f}), device busy "
            + (f"{busy:.2f} ms ({b.get('decode_device_ms') or 0:.2f}), idle "
               f"share {st['decode_idle_share']:.3f} "
               f"({b.get('decode_idle_share') or 0:.3f}), act_quant "
               f"{aq_ms:.3f} ms of it ({n_l} launches)"
               if busy else "not measured")
            + f"; serve {stats[f'{be}_serve_tok_s']:.1f} tok/s "
            f"({b.get('serve_tok_s', 0):.1f})")
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[point] peak memory {stats['peak_mem_gib']:.2f} GiB")
    del eng, cp, model
    return stats, launches, km_row


def act_quant_times(dev, peaks: dict) -> list:
    """act_quant per call at the FFN's decode (4 × 6144) and prefill
    (32 × 6144) bf16 shapes, relu6 at |A| = 32, output only (as the
    serving site calls it), both forms: kernel, plain, the bound, and the
    library call.  At relu6 with lo = 0 one PyTorch call computes the
    kernel form's arithmetic: ``fake_quantize_per_tensor_affine(x, step,
    0, 0, L − 1)`` = clamp(rint(x·(1/step)), 0, L − 1)·step (clamping
    before or after the rounding is the same for relu6).  The act_apply
    form rounds to bf16 after every operation, which that call does not;
    it stands as the yardstick of both rows, and the elements where it
    differs from each form are counted."""
    import torch
    from repro_torch.kernels import act_quant as aq
    g = torch.Generator(device=dev).manual_seed(6)
    step = 6.0 / (ACT_LEVELS - 1)
    lib = lambda x: torch.fake_quantize_per_tensor_affine(  # noqa: E731
        x, step, 0, 0, ACT_LEVELS - 1)
    res = []
    for M in (MAX_BATCH, 32):
        x = (torch.randn(M, D_FF, generator=g, device=dev) * 3).to(
            torch.bfloat16)
        n = x.numel()
        b_bytes = 4 * n / peaks["bytes"]            # 2 B read, 2 B written
        b_ops = 8 * n / peaks["f32"]
        lib_y = lib(x)
        lib_ms = time_ms(lambda: lib(x), reps=56)
        for form in aq.FORMS:
            y = aq.act_quant_cuda(x, "relu6", ACT_LEVELS, form=form,
                                  with_index=False)[0]
            res.append({
                "M": M, "N": D_FF, "dtype": "bfloat16", "kind": "relu6",
                "levels": ACT_LEVELS, "form": form,
                "ms": time_ms(lambda: aq.act_quant_cuda(
                    x, "relu6", ACT_LEVELS, form=form, with_index=False),
                    reps=56),
                "plain_ms": time_ms(lambda: aq.act_quant_plain(
                    x, "relu6", ACT_LEVELS, form=form, with_index=False),
                    reps=20),
                "library_ms": lib_ms,
                "library_call": "torch.fake_quantize_per_tensor_affine (the "
                                "kernel form's arithmetic)",
                "library_differs": int((lib_y != y).sum()),
                "bound_ms": 1e3 * max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
    for r in res:
        log(f"[time] act_quant {r['M']}×{r['N']} bf16 relu6 |A|={r['levels']}"
            f" {r['form']} form: {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} "
            f"{r['bound_by']}, plain {r['plain_ms']:.4f}, library "
            f"fake_quantize_per_tensor_affine {r['library_ms']:.4f}, which "
            f"differs from this form in {r['library_differs']}/"
            f"{r['M'] * r['N']} elements)")
    return res


def gather_times(dev, peaks: dict) -> tuple[list, list]:
    """page_gather per call at the decode (4 × 32) and prefill-chunk
    (1 × 32) page tables: kernel, plain and library times and
    the bound; then one layer's gather of the paged int8 path (K and V
    pages, their bf16 scales) as one multi-pool launch, four single-pool
    launches and four library calls, against the summed bound.

    The pools are full (layers, n_pages, ...) pools and every call gathers
    from the next layer's slice, so the 28 slices (59 MB of int8 K pages)
    do not sit in the 50 MB L2 as they would not on the serving path.  The
    tables hold distinct live pages, as a full batch's do.  Library: one
    advanced-indexing call on ids clamped beforehand; the plain version is
    the same call after the cast and clamp of the ids.  Each row's calls
    are timed in turns (``time_turns``).  Returns (single-pool rows,
    multi-pool rows)."""
    import torch
    from repro_torch.kernels import page_gather as pg
    g = torch.Generator(device=dev).manual_seed(3)
    n_l, res, many = 28, [], []
    it = [0]

    def cyc(pools, f):
        def run():
            it[0] += 1
            return f(*(p[it[0] % n_l] for p in pools))
        return run

    def tables():
        for B, P in GATHER_TABLES:
            perm = torch.randperm(N_PAGES - 1, generator=g, device=dev) + 1
            yield B, P, perm[:B * P].reshape(B, P).to(torch.int32)

    def pool_of(shape, dt):
        return torch.randint(-128, 128, (n_l, N_PAGES) + shape, generator=g,
                             device=dev).to(getattr(torch, dt))
    for shape, dt in (((PAGE, 8, 128), "int8"), ((PAGE, 8, 128), "bfloat16"),
                      ((PAGE, 8), "bfloat16")):
        full = pool_of(shape, dt)
        page_bytes = full[0, 0].numel() * full.element_size()
        for B, P, pt in tables():
            ids = pt.long()
            nbytes = 2 * B * P * page_bytes + B * P * 4
            t = time_turns({
                "library": cyc([full], lambda p: p[ids]),
                "kernel": cyc([full], lambda p: pg.page_gather_cuda(p, pt)),
                "plain": cyc([full], lambda p: pg.page_gather_plain(p, pt))},
                reps=56)
            res.append({"B": B, "P": P, "page": list(shape), "dtype": dt,
                        "page_bytes": page_bytes,
                        "ms": t["kernel"],
                        "plain_ms": t["plain"], "library_ms": t["library"],
                        "bound_ms": 1e3 * nbytes / peaks["bytes"],
                        "bound_by": "bytes"})
        del full
    pools = [pool_of((PAGE, 8, 128), "int8") for _ in range(2)] + [
        pool_of((PAGE, 8), "bfloat16") for _ in range(2)]
    page_bytes = sum(p[0, 0].numel() * p.element_size() for p in pools)
    for B, P, pt in tables():
        ids = pt.long()
        nbytes = 2 * B * P * page_bytes + B * P * 4
        t = time_turns({
            "library": cyc(pools, lambda *ps: [p[ids] for p in ps]),
            "kernel": cyc(pools, lambda *ps: pg.page_gather_many_cuda(ps, pt)),
            "single": cyc(pools, lambda *ps: [pg.page_gather_cuda(p, pt)
                                              for p in ps]),
            "plain": cyc(pools, lambda *ps:
                         pg.page_gather_many_plain(ps, pt))}, reps=28)
        many.append({"B": B, "P": P, "pools": "int8 K, V (16, 8, 128) + "
                     "bf16 scales (16, 8)", "page_bytes": page_bytes,
                     "ms": t["kernel"], "single_launches_ms": t["single"],
                     "plain_ms": t["plain"], "library_ms": t["library"],
                     "bound_ms": 1e3 * nbytes / peaks["bytes"],
                     "bound_by": "bytes"})
    del pools
    for r in res:
        log(f"[time] page_gather {r['B']}×{r['P']} pages {tuple(r['page'])} "
            f"{r['dtype']} ({r['page_bytes']} B): {r['ms']:.5f} ms (bound {r['bound_ms']:.4f} bytes, plain "
            f"{r['plain_ms']:.5f}, library pool[ids] {r['library_ms']:.5f})")
    for r in many:
        log(f"[time] page_gather_many {r['B']}×{r['P']} one paged int8 "
            f"layer ({r['pools']}, {r['page_bytes']} B a page slot) in one "
            f"launch: {r['ms']:.5f} ms (summed bound {r['bound_ms']:.4f}; four single-pool "
            f"launches {r['single_launches_ms']:.5f}, four pool[ids] "
            f"{r['library_ms']:.5f}, plain {r['plain_ms']:.5f})")
    return res, many


# --- phase 8: kernel timings --------------------------------------------------

TIMED_ROWS = (1, MAX_BATCH, 32, 256)   # a single row, decode, prefill, 4 × 64


def split_sweep(dev) -> dict:
    """What the K split costs and buys at the headline shape (decode, w1
    site): each matmul timed with its planned split and with others (the
    planned tiles and route), ms by splits."""
    import torch
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm
    g = torch.Generator(device=dev).manual_seed(7)
    M, K, N = MAIN_SHAPE
    sets = [(torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16),
             torch.randint(0, N_BOOK, (K, N), generator=g, device=dev
                           ).to(torch.int16),
             torch.randn(N_BOOK, generator=g, device=dev) * 0.05,
             torch.randint(0, LEVELS, (M, K), generator=g, device=dev,
                           dtype=torch.int32),
             torch.randint(-(1 << 20), 1 << 20, (LEVELS, N_BOOK), generator=g,
                           device=dev, dtype=torch.int32)) for _ in range(4)]
    it = [0]

    def cyc(f):
        def run():
            it[0] += 1
            return f(sets[it[0] % 4])
        return run

    def with_splits(p, s):
        kc = -(-(-(-K // s)) // p.stage) * p.stage
        sp = -(-K // kc)
        return p._replace(splits=sp, k_chunk=kc)
    x, wi, book, a, tab = sets[0]
    out = {"codebook_matmul": {}, "lut_matmul": {}}
    p0 = cm.plan_for(x, wi)
    for s in sorted({1, 2, 4, 8, p0.splits}):
        p = with_splits(p0, s)
        out["codebook_matmul"][p.splits] = time_ms(cyc(
            lambda t: cm.codebook_matmul_cuda(*t[:3], plan=p)))
    q0 = lm.plan_for(a, wi, tab)
    for s in sorted({32, 64, q0.splits}):
        p = with_splits(q0, s)
        out["lut_matmul"][p.splits] = time_ms(cyc(
            lambda t: lm.lut_matmul_cuda(t[3], t[1], t[4], plan=p)), reps=10)
    log(f"[time] K splits at {MAIN_SHAPE} (planned: codebook {p0.splits}, "
        f"lut {q0.splits}): " + "; ".join(
            f"{k} " + ", ".join(f"{s} splits {ms:.4f} ms" for s, ms in v.items())
            for k, v in out.items()))
    return out


def kernel_times(dev, peaks: dict, shares: dict) -> dict:
    """Per (M, site) at M in TIMED_ROWS: kernel, plain and library times,
    the bound and the route taken.

    Four copies of each operand set are cycled, so the 2 × 25 MB of ids
    of the widest site do not sit in the 50 MB L2 from the previous call,
    as they would not on the serving path."""
    import torch
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm
    g = torch.Generator(device=dev).manual_seed(1)
    res = {"codebook_matmul": [], "lut_matmul": []}
    for M in TIMED_ROWS:
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
            slow = M >= 256
            # codebook: bytes = x + ids + codebook + f32 out; 2MKN bf16 ops
            nbytes = M * K * 2 + K * N * 2 + N_BOOK * 4 + M * N * 4
            b_bytes = nbytes / peaks["bytes"]
            b_ops = 2 * M * K * N / peaks["bf16"]
            route = cm.plan_for(sets[0][0], sets[0][1]).route
            res["codebook_matmul"].append({
                "M": M, "K": K, "N": N, "site": site, "route": route,
                "share_of_limit": shares.get(f"{route} bfloat16"),
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
            # the route not planned here, timed beside the planned one
            route = lm.plan_for(a, wi, tab).route
            other = [(r, p) for r, p in lut_plans(a, wi, tab)[1:]
                     if r != route]
            res["lut_matmul"].append({
                "M": M, "K": K, "N": N, "site": site, "route": route,
                "other_routes_ms": {r: time_ms(cyc(
                    lambda s, p=p: lm.lut_matmul_cuda(s[3], s[1], s[4],
                                                      plan=p)),
                    reps=3 if slow else 20, warm=1 if slow else 3)
                    for r, p in other},
                "ms": time_ms(cyc(lambda s: lm.lut_matmul_cuda(s[3], s[1],
                                                               s[4])),
                              reps=3 if slow else 20, warm=1 if slow else 3),
                "plain_ms": time_ms(cyc(lambda s: lm.lut_matmul_plain(
                    s[3], s[1], s[4])), reps=1 if slow else 3, warm=1),
                "library_ms": None,
                "bound_ms": 1e3 * max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
            del sets
    res["split_sweep"] = split_sweep(dev)
    for name, rows in res.items():
        if name == "split_sweep":
            continue
        for M in TIMED_ROWS:
            rs = [r for r in rows if r["M"] == M]
            log(f"[time] {name} M={M}: " + ", ".join(
                f"{r['site']} {r['ms']:.4f}ms ({r['route']}"
                + "".join(f"; {o} route {ms:.4f}"
                          for o, ms in r.get("other_routes_ms", {}).items())
                + f") (bound {r['bound_ms']:.4f} "
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
    log("[time] codebook_matmul share of its parity limit by route (phase 3): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(shares.items())))
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
    rows = path_rows(prompts, chats, MAX_BATCH)
    worst, shares = parity(dev, sorted(set(rows) | {17}))
    worst["page_gather"] = gather_parity(dev)
    worst["act_quant"], _ = act_quant_parity(dev, rows)
    worst["kmeans_assign"] = kmeans_parity(dev)
    reduced_against_cpu(dev)
    reduced_working_point(dev)
    cfg, model, cp = compressed_model(dev)
    stats, launches = main_path(dev, cfg, model, cp, prompts)
    p_stats, p_launches = paged_path(dev, cfg, model, cp, chats)
    del model, cp
    torch.cuda.empty_cache()
    w_stats, w_launches, km_row = working_point(dev, prompts, chats, stats,
                                                peaks)
    torch.cuda.empty_cache()
    times = kernel_times(dev, peaks, shares)
    g_times, g_many = gather_times(dev, peaks)
    a_times = act_quant_times(dev, peaks)

    by_path = {k: {"contiguous": launches.get(k, 0),
                   "paged": p_launches.get(k, 0),
                   "working_point": w_launches.get(k, 0)}
               for k in TPU_KERNELS}
    kernels = []
    for kname in TPU_KERNELS:
        if kname == "page_gather":
            # the multi-pool launch at the decode table: the form every
            # paged layer launches (single-pool rows under "shapes")
            head = next(r for r in g_many
                        if (r["B"], r["P"]) == GATHER_TABLES[0])
            shape = {"B": head["B"], "P": head["P"], "pools": head["pools"],
                     "pool": [cfg.n_layers, N_PAGES]}
            shapes = g_many + g_times
        elif kname == "act_quant":
            head = next(r for r in a_times if r["M"] == MAX_BATCH
                        and r["form"] == "act_apply")
            shape = {k_: head[k_] for k_ in ("M", "N", "dtype", "kind",
                                             "levels", "form")}
            shapes = a_times
        elif kname == "kmeans_assign":
            head = km_row
            shape = {"n": km_row["n"], "k": km_row["k"],
                     "values": km_row["values"]}
            shapes = [km_row]
        else:
            head = next(r for r in times[kname]
                        if (r["M"], r["K"], r["N"]) == MAIN_SHAPE)
            shape = {"M": MAIN_SHAPE[0], "K": MAIN_SHAPE[1],
                     "N": MAIN_SHAPE[2], "ids": "int16", "x": "bfloat16",
                     "kernel_route": head["route"]}
            shapes = times[kname]
            if kname == "lut_matmul":     # w1 of the middle layer, decode
                w1 = list(SITES).index("w1")
                shape["path_ids_ms"] = {
                    r: stats["lut_path_ids"][f"decode site {w1} {r}"]
                    for r in ("planned", "smem", "l2")}
        kernels.append({
            "name": kname, "route": "cuda",
            "kernel_route": head.get("route", "cuda"),
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": TPU_KERNELS[kname],
            "launches": sum(by_path[kname].values()),
            "launches_by_path": by_path[kname],
            "max_abs_err": worst[kname],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": shape, "shapes": shapes})
        if not kernels[-1]["launches"]:
            raise AssertionError(f"{kname}: no launch on any path")
    log(f"[done] {time.time() - t_start:.1f}s in all; contiguous path "
        + json.dumps(stats))
    log("[done] paged path " + json.dumps(p_stats))
    log("[done] working point " + json.dumps(w_stats))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
