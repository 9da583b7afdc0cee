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
   in both forms (4 kinds × |A| 2, 32, 256 × f32/bf16), without and with
   its multiplier, at every FFN row count of the serving paths × 6144 and
   odd sizes, bit-equal but for counted level-boundary ties; the gated
   launch codebook_swiglu (the FFN's gate and up products with act_quant
   as their epilogue) at every FFN row count and 17 and an odd N, on both
   routes, bit-equal to the unfused chain of CUDA launches and (relu6) to
   the plain epilogue of its accumulators, twice bit-identical;
   kmeans_assign (k 2, 1000, 4096 × n 1,
   4097, 10⁷, values on midpoints, duplicate centers) with exact indices
   and counts, sums within a summation-order limit, bit-identical twice,
   its sums-only form bit-identical to the full form;
4. reduced model: a 2-layer qwen3 serves contiguous and paged (bf16 and
   int8 pages) through every backend on the card and on the CPU, with
   equal greedy tokens; codeqwen1.5-7b reduced with its int8 contiguous
   cache (``kv_quant``, untied head) the same; then at the paper's
   working point
   (|A| = 32 activations, k-means |W| = 1000, clustered on the CPU), and
   k-means of its weights on the card against the CPU's;
5. contiguous path: qwen3-1.7b at full width and depth, random weights
   from a seeded generator, compressed to |W| = 1000 (laplacian_l1,
   global) and served through ``ServeEngine.serve``/``generate`` with the
   dense, codebook and lut backends, each on the graph route (a decode
   step is one CUDA graph replay) against the eager route
   (``graph_vs_eager``): serves in turns with equal tokens, generate
   equal, a second serve and generate capturing nothing, kernel launches
   counted per forward whose wrappers ran (a captured forward counts
   once, a replay never), serve tok/s and peak memory of each route, and
   one decode step on each route in turns (wall ms, the profiler's device
   ms, idle share and kernels, the backend's kernels a step by name, the
   replayed step's logits bit-equal to the eager step's); logits held
   against the dense backend; lut's split-K scratch outgrown after a
   capture (tokens still equal); lut_matmul replayed on the serving path's
   own activation ids (an eager serve's decode forward and a 1 × 32
   prefill, 196 launches each) on its planned route and on each route
   forced, beside random row ids of the same shapes, bit-exact on the
   middle layer;
6. paged path: the same model served by ``ServeEngine(paged=True)``, page
   16, to 8 chat requests sharing a 96-token system prompt: codebook with
   int8 and with bf16 pages, lut with int8 pages, each on the graph route
   against the eager route as in phase 5.  page_gather (one launch a
   layer) and matmul launches per forward, prefix-cache hits, the pool's
   refcounts after every serve, and the paged bf16 prefill logits are
   held against the contiguous engine's;
   [spec], on phase 5's model: speculative decoding on
   the contiguous cache.  The reduced 2-layer qwen3 (f32)
   with n-gram, lut and dense drafts: tokens and the four acceptance
   counters on the card equal the CPU's, and equal the baseline serve's
   tokens.  Then phase 5's model, k = 4 (a
   verify forward at M = 20), 4 slots: codebook target with the n-gram
   draft (8 requests, 4 with repetitive prompts, 16 new tokens), with a
   lut draft (4 requests, 8 new tokens), and lut target with the n-gram
   draft (4, 8), each served in turns (eager, graph, graph, eager) with
   tokens and counters equal, launches counted per target and per draft
   forward whose wrappers ran, one round replayed against eager (verify
   logits bit-equal, wall ms of a round on each route), acceptance rate,
   tokens a round, round ms against the decode step's, and tok/s against
   a baseline engine's; spec tokens compared with the baseline's: where
   they part, the verify row chose the spec token, and the baseline's
   gap to it is within twice the largest difference of verify and decode
   rows at agreeing positions, and the baseline row's top-2 gap at most
   1 % of its logit range; memory reserved printed after each engine,
   every engine freed before the next; no profiler reading gates the
   phase (the [kvq] engine's spec serve is in [kvq]);
   [paged-spec], on phase 5's model: speculative decoding on the paged
   cache (``ServeEngine(paged=True, spec=...)``).  The reduced 2-layer
   qwen3 (f32, k = 3, page 4) with the n-gram and a lut draft on f32 and
   int8 pages: tokens and counters on the card equal the CPU's, no page
   left reserved, and (f32 pages) tokens equal the paged baseline's.
   Then phase 5's model, k = 4, 4 slots, page 16, the paged phase's chat
   requests: codebook with int8 pages and the n-gram draft (4 × 16),
   codebook with bf16 pages and a lut draft (4 × 8), lut with int8
   pages and the n-gram draft (4 × 8), each in turns as in [spec] (the
   pool clean and nothing reserved after every serve; page_gather one
   launch a layer of every verify and prefill chunk), its round replayed
   against eager bit for bit, the round beside [spec]'s contiguous round
   and phase 6's paged decode step, and its tokens held by the parting
   check against the paged baseline's and (bf16 pages; reported on int8
   pages) the contiguous spec engine's; every engine freed;
   [sched], on phase 5's model (codebook) at the contended engine shape
   (``CONTENDED_ENGINE_KW``: max_len 48, 2 slots, page 8, 9 pages):
   ``Server.replay(contended_trace(1, vocab))`` twice on fresh engines
   with equal events, streams and reports, at least one preemption and
   pages swapped out and in, launches per forward plus one page_gather a
   swap-out, the pool clean, every stream equal to the uncontended
   ``serve``'s of the same requests; then once with int8 pages; wall
   seconds and device→host reads a round;
   [fleet], the telemetry registry, the router and the multi-replica
   fleet (``Fleet``): the reduced 2-layer qwen3 on 2 replicas with one
   ``Telemetry`` replaying the contended trace on the card and on the CPU
   (event digest, streams, report, snapshot, event log and Perfetto JSON
   equal, the kernels section aside); then on phase 5's model (codebook,
   bf16 pages) at the contended shape: drain migration on 2 replicas in
   both replica orders and once with a ``Telemetry`` (equal digests,
   streams equal to one ``Server.replay``'s, requests and pages migrated,
   equal device→host reads a ``serve_step``, the registry's counters
   against the report), and the shared prefix tier against no tier
   (equal tokens, tier hits, fewer pages materialized, the tier's capture
   timed); launches per forward plus one page_gather a swap-out, every
   pool clean;
   [probes], the numerics probes (``ServeEngine(probes=True)``): a reduced
   2-layer qwen3 (f32, k-means |W| 256, int8 ids) through the 6 golden
   scenarios of ``serving/probes.py`` on the card (graph route) and on the
   CPU: tokens equal with probes on and off and on both, the structural
   counters equal, the card within the sentinel slack of the CPU, lut
   headroom > 0 bits; then at ``act_levels`` 32 (codebook, lut): relu6
   saturation counted, the codebook FFN on the unfused launches while
   probes are on.  Then phase 5's model, lut on int8 pages and codebook on
   the contiguous cache, an engine with and one without probes: equal
   tokens, launches a forward and synchronizing operations a decode step;
   ``numerics()`` byte-equal after a graph serve, an eager serve and a
   graph serve after ``reset_probes()`` (buffers unmoved); lut headroom
   > 0 bits in all 28 layers, no page or weight id out of range, an int8
   KV error in every layer; the replayed decode step with and without
   probes, in turns;
   [launch], the serving launcher (``repro_torch.launch.serve.main`` in
   this process, its stdout parsed), once phase 5's model is freed:
   qwen3-1.7b at full width, ``--compress --backend codebook``, 8 requests
   (the ``[memory]`` row against a reckoning from the served tree, packed
   under a third of fp32; the ``sample:`` row equal to phase 5's codebook
   engine on the same requests; 7 × 28 codebook_matmul a forward; wall
   tok/s, ms/request, peak memory); the same model as a server on int8
   pages draining a 16-request Poisson trace (every request finished, the
   pool clean, launches a forward plus one page_gather a swap-out, wall
   drain seconds and tok/s); the reduced qwen3 through four argv on the
   card and with ``--device cpu``, equal lines with the wall figures
   masked (the numerics and metrics files held too); and
   ``python -m repro_torch.launch.serve`` as a process of its own;
7. working point: the same qwen3-1.7b weights at ``quantized(levels=32,
   n_weights=1000, method="kmeans")``: ``cluster_params`` on the card
   (exactly 2 × 25 kmeans_assign launches, the sums-only form), k-means
   MSE beside laplacian_l1's, kmeans_assign at the full n against its
   plain version (and run twice, bit-identical; both forms), its three
   forms timed (search alone, sums only, full), then served through
   codebook and lut (contiguous) and codebook with int8 pages, each on
   the graph route against the eager route: codebook launches 5 × 28
   codebook_matmul, 28 codebook_swiglu and no act_quant a forward, lut
   7 × 28 lut_matmul and 28 act_quant (with its multiplier); then a paged
   spec serve (codebook, int8 pages, n-gram draft, 4 × 8) in turns, with
   the gated launch in every verify; act_quant and
   the gated launch held against their plain versions on one layer's real
   FFN input; decode step and serve figures beside phase 5's, and the
   codebook step with the gated launch against the unfused chain it
   replaced, in turns (eager forwards);
   [kvq]: codeqwen1.5-7b at full width, 4 of its 32 layers, compressed as
   ``launch/serve.py --compress`` does, served through the codebook
   backend with its int8 contiguous cache on both routes as in phase 5:
   launches, cache bytes against a bf16 cache's, decode step with each,
   and the gap between their decode logits; and the [spec] phase's
   n-gram draft on this model's int8 cache, as above;
   [moe], the mixture-of-experts family (``models/moe.py``): the reduced
   qwen3-moe-30b-a3b and grok-1-314b (token chunks 2, int8 contiguous
   cache) through dense, codebook and lut, contiguous and paged (bf16 and
   int8 pages), card tokens equal to the CPU's, or, lut only, parted at a
   tie of its activation snap that a trace of every discrete decision
   finds first (``first_parting``); qwen3-moe-30b-a3b at full width, 2
   layers, bf16, act_levels 32: dense on the contiguous cache and on int8
   pages, then compressed with ``exclude="router"`` (the router in index
   form raises ``KeyError`` in the prefill, as the reference's does)
   through codebook and lut; grok-1-314b at full width, 1 layer, its int8
   cache and 8 token chunks (128-token prefills); each engine served
   eager, graph, graph with equal tokens, launches a forward held
   exactly, a replayed decode step's logits bit-equal to eager's, step
   ms and tok/s of both routes;
   [recurrent], RWKV-6 (``models/rwkv.py``) and the Mamba2/Zamba2 hybrid
   (``models/ssm.py`` and the shared block) through the model handle,
   which ServeEngine does not serve: the reduced rwkv6-7b and zamba2-2.7b
   (|W| 256, act_levels 0 and 32) through dense, codebook and lut, card
   tokens equal to the CPU's (lut parted only at a snap tie); rwkv6-7b at
   full width, 4 of 32 layers, bf16, act_levels 32, |W| 1000: 4 prompts
   of 128 tokens by prefill and 16 greedy decodes a backend, launches of
   a prefill, a decode step and a forward held exactly to the code's
   count, forward's last logits against prefill's, memory_report's packed
   bytes under a third of fp32; zamba2-2.7b at full width, 12 of 54
   layers, the same way: forward over 4 × 64 tokens and 16 decode steps
   from init_cache a backend, launches exact, and in f32 at act_levels 0
   the prompts fed through decode within the reference's 2e-2 of
   forward's logits; codebook within 1 % of dense in f32 at act_levels 0;
   prefill/forward ms, decode step wall and device ms,
   idle share, tok/s and peak memory;
   [families], the encoder-decoder (whisper-small: a non-causal encoder
   over frame embeddings, decoder blocks with cross-attention) and the
   M-RoPE vision-language family (qwen2-vl-7b: embeddings in, (3, B, L)
   positions) through the model handle, which ServeEngine does not serve:
   the reduced whisper-small and qwen2-vl-7b (|W| 256, act_levels 32)
   through dense, codebook and lut, card tokens equal to the CPU's and
   logits within 1e-3 (lut parted only at a snap tie); whisper-small at
   full width and depth (12 + 12 layers, enc_len 1500), bf16, act_levels
   32, |W| 1000 with ``exclude="enc_pos"`` (the compressed position table
   raises ``KeyError``, as the reference's does), 4 rows of 1500 seeded
   frames and a 32-token prompt, and qwen2-vl-7b at full width, 4 of 28
   layers, 4 × 128 seeded embeddings with M-RoPE positions (8 text, an
   8 × 12 grid, 24 text): on each backend the encoder's ms, prefill and
   forward (last logits within 1e-3), 16 greedy decodes, launches of a
   prefill, a forward and a decode step held exactly to the layer
   structure, the decode step's wall and device ms, idle share, kernels
   and tok/s, peak memory, memory_report's packed share; then each kernel
   at each new shape of these paths (the encoder's 6000 rows, the
   vocabulary-wide head, the vlm's gated FFN) held against its plain
   version on the path's own inputs and timed beside its bound;
   [paper], the paper's §4 integer engine (``core/lut.py``,
   ``core/fixedpoint.py``) and its own nets (``models/papernets.py``, inputs
   from ``data/synthetic.py``): lut_matmul on the §4 table (33 × 1001
   int32, rows off 16-byte boundaries) at every (M, K, N) the phase
   launches, planned and each route forced, bit-exact; then, counted, the
   784 → 128 → 128 → 10 tanh MLP with a k-means |W| = 1000 codebook and
   the tanh |A| = 32 tables through ``int_mlp_forward`` (card = CPU bit
   for bit; argmax agreement and decode gap against the float quantized
   net logged) and through the codebook and dense backends (each codebook
   layer within its parity limit of dense), and paper-alexnet at img 224,
   batch 32 (about 5.7·10⁷ params): the float forward card against CPU
   within 1e-4 of the range, at act_levels 32 the same with every
   activation site locked to the CPU's (levels that differ one apart at a
   boundary tie, counted), act_levels 32 against float logged, the
   integer head f6–f8 on a k-means |W| = 1000 codebook and relu6 tables
   bit-exact against lut_matmul's plain version; launches of the driven
   path held exactly (200 kmeans_assign, 6 lut_matmul, 16 act_quant, 3
   codebook_matmul), each of its act_quant launches held against the
   plain version on its own input, and kmeans_assign against the plain
   version on both k-means' values; the forward's ms and peak at both
   act_levels, and each layer's lut_matmul ms on both routes beside its
   bound;
8. kernel timings: the matmuls at M = 1, 4 (decode), 32 (prefill) and 256
   (four 64-token prefills) × the 7 sites of a layer, with the route each
   took (lut: and the other route forced), the bound, the plain version's
   and (codebook) torch.matmul's times, and a K-split sweep at the decode
   shape; page_gather at the decode and prefill-chunk page tables, and
   one paged layer's four pools in one launch against
   four single-pool launches and four library calls,
   act_quant at the decode (4 × 6144) and prefill (32 × 6144) FFN shapes,
   with the bound, the plain version's and the library call's times;
   codebook_swiglu at M 1, 4, 32, 256 against its two products alone, the
   unfused chain and the library yardstick (kmeans_assign's are taken in
   phase 7, at the full n).

[train] (before phase 8): the dense trainer (``launch/train.py``) at
``--quant`` card against CPU, resumed after a failure, at full width,
codebook_matmul's gradient, and the paper nets' training loops.
[train_families] (after [train]): training of the moe, ssm_rwkv, hybrid,
audio and vlm families.  (a) Each reduced model (qwen3-moe-30b-a3b,
grok-1-314b with 2 token chunks, rwkv6-7b, zamba2-2.7b, whisper-small,
qwen2-vl-7b) at ``--quant`` (|A| 32, |W| 1000, the event at step 3), 6
steps on the CPU and on the card from one initial set of params, every
FFN site and rwkv's bf16 WKV streams locked to the CPU run's (flips and
ties counted): losses within 1e-4, every MoE dispatch's decisions equal.
(b) qwen3-moe-30b-a3b (2 of 48 layers, 4 × 128 tokens in 4
microbatches), rwkv6-7b (4 of 32, 2 × 128, a k-means event, so
kmeans_assign runs), zamba2-2.7b (6 of 54, one group, 4 × 128 in 4
microbatches), whisper-small (12 + 12, 2 × 1500 frames, 64 tokens) and
qwen2-vl-7b (4 of 28, 2 × 128 embeddings with M-RoPE positions, then one
step at 2 microbatches) at full width, bf16, act_levels 32, remat on, 4
steps with the |W| 1000 event at step 2 (``launch.train.train`` for the
token families, ``make_train_step`` for whisper and the vlm): losses and
params finite, params moved, every weight on a center after the event,
act_quant and kmeans_assign launches held exactly to the layer
structure, the first act_quant launches and the k-means values against
the plain versions; step ms, its gradient and update apart with busy ms
and idle share, peak memory.  grok-1-314b at full width is left out, the
reason logged (its experts' training state outgrows the card).  Every
training run of [train] and [train_families] takes the donated step
(``make_train_step(..., donate=True)``, as ``launch.train.train``): the
params and moments are written in place, so a tree that is used again
after a run is handed to it as a copy.
[examples] (after [train_families]): with the launch counts set to 0,
the port's four examples (``examples/*_torch.py``) through their
``main`` in this process at the reference's defaults, stdout captured
and logged: the serving example (its spec line says identical tokens,
every probe figure finite, the paged pool clean, codebook_matmul on the
codebook run, lut_matmul on the lut run, neither on dense, page_gather
on the paged run, both in the spec serve), the quickstart (its last loss
below the first, 12 tokens served), the MNIST table (continuous above
0.85, |A| 32 + |W| 1000 within 0.05 of it), and the 93.6M-param model
(the count from ``abstract_params`` equal to the trained tree's, losses
finite, a checkpoint at step 200; the same argv with ``--steps 210`` on
the same directory resumes from step 200); wall seconds, step ms, peak
memory and launches of each.
[tp] (after [examples]): tensor-parallel serving (``ServeEngine(mesh=)``)
of qwen3-1.7b at full width, 2 layers, |W| 256 (int8 ids), compressed
once and handed to two ranks by file; the ranks share cuda:0 over gloo
(``launch/mesh.run_ranks``).  Through dense, codebook and lut on the
contiguous cache, plain and n-gram spec, codebook and lut at act_levels
32, codebook with the int8 cache, and lut in f32: each rank's tokens
equal the other's; against the mesh-less engine on the same card, lut in
f32 equal; every bf16 run equal to the mesh-less engine computing as the
two ranks do in one process (the witness that a parting from tp=1 is the
sums' order and rounding alone), and dense and codebook at act_levels 0
with their decision logits within a bound fixed from tp=1's logit scale
before any parting and every parting at a top-2 gap within twice it; the w2
row product's int32 accumulator summed over the ranks bit-equal to one
device's; each rank's kernels at its sharded shapes against their plain
versions; launches a forward held exactly on each rank and printed; the
eager decode step of tp=2 and tp=1, the collectives' share, and each
kernel at one rank's shapes against its bound.

The last two lines are the kernels JSON and ``{"ok": true, "device": ...}``.
Exits non-zero without printing a result when no CUDA device is present.
"""

from __future__ import annotations

import collections
import contextlib
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
# Each kernel of the port and the TPU kernel it replaces.  codebook_swiglu,
# the gated launch, is act_quant redesigned as the epilogue of the FFN's two
# codebook products, in codebook_matmul's source.
TPU_KERNELS = {
    "codebook_matmul": "src/repro/kernels/codebook_matmul.py:55",
    "lut_matmul": "src/repro/kernels/lut_matmul.py:58",
    "page_gather": "src/repro/kernels/page_gather.py:37",
    "act_quant": "src/repro/kernels/act_quant.py:35",
    "codebook_swiglu": "src/repro/kernels/act_quant.py:35",
    "kmeans_assign": "src/repro/kernels/kmeans1d.py:27",
}
SOURCES = {"codebook_swiglu": "src/repro_torch/csrc/codebook_matmul.cu"}
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
REC_BATCH = 4                    # prompts a full-width run
REC_NEW = 16                     # decode steps a backend at full width
REC_PLEN = {"rwkv6-7b": 128, "zamba2-2.7b": 64}   # one chunk each
# The (K, N) sites the recurrent families give the matmul kernels (rwkv's
# five time-mix projections, its LoRA down and up, its channel mix;
# Mamba2's in_proj, whose N is no multiple of 16, and its out_proj, the
# shape of the shared in_proj; the shared block's wq/wk/wv/wo, w1/w3 and
# w2) and the row counts each family gives them: decode, and rwkv's
# 4 × 128 prefill or zamba2's 4 × 64 forward
REC_ROWS = {"rwkv6-7b": (REC_BATCH, REC_BATCH * 128),
            "zamba2-2.7b": (REC_BATCH, REC_BATCH * 64)}
REC_SITES = {"rwkv6-7b": ((4096, 4096), (4096, 32), (32, 4096),
                          (4096, 14336), (14336, 4096)),
             "zamba2-2.7b": ((2560, 10448), (5120, 2560), (2560, 2560),
                             (2560, 10240), (10240, 2560))}
# the gated launch's site in the shared block (w1/w3), at zamba2's rows
REC_SWIGLU = (2560, 10240)
# the widths of their act_quant launches: rwkv's gate (with its multiplier)
# and squared relu, Mamba2's conv output and z gate (with its multiplier)
REC_ACT = {"rwkv6-7b": (4096, 14336), "zamba2-2.7b": (5248, 5120)}
BACKENDS = ("dense", "codebook", "lut")


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
    prefill chunk of ``PAGE`` rows, a single row, and a speculative verify
    over ``max_batch`` slots (k + 1 = SPEC_K + 1 rows each)."""
    from repro_torch.serving.engine import _bucket
    rows = {1, max_batch, 32, PAGE, max_batch * (SPEC_K + 1),
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
    every (K, N) site of the model, at the recurrent families' sites
    (``REC_SITES``: rwkv's time mix, its LoRA, a 32-wide N and a 32-deep
    K, its channel mix, Mamba2's in_proj, whose N is no multiple of 16,
    and out_proj, the shared block's projections) at each family's rows
    (``REC_ROWS``), int8, int16 and int32 ids, f32 and bf16 x, and every
    route (``codebook_plans``): lut bit-exact, codebook within
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
    cases += [(M, K, N) for f, sites in REC_SITES.items()
              for M in REC_ROWS[f] for K, N in sites]
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
        f"the recurrent families' sites at their rows "
        + "; ".join(f"{f} M in {REC_ROWS[f]} × {list(REC_SITES[f])}"
                    for f in REC_SITES) + ", "
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
    paths × 6144, at the recurrent families' widths (``REC_ACT``: rwkv's
    gate, with its multiplier as every size is, and squared relu, Mamba2's
    conv output and z gate) at their decode and prefill row counts, and at
    odd sizes (1 element; n no multiple of a block).
    Outputs and indices bit-equal but for ties (``parity_ties``); relu6
    bit-equal everywhere.  Returns (max abs err, ties)."""
    import torch
    from repro_torch.kernels import act_quant as aq
    g = torch.Generator(device=dev).manual_seed(4)
    sizes = [(m, D_FF) for m in rows] + [(1,), (1000003,), (3, 257)]
    sizes += [(m, n) for f, widths in REC_ACT.items() for m in REC_ROWS[f]
              for n in widths]
    worst, ties, n = 0.0, 0, 0
    for shape in sizes:
        base = torch.randn(shape, generator=g, device=dev) * 3
        ubase = torch.randn(shape, generator=g, device=dev)
        for xdt in (torch.float32, torch.bfloat16):
            x, u = base.to(xdt), ubase.to(xdt)
            for kind in ACT_KINDS:
                for levels in (2, ACT_LEVELS, 256):
                    for form in aq.FORMS:
                        # without and with the multiplier the dense and
                        # lut FFNs give it; the last ``got`` (with it) is
                        # held to the kernel's own output times it below
                        for mul in (None, u):
                            got = aq.act_quant_cuda(x, kind, levels,
                                                    form=form, mul=mul)
                            want = aq.act_quant_plain(x, kind, levels,
                                                      form=form, mul=mul)
                            torch.cuda.synchronize()
                            ties += aq.parity_ties(*got, *want, kind, levels,
                                                   mul=mul)
                            worst = max(worst, (got[0].float()
                                                - want[0].float()
                                                ).abs().max().item())
                            n += 1
                        alone = aq.act_quant_cuda(x, kind, levels, form=form,
                                                  with_index=False)[0]
                        if not torch.equal(got[0], alone * u):
                            raise AssertionError(
                                f"act_quant {kind} {form} {xdt} {shape}: "
                                "with mul differs from the output times mul")
    log(f"[parity] act_quant in {n} cases (forms kernel/act_apply × "
        f"{len(ACT_KINDS)} kinds × |A| 2/{ACT_LEVELS}/256 × f32/bf16 × "
        f"shapes {sizes}, without and with a multiplier): bit-equal but for "
        f"{ties} level-boundary ties (each one level apart); relu6 "
        f"bit-equal; with mul equal to the kernel's output times mul; max "
        f"abs err {worst:.3e}")
    return worst, ties


def swiglu_parity(dev, rows) -> tuple[float, dict]:
    """The gated launch (codebook_swiglu) at every FFN row count of the
    serving paths × the w1/w3 site, at the hybrid's shared w1/w3 site
    (``REC_SWIGLU``) at zamba2's rows, and an odd N (K 100, N 131: the FMA
    tile), int8/int16/int32 ids, f32/bf16 x, 4 kinds × |A| 2, 32, 256, on
    the planned route and (bf16) the FMA tile: bit-equal to the unfused
    chain of CUDA launches with the same plan (two codebook_matmul, their
    casts, act_quant with its multiplier), and to the plain epilogue of
    those accumulators (``swiglu_epilogue_plain``; relu6, the kind the
    paths serve: the chain's act_quant is held to the plain version with
    ties counted above); each launch run twice, bit-identical.  Against
    the fully plain chain (``codebook_swiglu_plain``, whose f32 sums add
    in another order) the bf16 relu6 outputs that differ are counted.
    Returns (max abs err against the plain epilogue, counts)."""
    import torch
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import _common
    g = torch.Generator(device=dev).manual_seed(8)
    K, N = SITES["w1"]
    cases = [(m, K, N) for m in rows] + [(3, 100, 131), (40, 100, 131)]
    cases += [(m, *REC_SWIGLU) for m in REC_ROWS["zamba2-2.7b"]]
    n, flips, total, worst = 0, 0, 0, 0.0
    for M, K_, N_ in cases:
        for idt, W in ((torch.int8, 256), (torch.int16, N_BOOK),
                       (torch.int32, 5000)):
            lo_id = -128 if idt == torch.int8 else 0
            hi_id = 128 if idt == torch.int8 else W
            w1, w3 = (torch.randint(lo_id, hi_id, (K_, N_), generator=g,
                                    device=dev).to(idt) for _ in range(2))
            b1, b3 = (torch.randn(W, generator=g, device=dev) * 0.05
                      for _ in range(2))
            xf = torch.randn(M, K_, generator=g, device=dev) * 2
            for xdt in (torch.float32, torch.bfloat16):
                x = xf.to(xdt)
                plans = [None]
                if xdt == torch.bfloat16:
                    plans.append(_common.codebook_plan(
                        M, K_, N_, bf16=True, vec_ok=False,
                        sms=_common.sm_count(dev)))
                for plan in plans:
                    gs = cm.codebook_matmul_cuda(x, w1, b1, plan=plan)
                    us = cm.codebook_matmul_cuda(x, w3, b3, plan=plan)
                    for kind in ACT_KINDS:
                        for levels in (2, ACT_LEVELS, 256):
                            got = cm.codebook_swiglu_cuda(
                                x, w1, b1, w3, b3, kind, levels, plan=plan)
                            again = cm.codebook_swiglu_cuda(
                                x, w1, b1, w3, b3, kind, levels, plan=plan)
                            chain = aq.act_quant_cuda(
                                gs.to(xdt), kind, levels, form="act_apply",
                                with_index=False, mul=us.to(xdt))[0]
                            torch.cuda.synchronize()
                            route = "planned" if plan is None else plan.route
                            tag = (f"codebook_swiglu M={M} K={K_} N={N_} "
                                   f"{idt} {xdt} {kind} |A|={levels} "
                                   f"plan={route}")
                            if not (torch.equal(got, chain)
                                    and torch.equal(got, again)):
                                raise AssertionError(
                                    f"{tag}: differs from the unfused chain "
                                    "or between two runs")
                            if kind == "relu6":
                                want = cm.swiglu_epilogue_plain(
                                    gs, us, xdt, kind, levels)
                                if not torch.equal(got, want):
                                    raise AssertionError(
                                        f"{tag}: differs from the plain "
                                        "epilogue of its accumulators")
                                worst = max(worst, (got.float() - want.float()
                                                    ).abs().max().item())
                            if (kind == "relu6" and xdt == torch.bfloat16
                                    and plan is None):
                                plain = cm.codebook_swiglu_plain(
                                    x, w1, b1, w3, b3, kind, levels)
                                flips += int((got != plain).sum())
                                total += got.numel()
                            n += 1
    counts = {"launches": 2 * n, "flips_vs_plain": flips,
              "elements_vs_plain": total}
    log(f"[parity] codebook_swiglu in {n} cases (M in {rows} at the w1/w3 "
        f"site {K}×{N}, M in {REC_ROWS['zamba2-2.7b']} at the shared "
        f"block's {REC_SWIGLU[0]}×{REC_SWIGLU[1]}, and M=3, 40 at K=100 "
        f"N=131; int8/int16/int32 ids × "
        f"f32/bf16 x × {len(ACT_KINDS)} kinds × |A| 2/{ACT_LEVELS}/256; "
        f"planned route and, bf16, the FMA tile): bit-equal to the unfused "
        f"chain of CUDA launches and, relu6, to the plain epilogue of its "
        f"accumulators; each run twice, bit-identical; against the fully "
        f"plain chain (f32 sums in torch.matmul's order) {flips}/{total} "
        f"bf16 relu6 outputs differ ({flips / max(total, 1):.2e}: G or U "
        f"rounding to another bf16 value or level)")
    return worst, counts


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


def reduced_kv_quant(dev):
    """codeqwen1.5-7b reduced (2 layers, d 128, f32, untied head) with its
    ``kv_quant`` int8 contiguous cache, compressed on the CPU (laplacian_l1,
    |W| = 256), through every backend on the card and on the CPU: ``serve``
    (5 requests over 2 slots: planes spliced into reused slots) and
    ``generate`` (planes grown), greedy tokens equal; codebook launches
    7 × 2 + 1 (the head) a forward; the cache's bytes the int8 planes' and
    their bf16 scales'."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import (WeightQuantConfig,
                                            cluster_params, init_state)
    from repro_torch.kernels import ops
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine, to_codebook_params
    cfg = configs.get("codeqwen1.5-7b").reduced()
    if not cfg.kv_quant:
        raise AssertionError("codeqwen1.5-7b has lost kv_quant")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    wq = WeightQuantConfig(num_weights=256)
    pq, st = cluster_params(params, wq, init_state(wq), wq.interval)
    cp = to_codebook_params(pq, wq, st, min_size=1024)
    cp_dev = _to(cp, dev)
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 11, [300, 2, 5, 7, 1, 8],
               [1, 2, 3, 4, 5, 6, 7]]
    kw = dict(max_len=64, max_batch=2)
    for be in ("dense", "codebook", "lut"):
        on_cpu = ServeEngine(model, cp, backend=be, device="cpu", **kw)
        on_dev = ServeEngine(model, cp_dev, backend=be, device=dev, **kw)
        want = (on_cpu.serve(prompts, max_new=8),
                on_cpu.generate(prompts[:3], max_new=8))
        ops.reset_launch_counts()
        got = (on_dev.serve(prompts, max_new=8),
               on_dev.generate(prompts[:3], max_new=8))
        if got != want:
            raise AssertionError(f"codeqwen reduced, kv_quant, {be}: card "
                                 f"tokens {got} != CPU tokens {want}")
        counts = ops.launch_counts()
        if be == "codebook" and counts["codebook_matmul"] != (
                7 * cfg.n_layers + 1) * called_forwards(on_dev):
            raise AssertionError(f"codeqwen reduced codebook: {counts} over "
                                 f"{called_forwards(on_dev)} forwards")
    cache = model.init_cache(4, 64, device=dev)["kv"]
    n_bytes = ServeEngine(model, cp_dev, max_len=64, max_batch=4,
                          device=dev).dense_cache_bytes()
    if {k: v.dtype for k, v in cache.items()} != {
            "k": torch.int8, "v": torch.int8, "k_scale": torch.bfloat16,
            "v_scale": torch.bfloat16} or n_bytes != 139264:
        raise AssertionError(f"codeqwen reduced cache: {cache.keys()}, "
                             f"{n_bytes} B")
    log("[reduced] codeqwen1.5-7b reduced, int8 contiguous cache "
        "(kv_quant): dense/codebook/lut tokens on the card equal the CPU "
        "path's (serve over reused slots, generate); int8 k/v with bf16 "
        f"scales, {n_bytes} B at max_batch 4, max_len 64")


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
    n_fwd = {"act_quant": 0, "codebook_swiglu": 0}
    for be, kw in (("dense", {}), ("codebook", {}), ("lut", {}),
                   ("codebook", dict(paged=True, page_size=4,
                                     kv_dtype="int8")),
                   ("lut", dict(paged=True, page_size=4, kv_dtype="int8"))):
        kw = dict(max_len=64, max_batch=2, backend=be, **kw)
        on_cpu = ServeEngine(model, cp, device="cpu", **kw).serve(
            prompts, max_new=8)
        e = ServeEngine(model, cp_dev, device=dev, **kw)
        on_dev = e.serve(prompts, max_new=8)
        # codebook: the gated launch a layer; dense, lut: act_quant
        n_fwd["codebook_swiglu" if be == "codebook" else "act_quant"] += \
            called_forwards(e)
        if on_cpu != on_dev:
            raise AssertionError(f"reduced working point, {be} {kw}: card "
                                 f"tokens {on_dev} != CPU tokens {on_cpu}")
    counts = ops.launch_counts()
    if any(counts[k] != cfg.n_layers * f for k, f in n_fwd.items()):
        raise AssertionError(f"reduced working point: {counts} launches "
                             f"over {n_fwd} forwards")
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
        f"{counts['act_quant']} act_quant and {counts['codebook_swiglu']} "
        f"codebook_swiglu launches (= {cfg.n_layers} × "
        f"{n_fwd['act_quant']} and {n_fwd['codebook_swiglu']} forwards); "
        f"k-means on the card ({2 * wq.kmeans_iters} "
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


def _clone(tree):
    """A copy of every leaf: what a donated training run may write."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _to_f32(tree):
    """Float leaves in f32, index leaves as they are (shared, not copied)."""
    import torch
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.to(torch.float32) if tree.is_floating_point() else tree


# The pattern each kernel's name holds in a profile
KERNEL_NAMES = {"page_gather": "page_gather", "act_quant": "act_quant",
                "codebook_swiglu": "StoreSwiglu",
                "codebook_matmul": "StoreSum", "lut_matmul": "lut_"}


# Copies and fills, not kernels: a CUDA graph runs some device-to-device
# copies as memcpy kernels of its own ("memcpy32_post")
COPIES = ("Memcpy", "Memset", "memcpy", "memset")


# A profiler session here drops a prefix of its device records, the longer
# the process has run the more (tools/profiler_after_spec.py on an H100:
# 8 of a probe's 16 events after 100 s asleep, none lost where the session
# first launched 512 throwaway kernels; not tied to spec rounds, CUDA
# graphs or CUPTI's teardown).  So each session first launches WARM_LAUNCHES
# one-cycle sleep kernels, which the readings leave out by name.
WARM_LAUNCHES = 1024
WARM_KERNEL = "spin_kernel"


def warm_session() -> None:
    import torch
    for _ in range(WARM_LAUNCHES):
        torch.cuda._sleep(1)


def device_time(fn, top: int = 5, match: str = "page_gather", count=()):
    """Device time of one call from torch.profiler's CUDA activity:
    (busy ms summed over kernels and copies, [(name, ms, count)] of the
    largest, ms of the kernels whose name holds ``match``, kernels launched
    (copies and memsets not counted), {pattern: kernels whose name holds
    it} for each pattern of ``count``).  Busy time over wall time gives the
    device's idle share.  Kernels a CUDA graph replays are seen one by
    one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm_session()
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    # device-side events only: a CPU op (aten::index) also carries the
    # device time of the kernel it launched, which would count it twice
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total
           and WARM_KERNEL not in e.key]
    evs.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in evs) / 1e3
    matched = sum(e.self_device_time_total for e in evs
                  if match in e.key) / 1e3
    n_kernels = sum(e.count for e in evs if not e.key.startswith(COPIES))
    found = {p: sum(e.count for e in evs if p in e.key) for p in count}
    return busy, [(e.key[:48], e.self_device_time_total / 1e3, e.count)
                  for e in evs[:top]], matched, n_kernels, found


def kernel_ms(fn, match: str, reps: int = 3) -> float:
    """Device ms of one call of ``fn``, which launches each kernel whose
    name holds ``match`` once: the sum of those kernels' mean durations
    over ``reps`` profiled calls.  For a wrapper that syncs with the host
    (the k-means forms read their overflow flag), which ``time_ms`` cannot
    queue behind a device-side sleep.

    Runs on an H100 got sessions here that held no kmeans kernel at all
    (the dropped prefix ``warm_session`` absorbs).  So the session records
    host activity as ``device_time``'s does, first launches the warm-up
    kernels, leaves idle margins of 50 ms before and after the calls, and
    is made again, up to three times in all, when it holds no kernel of
    ``match``; each empty session is logged."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm_session()
            time.sleep(0.05)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and match in e.key
               and e.count]
        if evs:
            return sum(e.self_device_time_total / e.count
                       for e in evs) / 1e3
        log(f"[time] kernel_ms: no {match} kernel in profiler session "
            f"{attempt} of 3")
    raise AssertionError(f"no {match} kernel in three profiler sessions")


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def compressed_model(dev, cfg, tag: str):
    """``cfg`` at full width, random weights from a seeded generator,
    compressed to |W| = N_BOOK as ``launch/serve.py --compress`` does
    (laplacian_l1, global, int16 ids): (model, index-form params)."""
    import torch
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import to_codebook_params

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
    L_, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    w1 = cp["blocks"]["mlp"]["w1"]
    assert w1["w_idx"].dtype == torch.int16, w1["w_idx"].dtype
    assert tuple(w1["w_idx"].shape) == (L_, d, ff)
    assert tuple(w1["codebook"].shape) == (L_, N_BOOK)
    assert tuple(cp["embed"]["w_idx"].shape) == (cfg.padded_vocab, d)
    log(f"{tag} {cfg.name} {L_}L d={d} ff={ff} heads {cfg.n_heads}/"
        f"{cfg.n_kv} vocab={cfg.vocab} (padded {cfg.padded_vocab}) "
        f"{cfg.dtype}, {'tied' if cfg.tie_embeddings else 'untied'} head, "
        f"kv_quant {cfg.kv_quant}: init {t_init:.2f}s, cluster {t_cl:.2f}s, "
        f"to_codebook {t_cp:.2f}s; w_idx int16, codebook {N_BOOK} entries")
    return model, cp


# --- the decode step as a CUDA graph -------------------------------------------

def called_forwards(e) -> int:
    """Forwards of engine ``e`` whose kernel wrappers ran: prefills, eager
    decode steps, and each decode step captured into a CUDA graph, once.
    A replay calls no wrapper, so launches count per captured forward."""
    return e.n_forwards - e.n_replays + e.n_captures


def check_launches(tag: str, counts: dict, per_fwd: dict, fwd: int) -> None:
    """Each kernel of ``per_fwd`` launched that many times a forward over
    ``fwd`` forwards, every other kernel never."""
    want = {k: per_fwd.get(k, 0) * fwd for k in counts}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} over {fwd} "
                             f"forwards, want {want}")


def step_state(e, pos: int, n_pages: int = 0):
    """A loop state of its own for engine ``e`` (the engine's serving state
    is left alone): MAX_BATCH live slots at ``pos``, token 0 in each, on a
    zeroed contiguous cache, or on a fresh page pool of ``n_pages`` pages
    where slot b owns pages 1 + b·P .. (b + 1)·P."""
    import torch
    from repro_torch.serving.engine import _Slots
    if e.paged:
        dtype = torch.int8 if e.kv_dtype == "int8" else e._cache_dtype
        cache = {**e.model.init_paged_cache(n_pages, e.page_size, dtype,
                                            device=e.device),
                 "page_table": torch.arange(
                     1, n_pages, dtype=torch.int32,
                     device=e.device).reshape(MAX_BATCH, -1)}
    else:
        cache = e.model.init_cache(MAX_BATCH, e.max_len,
                                   dtype=e._cache_dtype, device=e.device)
    cache["pos"] = torch.full((MAX_BATCH,), pos, dtype=torch.int32,
                              device=e.device)
    st = _Slots(cache, e.max_len)
    st.active.fill_(True)
    st.stops.fill_(1 << 30)
    return st


def step_turns(tag: str, e, st, per_step: dict, match: str = "page_gather"
               ) -> dict:
    """One decode step of ``st`` on the eager route and as a graph replay,
    in turns (eager, graph, graph, eager), each turn from the same state:
    wall ms (median of 5 steps a turn), and once a route the device busy
    ms, its idle share (against the mean of the route's two turns) and
    kernels from the profiler.  Holds the
    replayed step's logits bit-equal to the eager step's, both routes'
    kernels equal (copies apart) and the kernels whose names hold each
    pattern of ``per_step`` to its count, the two busy times within 5 %,
    and the logits finite."""
    import torch
    saved = {k: t.clone() for k, t in st.state().items()}

    def restore():
        for k, t in st.state().items():
            t.copy_(saved[k])

    def one(graphs: bool):
        restore()
        e._graphs = graphs
        e._step(st)
        return st.logits.clone()
    c0 = e.n_captures
    one(True)                                    # the capture, untimed
    res = {"eager": {"wall_ms": []}, "graph": {"wall_ms": []},
           "captures": e.n_captures - c0}
    def profiled(route):
        restore()
        e._graphs = route == "graph"
        busy, top, m_ms, n_k, found = device_time(
            lambda: e._step(st), match=match, count=tuple(per_step))
        res[route].update(device_ms=busy, kernels=n_k, found=found,
                          match_ms=m_ms, top=top)

    for route in ("eager", "graph", "graph", "eager"):
        restore()
        e._graphs = route == "graph"
        walls = [timed(lambda: e._step(st))[1] for _ in range(6)][1:]
        res[route]["wall_ms"].append(1e3 * sorted(walls)[len(walls) // 2])
        if "device_ms" not in res[route]:
            profiled(route)
    g, ea = res["graph"], res["eager"]

    def agree() -> bool:
        return (g["found"] == ea["found"] == per_step
                and g["kernels"] == ea["kernels"]
                and abs(g["device_ms"] - ea["device_ms"])
                <= 0.05 * ea["device_ms"])
    # the profiler has been seen to lose a few of a step's kernel events
    # once in a run (with a warning from its event collection): profile
    # both routes again before holding them to each other
    res["profiles_retaken"] = 0
    while not agree() and res["profiles_retaken"] < 5:
        res["profiles_retaken"] += 1
        log(f"{tag}: profiles disagree (kernels {ea['kernels']} eager, "
            f"{g['kernels']} graph; by name {ea['found']}, {g['found']}); "
            "taking both again")
        profiled("eager")
        profiled("graph")
    for route in ("eager", "graph"):
        r = res[route]
        r["mean_wall_ms"] = sum(r["wall_ms"]) / len(r["wall_ms"])
        r["idle_share"] = 1 - r["device_ms"] / r["mean_wall_ms"]
        if r["found"] != per_step:
            raise AssertionError(f"{tag}: {route} step's kernels by name "
                                 f"{r['found']}, want {per_step}")
    if g["kernels"] != ea["kernels"]:
        raise AssertionError(f"{tag}: a replayed step ran {g['kernels']} "
                             f"kernels, the eager step {ea['kernels']}")
    if abs(g["device_ms"] - ea["device_ms"]) > 0.05 * ea["device_ms"]:
        raise AssertionError(f"{tag}: device busy {g['device_ms']:.3f} ms "
                             f"replayed against {ea['device_ms']:.3f} eager")
    lg_e, lg_g = one(False), one(True)
    if not bool(torch.isfinite(lg_e[..., :e.model.cfg.vocab]).all()):
        raise AssertionError(f"{tag}: non-finite decode logits")
    if not torch.equal(lg_g, lg_e):
        raise AssertionError(f"{tag}: the replayed step's logits differ from "
                             f"the eager step's by "
                             f"{(lg_g - lg_e).abs().max().item():.3e}")
    restore()
    res["captures"] = e.n_captures - c0
    res["logits_bit_equal"] = True
    return res


def graph_vs_eager(tag: str, e, reqs, gen_reqs, per_fwd: dict,
                   per_step: dict, step_pos: int, n_pages: int = 0,
                   match: str = "page_gather", after_serve=None) -> tuple:
    """Engine ``e`` (a fresh one) on the graph route against the eager
    route, in one run:

    * ``serve(reqs, max_new=16)`` in turns (eager, graph — its first,
      which captures —, graph, eager): tokens equal in all four, the second
      graph serve captures nothing, tok/s and peak device memory
      allocated of each, and the memory the graphs' pool keeps reserved
      (after ``empty_cache``, against the same after the first serve);
    * ``generate(gen_reqs, max_new=8)`` eager, then graph twice: tokens
      equal, the second captures nothing;
    * launches: ``per_fwd`` a forward whose wrappers ran
      (``called_forwards``), over the serves; over the generates the same
      but page_gather (generate decodes on the contiguous cache);
    * ``step_turns`` on a state at ``step_pos`` (``step_state``).

    ``after_serve(i)``, if given, runs after the i-th serve.  Returns the
    figures and the tokens."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    c0, f0, r0, k0 = (called_forwards(e), e.n_forwards, e.n_replays,
                      e.n_captures)
    out = {"eager": None, "graph": None}
    res = {"serve_s": {"eager": [], "graph": []}, "peak_gib": {}}
    for i, route in enumerate(("eager", "graph", "graph", "eager")):
        e._graphs = route == "graph"
        before = e.n_captures
        torch.cuda.reset_peak_memory_stats()
        toks, secs = timed(lambda: e.serve(reqs, max_new=16))
        res["serve_s"][route].append(secs)
        res["peak_gib"].setdefault(
            route, torch.cuda.max_memory_allocated() / 2 ** 30)
        if i == 0:            # what stays reserved once the loop state is
            torch.cuda.empty_cache()               # made, before a graph
            reserved = torch.cuda.memory_reserved()
        if i == 2 and e.n_captures != before:
            raise AssertionError(f"{tag}: the second graph serve captured "
                                 f"{e.n_captures - before} graphs")
        if after_serve is not None:
            after_serve(i)
        if out[route] is None:
            out[route] = toks
        if toks != out["eager"] or toks != out[route]:
            raise AssertionError(f"{tag}: {route} serve's tokens differ "
                                 "from the eager route's")
    for seq in out["eager"]:
        if not all(0 <= t < e.model.cfg.vocab for t in seq):
            raise AssertionError(f"{tag}: token id out of range")
    counts, fwd = ops.launch_counts(), called_forwards(e) - c0
    check_launches(tag, counts, per_fwd, fwd)
    # generate decodes on the contiguous cache, a paged engine's too
    ops.reset_launch_counts()
    g0 = called_forwards(e)
    e._graphs = False
    gen = e.generate(gen_reqs, max_new=8)
    e._graphs = True
    for i in range(2):
        before = e.n_captures
        if e.generate(gen_reqs, max_new=8) != gen:
            raise AssertionError(f"{tag}: graph generate's tokens differ "
                                 "from the eager route's")
        if i and e.n_captures != before:
            raise AssertionError(f"{tag}: a second graph generate captured")
    g_counts = ops.launch_counts()
    check_launches(f"{tag} generate", g_counts,
                   {k: v for k, v in per_fwd.items() if k != "page_gather"},
                   called_forwards(e) - g0)
    counts = {k: v + g_counts[k] for k, v in counts.items()}
    torch.cuda.empty_cache()          # the graphs' pool stays reserved
    res["graph_pool_gib"] = (torch.cuda.memory_reserved() - reserved) / 2 ** 30
    res.update(forwards=e.n_forwards - f0, replays=e.n_replays - r0,
               captures=e.n_captures - k0,
               wrapper_forwards=called_forwards(e) - c0,
               launches=counts,
               serve_tok_s={r: 16 * len(reqs) / min(v)
                            for r, v in res["serve_s"].items()},
               graph_serve_with_capture_s=res["serve_s"]["graph"][0])
    st = step_state(e, step_pos, n_pages)
    res["step"] = step_turns(tag, e, st, per_step, match=match)
    del st
    sp = res["step"]
    log(f"{tag}: graph against eager in turns — serve {16 * len(reqs)} tokens"
        f" (eager, graph, graph, eager) "
        + ", ".join(f"{s:.3f}" for s in (res["serve_s"]["eager"][0],
                                         *res["serve_s"]["graph"],
                                         res["serve_s"]["eager"][1]))
        + f" s → eager {res['serve_tok_s']['eager']:.1f}, graph "
        f"{res['serve_tok_s']['graph']:.1f} tok/s (the first graph serve "
        f"captures); tokens equal, generate too; {res['forwards']} forwards, "
        f"{res['replays']} replayed, {res['captures']} captures (the second "
        f"serve and generate none); over the serves wrappers ran for "
        f"{fwd} forwards: "
        + ", ".join(f"{counts[k] - g_counts[k]} {k} (= {v} × {fwd})"
                    for k, v in per_fwd.items())
        + f"; peak memory allocated eager {res['peak_gib']['eager']:.2f} "
        f"GiB, graph with its capture {res['peak_gib']['graph']:.2f} GiB; "
        f"the graphs' pool holds {res['graph_pool_gib']:.2f} GiB more "
        "reserved")
    log(f"{tag}: decode step ({MAX_BATCH} slots at {step_pos}) in turns "
        "(eager, graph, graph, eager): wall "
        + ", ".join(f"{w:.2f}" for w in (sp["eager"]["wall_ms"][0],
                                         *sp["graph"]["wall_ms"],
                                         sp["eager"]["wall_ms"][1]))
        + f" ms; device busy eager {sp['eager']['device_ms']:.3f} ms (idle "
        f"share {sp['eager']['idle_share']:.3f}), graph "
        f"{sp['graph']['device_ms']:.3f} ms (idle share "
        f"{sp['graph']['idle_share']:.3f}); {sp['graph']['kernels']} kernels "
        f"a step on both routes, by name {sp['graph']['found']}; replayed "
        "logits bit-equal to eager; top (graph): "
        + "; ".join(f"{k} {ms:.3f}ms×{n}" for k, ms, n in sp["graph"]["top"]))
    return res, out["eager"]


def step_stats(res: dict) -> dict:
    """The decode figures of ``graph_vs_eager``'s result that phases 5 and 7
    print and compare: the graph route's under the old names, the eager
    route's with ``_eager``."""
    st = res["step"]
    out = {}
    for route, sfx in (("graph", ""), ("eager", "_eager")):
        out.update({f"decode_step_ms{sfx}": st[route]["mean_wall_ms"],
                    f"decode_device_ms{sfx}": st[route]["device_ms"],
                    f"decode_idle_share{sfx}": st[route]["idle_share"],
                    f"serve_tok_s{sfx}": res["serve_tok_s"][route]})
    out.update(decode_kernels=st["graph"]["kernels"],
               decode_top_kernels=st["graph"]["top"])
    return out


def main_path(dev, cfg, model, cp, prompts) -> tuple[dict, dict]:
    """The contiguous path: serve/generate with dense, codebook and lut,
    each on the graph route against the eager route (``graph_vs_eager``),
    launch counts, logits against dense, the lut scratch-growth check,
    prefill timings."""
    import torch
    from repro_torch.kernels import _common
    from repro_torch.models import layers as L
    from repro_torch.serving import ServeEngine

    kw = dict(max_len=128, max_batch=MAX_BATCH, device=dev)
    eng = {be: ServeEngine(model, cp, backend=be, **kw)
           for be in ("dense", "codebook", "lut")}
    per_fwd = 7 * cfg.n_layers
    stats, tokens, launches = {}, {}, {}
    for be, n in (("codebook", 8), ("lut", 4), ("dense", 8)):
        name = f"{be}_matmul"
        want = {} if be == "dense" else {name: per_fwd}
        res, tokens[be] = graph_vs_eager(
            f"[main] {be}", eng[be], prompts[:n], prompts[:4], want,
            {} if be == "dense" else {("StoreSum" if be == "codebook"
                                       else "lut_"): per_fwd}, step_pos=40)
        stats[be] = {**step_stats(res), "graph": res}
        if be != "dense":
            launches[name] = res["launches"][name]

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

    # lut's split-K scratch under a graph: capture a decode step on a fresh
    # scratch buffer, outgrow it with an eager prefill of 256 rows, serve
    # again: the replays must still find their own buffer
    e = eng["lut"]
    _common._SCRATCH.clear()          # the buffers handed out stay kept
    e._slot_sets.clear()              # a new loop state: a new capture
    c0 = e.n_captures
    first = e.serve(prompts[:4], max_new=16)
    held = dict(_common._SCRATCH)
    t256, l256 = e._pad_prompts([(p * 8)[:64] for p in prompts[:4]])
    e._prefill(t256, l256)
    grown = [k for k, v in held.items() if _common._SCRATCH[k] is not v]
    again = e.serve(prompts[:4], max_new=16)
    if not grown or e.n_captures - c0 != 1 or not (
            first == again == tokens["lut"]):
        raise AssertionError(f"[main] lut scratch growth: grown {grown}, "
                             f"captures {e.n_captures - c0}, tokens equal "
                             f"{first == again == tokens['lut']}")
    log(f"[main] lut scratch growth: a decode step captured on a fresh "
        f"scratch, {', '.join(t for t, _ in grown)} outgrown by a "
        f"{tuple(t256.shape)} prefill, then served again: tokens equal the "
        "eager route's")

    # prefill timings (after the counted runs)
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    t32, l32 = eng["dense"]._pad_prompts([(prompts[0] * 4)[:32]])
    stats["lut_path_ids"] = lut_path_ids(dev, eng["lut"], prompts, t32, l32,
                                         cfg.n_layers)
    for be, e in eng.items():
        pre = [timed(lambda: e._prefill(t32, l32))[1] for _ in range(4)][1:]
        stats[be]["prefill_ms"] = 1e3 * sorted(pre)[len(pre) // 2]
        log(f"[main] {be}: prefill 1×32 tokens {stats[be]['prefill_ms']:.2f}"
            " ms")
    x = torch.randn(4, 1, cfg.d_model, device=dev).to(torch.bfloat16)
    stats["tied_logits_ms"] = time_ms(lambda: L.embed_logits(cp["embed"], x),
                                      reps=10)
    log(f"[main] tied logits (4×2048 @ dequantized 152064×2048 f32): "
        f"{stats['tied_logits_ms']:.3f} ms; peak memory "
        f"{stats['peak_mem_gib']:.2f} GiB")
    return stats, launches


def lut_path_ids(dev, e, prompts, t32, l32, n_layers) -> dict:
    """lut_matmul on the serving path's own activation ids: every call of a
    4-request serve (on the eager route) and of a 1 × 32 prefill through
    engine ``e`` captured
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
    e._graphs = False                 # a replay would call no wrapper
    try:
        e.serve(prompts[:4], max_new=16)
        n_serve = len(calls)
        e._prefill(t32, l32)
    finally:
        ops.lut_matmul = orig
        e._graphs = True
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
    max_len PAGED_MAX_LEN, MAX_BATCH slots, 16 new tokens per request, on
    the graph route against the eager route (``graph_vs_eager``).  Each
    engine is counted alone: page_gather launches must be one a layer (K,
    V and, with int8 pages, their scales in one launch) × layers ×
    forwards, matmul launches 7 × layers × forwards; the pool holds no
    reference after each serve, and every serve after the first hits the
    prefix cache more than the first did."""
    import torch
    from repro_torch.serving import ServeEngine

    kw = dict(paged=True, page_size=PAGE, max_len=PAGED_MAX_LEN,
              max_batch=MAX_BATCH, device=dev)
    n_l = cfg.n_layers
    eng, tokens, launches, stats = {}, {}, {}, {}
    for be, kv, n in (("codebook", "int8", 8), ("codebook", "bf16", 8),
                      ("lut", "int8", 4)):
        e = eng[be, kv] = ServeEngine(model, cp, backend=be, kv_dtype=kv,
                                      **kw)
        pool, hits = e.pool, []

        def after_serve(i, pool=pool, hits=hits, tag=f"paged {be} {kv}"):
            if not _pool_clean(pool):
                raise AssertionError(f"{tag}: pages still referenced after "
                                     f"serve {i}")
            hits.append(pool.stats.hit_pages - sum(hits))
        name = f"{be}_matmul"
        res, tokens[be, kv] = graph_vs_eager(
            f"[paged] {be} {kv} pages", e, chats[:n], chats[:4],
            {name: 7 * n_l, "page_gather": n_l},
            {("StoreSum" if be == "codebook" else "lut_"): 7 * n_l,
             "page_gather": n_l}, step_pos=120, n_pages=N_PAGES,
            after_serve=after_serve)
        if hits[0] <= 0 or min(hits[1:]) <= hits[0]:
            raise AssertionError(f"paged {be} {kv}: hit pages by serve "
                                 f"{hits}")
        for k_ in ("page_gather", name):
            launches[k_] = launches.get(k_, 0) + res["launches"][k_]
        st = pool.stats
        step = res["step"]
        stats[f"{be}_{kv}"] = {
            "requests": n, "graph": res, "hit_pages_by_serve": hits,
            "serve_tok_s": res["serve_tok_s"]["graph"],
            "serve_tok_s_eager": res["serve_tok_s"]["eager"],
            "miss_pages": st.miss_pages, "cow_copies": st.cow_copies,
            "peak_pages_in_use": st.peak_pages_in_use,
            "pool_bytes": pool.bytes_total(),
            "slab_bytes": e.dense_cache_bytes(),
            "page_gather_device_ms": step["graph"]["match_ms"],
            "page_gather_share": (step["graph"]["match_ms"]
                                  / step["graph"]["device_ms"])}
        log(f"[paged] {be} {kv} pages: {n} requests, 4 serves; hit pages by "
            f"serve {hits}, miss {st.miss_pages}, CoW {st.cow_copies}, peak "
            f"pages {st.peak_pages_in_use}/{pool.usable_pages}; pool "
            f"{pool.bytes_total()} B vs contiguous slab "
            f"{e.dense_cache_bytes()} B; step (4 slots at 120, max_len "
            f"{PAGED_MAX_LEN}): page_gather "
            f"{step['graph']['match_ms']:.3f} ms of "
            f"{step['graph']['device_ms']:.3f} device ms "
            f"({n_l} launches, "
            f"{1e3 * step['graph']['match_ms'] / n_l:.2f} us each)")

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

    # the contiguous engine's step beside the paged ones, and a paged
    # prefill chunk on a fresh pool
    c_step = step_turns("[paged] contiguous codebook", contig,
                        step_state(contig, 120), {"StoreSum": 7 * n_l})
    e = eng["codebook", "int8"]
    pool = model.init_paged_cache(N_PAGES, PAGE, torch.int8, device=dev)
    pt = torch.arange(1, N_PAGES, dtype=torch.int32,
                      device=dev).reshape(MAX_BATCH, -1)
    batch = {"tokens": torch.zeros((1, PAGE), dtype=torch.int64, device=dev),
             "start": SYSTEM_LEN, "length": PAGE, "page_row": pt[0],
             "write_pid": int(pt[0, SYSTEM_LEN // PAGE])}
    with torch.no_grad():
        pre = [timed(lambda: model.prefill_chunk(e.params, batch, pool,
                                                 e.bk))[1]
               for _ in range(6)][1:]
    med = lambda xs: 1e3 * sorted(xs)[len(xs) // 2]           # noqa: E731
    paged = stats["codebook_int8"]["graph"]["step"]
    stats["steps"] = {
        "paged_int8_decode_ms": paged["graph"]["mean_wall_ms"],
        "paged_int8_decode_ms_eager": paged["eager"]["mean_wall_ms"],
        "paged_int8_device_ms": paged["graph"]["device_ms"],
        "paged_prefill_chunk_ms": med(pre),
        "contiguous_decode_ms": c_step["graph"]["mean_wall_ms"],
        "contiguous_decode_ms_eager": c_step["eager"]["mean_wall_ms"],
        "contiguous_device_ms": c_step["graph"]["device_ms"],
        "contiguous_top_kernels": c_step["graph"]["top"]}
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[paged] codebook decode step, 4 slots at pos 120, max_len "
        f"{PAGED_MAX_LEN}, graph (eager): paged int8 "
        f"{paged['graph']['mean_wall_ms']:.2f} "
        f"({paged['eager']['mean_wall_ms']:.2f}) ms, device busy "
        f"{paged['graph']['device_ms']:.2f} ms | contiguous bf16 "
        f"{c_step['graph']['mean_wall_ms']:.2f} "
        f"({c_step['eager']['mean_wall_ms']:.2f}) ms, device busy "
        f"{c_step['graph']['device_ms']:.2f} ms, replayed logits bit-equal "
        f"| paged prefill chunk 1×{PAGE} at start {SYSTEM_LEN}: "
        f"{med(pre):.2f} ms; peak memory {stats['peak_mem_gib']:.2f} GiB")
    return stats, launches


# --- [spec]: speculative decoding on the contiguous cache ---------------------

SPEC_K = 4                       # draft tokens a round: verify M = 4 × 5 = 20


def spec_prompts(prompts, vocab: int):
    """The [spec] phase's 8 requests: the main path's first 4 random
    prompts and 4 repetitive ones (a phrase of 3 to 6 tokens repeated to
    24 to 40 tokens, as templated text and code give), so that the n-gram
    draft meets both."""
    import numpy as np
    rng = np.random.default_rng(1)
    reps = []
    for n, width in zip((24, 30, 36, 40), (3, 4, 5, 6)):
        phrase = rng.integers(0, vocab, width).tolist()
        reps.append((phrase * n)[:n])
    return [p for pair in zip(prompts[:4], reps) for p in pair]


def spec_counts(s) -> tuple:
    return (s.rounds, s.proposed, s.accepted, s.emitted)


def draft_forwards(e) -> int:
    """Draft forwards of engine ``e`` whose kernel wrappers ran (as
    ``called_forwards``)."""
    return e.n_draft_forwards - e.n_draft_replays + e.n_draft_captures


REDUCED_SPEC_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 11,
                        [300, 2, 5, 7, 1, 8], [7, 8, 9] * 5,
                        [1, 2, 3, 4, 5, 6, 7]]
REDUCED_SPEC_STOPS = [8, 3, 12, 1, 10, 6]


def reduced_spec_model(dev):
    """The 2-layer qwen3 (f32, |W| = 256, clustered on the CPU) the reduced
    spec checks serve: (model, {"cpu" | "card": {"dense" | "index":
    params}})."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import (WeightQuantConfig,
                                            cluster_params, init_state)
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import to_codebook_params
    cfg = configs.get("qwen3-1.7b").reduced().replace(n_layers=2)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    wq = WeightQuantConfig(num_weights=256)
    pq, st = cluster_params(params, wq, init_state(wq), wq.interval)
    cp = to_codebook_params(pq, wq, st, min_size=1024)
    return model, {"cpu": {"dense": params, "index": cp},
                   "card": {"dense": _to(params, dev), "index": _to(cp, dev)}}


def spec_reduced(dev):
    """The reduced check: the 2-layer qwen3 (f32, |W| = 256) of phase 4
    served with speculative rounds (k = 3) on the card and on the CPU:
    n-gram on codebook and lut, a lut draft (|A| 512) for a codebook
    target, a dense draft for a dense target; greedy tokens and the four
    counters equal the CPU's, and on the card spec tokens equal the
    baseline serve's."""
    from repro_torch.serving import ServeEngine, SpecConfig
    model, trees = reduced_spec_model(dev)
    prompts, stops = REDUCED_SPEC_PROMPTS, REDUCED_SPEC_STOPS
    cases = (("codebook", "ngram"), ("lut", "ngram"), ("codebook", "lut"),
             ("dense", "dense"))
    lines = []
    for be, draft in cases:
        which = "dense" if be == "dense" else "index"
        out = {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            tp = trees[where]
            sp = SpecConfig(draft="ngram", k=3) if draft == "ngram" else \
                SpecConfig(draft="model", k=3, draft_backend=draft,
                           lut_levels=512,
                           draft_params=tp["dense" if draft == "dense"
                                           else "index"])
            e = ServeEngine(model, tp[which], max_len=64, max_batch=2,
                            backend=be, device=d, spec=sp)
            out[where] = (e.serve(prompts, max_new=stops),
                          spec_counts(e.spec_stats))
        base = ServeEngine(model, trees["card"][which], max_len=64,
                           max_batch=2, backend=be, device=dev).serve(
            prompts, max_new=stops)
        if out["card"] != out["cpu"] or out["card"][0] != base:
            raise AssertionError(
                f"[spec] reduced {be} target, {draft} draft: card "
                f"{out['card']} against CPU {out['cpu']}; baseline on the "
                f"card {base}")
        lines.append(f"{be}+{draft} {out['card'][1]}")
    log("[spec] reduced 2-layer qwen3 (f32), k = 3, 6 requests over 2 "
        "slots: tokens and counters (rounds, proposed, accepted, emitted) "
        "on the card equal the CPU's, and spec tokens equal the baseline "
        "serve's on the card: " + "; ".join(lines))


def baseline_rows(e, reqs, max_new: int):
    """Two baseline serves of ``reqs`` by engine ``e`` (no spec) on the
    graph route.  The first (which captures, if the engine has no graph
    at this batch yet) records, for every decode step and live slot, its
    logit row (a replay's logits are the eager step's, bit for bit); the
    second is timed, and its tokens must equal the first's.  Returns
    (tokens, {(request, token index): f32 logit row on the host}, tok/s).
    Admission fills slots in request order, so each admitted slot's
    request is the next in the queue."""
    import numpy as np
    V = e.model.cfg.vocab
    st = e._slots(e.max_batch, e.paged)
    nxt, slot_rid, rec = [0], {}, {}
    admit, step = st.admit, e._step

    def admit_rec(b, first, stop):
        slot_rid[b] = nxt[0]
        nxt[0] += 1
        admit(b, first, stop)

    def step_rec(s):
        live, n_before = s.h_active.copy(), s.h_n_gen.copy()
        step(s)
        lg = s.logits[:, -1, :V].float().cpu()
        for b in np.flatnonzero(live):
            rec[slot_rid[b], int(n_before[b])] = lg[b]

    st.admit, e._step = admit_rec, step_rec
    e._graphs = True
    try:
        toks = e.serve(reqs, max_new=max_new)
    finally:
        del st.admit, e._step
    again, secs = timed(lambda: e.serve(reqs, max_new=max_new))
    if again != toks:
        raise AssertionError("baseline: the second graph serve's tokens "
                             "differ from the first's")
    return toks, rec, max_new * len(reqs) / secs


def spec_rows(e, reqs, max_new: int):
    """One spec serve of ``reqs`` by engine ``e`` on the route ``e`` is
    set to, recording the logit row behind each emitted token: the
    prefill's row behind token 0 (a spec engine samples only there), and
    row i of a round's verify behind the token at index n + i of a slot
    that had n tokens (the round emits rows 0 .. m − 1).  Returns
    (tokens, {(request, token index): f32 logit row on the host})."""
    import numpy as np
    V = e.model.cfg.vocab
    st = e._spec_slots(e.max_batch, e.paged)
    nxt, slot_rid, rec, last_row = [0], {}, {}, [None]
    admit, step, sample = st.admit, e._spec_step, e._sample

    def sample_rec(logits):
        last_row[0] = logits[0, -1, :V].float().cpu()
        return sample(logits)

    def admit_rec(b, first, stop, prompt):
        slot_rid[b] = nxt[0]
        rec[nxt[0], 0] = last_row[0]
        nxt[0] += 1
        admit(b, first, stop, prompt)

    def step_rec(s):
        live, n_before = s.h_active.copy(), s.h_n_gen.copy()
        step(s)
        lg = s.logits[:, :, :V].float().cpu()
        for b in np.flatnonzero(live):
            for i in range(int(s.h_n_gen[b] - n_before[b])):
                rec[slot_rid[b], int(n_before[b]) + i] = lg[b, i]

    st.admit, e._spec_step, e._sample = admit_rec, step_rec, sample_rec
    try:
        toks = e.serve(reqs, max_new=max_new)
    finally:
        del st.admit, e._spec_step, e._sample
    return toks, rec


def spec_agreement(tag: str, got, want, reqs, rec, srec,
                   strict: bool = True) -> dict:
    """Spec tokens ``got`` against the baseline's ``want``, with the
    baseline decode rows ``rec`` and the spec verify rows ``srec`` behind
    them (``baseline_rows``, ``spec_rows``).  Up to each request's first
    parting the two serves read the same tokens, so a verify row and the
    decode row of the same position compute one function at two row
    counts (M = 20 and M = 4 in bf16): their largest difference over
    these rows, ``delta``, is what rounding alone moves a logit by.  A
    parting, where the baseline took token a and spec token s, passes
    only if the verify row's own argmax is s (the round emitted what its
    row chose), the baseline row's argmax is a, the baseline's gap
    between the two is at most 2·delta (a flip needs the rows to differ
    by that gap on the two logits, and rounding reaches 2·delta at
    positions that agree), and the
    baseline row's top-2 gap is at most 1 % of its logit range (a near
    tie).  Anything else raises; with ``strict`` off (two sides that are
    not one function up to rounding, such as int8 pages against a bf16
    cache) a parting outside these bounds is reported under ``outside``
    instead."""
    same = total = 0
    partings, delta, rows = [], 0.0, 0
    for r, (g, w, p) in enumerate(zip(got, want, reqs)):
        cg, cw = g[len(p):], w[len(p):]
        total += len(cw)
        j = next((i for i, (a, b) in enumerate(zip(cg, cw)) if a != b),
                 len(cw))
        same += j
        for i in range(j):
            if (r, i) in rec and (r, i) in srec:
                delta = max(delta,
                            (srec[r, i] - rec[r, i]).abs().max().item())
                rows += 1
        if j < len(cw):
            partings.append((r, j, cg[j], cw[j]))
    out = []
    for r, j, s_tok, a_tok in partings:
        if (r, j) not in rec or (r, j) not in srec:
            if not strict:
                out.append({"request": r, "at": j,
                            "outside": "no row recorded on both sides"})
                continue
            raise AssertionError(f"{tag}: request {r} parts from the "
                                 f"baseline at token {j}, which no decode "
                                 "step or no verify row made (the "
                                 "prefill's sample)")
        base, ver = rec[r, j], srec[r, j]
        top2 = base.topk(2).values
        gap = (top2[0] - top2[1]).item()
        rng = (base.max() - base.min()).item()
        gap_as = (base[a_tok] - base[s_tok]).item()
        moved = gap_as - (ver[a_tok] - ver[s_tok]).item()
        d_row = (ver - base).abs().max().item()
        p = {"request": r, "at": j, "gap": gap, "range": rng,
             "share": gap / rng, "gap_to_spec_token": gap_as,
             "rows_differ_on_pair": moved, "row_delta": d_row}
        out.append(p)
        why = None
        if int(ver.argmax()) != s_tok:
            why = (f"the verify row's argmax {int(ver.argmax())} is not the "
                   f"emitted token {s_tok}")
        elif int(base.argmax()) != a_tok:
            why = (f"the baseline row's argmax {int(base.argmax())} is not "
                   f"its token {a_tok}")
        elif rows and gap_as > 2 * delta:
            why = (f"the baseline's gap {gap_as:.4e} between the two "
                   f"tokens exceeds 2 × {delta:.4e}, the largest "
                   "difference of rows at agreeing positions")
        elif gap > 0.01 * rng:
            why = (f"the baseline row's top-2 gap {gap:.4e} is "
                   f"{gap / rng:.4f} of its range {rng:.4e}: more than a "
                   "near tie")
        if why and not strict:
            p["outside"] = why
        elif why:
            raise AssertionError(f"{tag}: request {r} parts from the "
                                 f"baseline at token {j}: {why}")
    if out and not rows and strict:
        raise AssertionError(f"{tag}: partings but no agreeing position "
                             "to measure the rows' difference on")
    return {"same_before_parting": same, "total": total,
            "partings": out, "delta": delta, "delta_rows": rows}


def parting_text(p: dict) -> str:
    """One parting of ``spec_agreement`` for the log."""
    if "share" not in p:
        return f" (request {p['request']} at {p['at']}: {p['outside']})"
    return (f" (request {p['request']} at {p['at']}: top-2 gap "
            f"{p['share']:.5f} of the range, gap to the spec token "
            f"{p['gap_to_spec_token']:.4e}, "
            + (f"outside the near-tie bounds: {p['outside']})"
               if "outside" in p else "the verify row chose it)"))


def spec_state(e, pos: int):
    """A speculative loop state of its own for engine ``e``
    (``ServeEngine._new_spec_slots``): MAX_BATCH live slots at ``pos`` on
    zeroed caches (paged: on the pool as the serves left it, each slot
    owning its own pages, so that no write lands on the shared trash
    page), each with a history of pos + 1 tokens (a period-7 pattern, so
    that the n-gram draft finds matches)."""
    import torch
    st = e._new_spec_slots(MAX_BATCH, e.paged)
    if e.paged:
        pt = st.cache["page_table"]
        pt.copy_(1 + torch.arange(pt.numel(), dtype=pt.dtype,
                                  device=pt.device).reshape(pt.shape))
    for c in (st.cache, st.dcache):
        if c is not None:
            c["pos"].fill_(pos)
    hist = torch.arange(pos + 1, device=e.device) % 7 + 100
    st.ctx[:, :pos + 1] = hist
    st.ctx_len.fill_(pos + 1)
    st.last.copy_(st.ctx[:, pos])
    st.active.fill_(True)
    st.stops.fill_(1 << 20)
    return st


def round_check(tag: str, e, pos: int) -> dict:
    """One speculative round on a state of its own (``spec_state``) on the
    graph route against the eager route: the replayed round's verify
    logits bit-equal to the eager round's from the same state; the wall
    ms of the eager round, and of a round on the graph route (the median
    of 3 replays from the state).  No profiler reading."""
    import torch
    st = spec_state(e, pos)
    saved = {k: t.clone() for k, t in st.state().items()}

    def restore():
        for k, t in st.state().items():
            t.copy_(saved[k])

    def one(graphs: bool):
        restore()
        e._graphs = graphs
        e._spec_step(st)
        return st.logits.clone()
    one(True)                                    # the capture, untimed
    lg_e, t_eager = timed(lambda: one(False))
    lg_g = one(True)
    if not bool(torch.isfinite(lg_e[..., :e.model.cfg.vocab]).all()):
        raise AssertionError(f"{tag}: non-finite verify logits")
    if not torch.equal(lg_g, lg_e):
        raise AssertionError(f"{tag}: the replayed round's logits differ "
                             "from the eager round's by "
                             f"{(lg_g - lg_e).abs().max().item():.3e}")
    restore()
    e._graphs = True
    w = [timed(lambda: e._spec_step(st))[1] for _ in range(3)]
    restore()
    return {"graph": 1e3 * sorted(w)[1], "eager": 1e3 * t_eager,
            "logits_bit_equal": True}


def spec_turns(tag: str, e, reqs, per_fwd: dict, per_draft: dict,
               baseline, max_new: int = 16, others=None,
               after_serve=None) -> dict:
    """A spec engine ``e`` (a fresh one) in one run: ``serve(reqs,
    max_new)`` in turns (eager, graph — its first, which captures —,
    graph, eager), tokens and the four counters equal in all four, the
    second graph serve capturing nothing, ``after_serve(i)`` after each;
    launches ``per_fwd`` a target forward and ``per_draft`` a draft
    forward whose wrappers ran; tok/s of each route; the agreement with
    the baseline's tokens (``spec_agreement``; none when ``baseline`` is
    None) and with each of ``others`` ({name: (tokens, rows, strict)}); a
    round on each route (``round_check``)."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    c0, d0 = called_forwards(e), draft_forwards(e)
    outs, secs = [], {"eager": [], "graph": []}
    for i, route in enumerate(("eager", "graph", "graph", "eager")):
        e._graphs = route == "graph"
        e.spec_stats.reset()
        before = e.n_captures + e.n_draft_captures
        if i == 0:             # records the verify rows (slower: not
            (toks, srec), s = timed(           # the route's time then)
                lambda: spec_rows(e, reqs, max_new))
        else:
            toks, s = timed(lambda: e.serve(reqs, max_new=max_new))
        secs[route].append(s)
        if i == 2 and e.n_captures + e.n_draft_captures != before:
            raise AssertionError(f"{tag}: the second graph serve captured")
        if after_serve is not None:
            after_serve(i)
        outs.append((toks, spec_counts(e.spec_stats)))
        if outs[-1] != outs[0]:
            raise AssertionError(f"{tag}: {route} serve {i} gave tokens or "
                                 f"counters {outs[-1][1]} other than the "
                                 f"first eager serve's {outs[0][1]}")
    for seq in outs[0][0]:
        if not all(0 <= t < e.model.cfg.vocab for t in seq):
            raise AssertionError(f"{tag}: token id out of range")
    counts = ops.launch_counts()
    fwd, dfwd = called_forwards(e) - c0, draft_forwards(e) - d0
    want = {k: per_fwd.get(k, 0) * fwd + per_draft.get(k, 0) * dfwd
            for k in counts}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} over {fwd} target "
                             f"and {dfwd} draft forwards, want {want}")
    rounds, proposed, accepted, emitted = outs[0][1]
    agree = (None if baseline is None else
             spec_agreement(tag, outs[0][0], baseline[0], reqs, baseline[1],
                            srec))
    vs = {name: spec_agreement(f"{tag} vs {name}", outs[0][0], toks_, reqs,
                               rows_, srec, strict_)
          for name, (toks_, rows_, strict_) in (others or {}).items()}
    rt = round_check(tag, e, 40)
    res = {"tokens": outs[0][0], "rounds": rounds, "proposed": proposed,
           "accepted": accepted, "emitted": emitted,
           "acceptance_rate": accepted / max(proposed, 1),
           "tokens_per_round": emitted / max(rounds, 1),
           "serve_s": secs,
           # the first eager serve records rows: the second is timed
           "serve_tok_s": {"eager": max_new * len(reqs) / secs["eager"][1],
                           "graph": max_new * len(reqs)
                           / min(secs["graph"])},
           "launches": counts, "target_forwards": fwd,
           "draft_forwards": dfwd, "agreement": agree, "agreement_vs": vs,
           "round_ms": rt,
           "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30}
    log(f"{tag}: serve {max_new * len(reqs)} tokens in turns (eager, graph, "
        "graph, eager) " + ", ".join(f"{s:.3f}" for s in (
            secs["eager"][0], *secs["graph"], secs["eager"][1]))
        + f" s → eager {res['serve_tok_s']['eager']:.1f}, graph "
        f"{res['serve_tok_s']['graph']:.1f} tok/s; tokens and counters "
        f"equal; {rounds} rounds, {proposed} proposed, {accepted} accepted "
        f"(rate {res['acceptance_rate']:.3f}), {emitted} emitted "
        f"({res['tokens_per_round']:.2f} a round over the {MAX_BATCH} "
        f"slots); wrappers ran for {fwd} "
        f"target and {dfwd} draft forwards: "
        + ", ".join(f"{counts[k]} {k}" for k in counts if counts[k])
        + f" (= {per_fwd} a target, {per_draft} a draft forward)"
        + "".join(f"; vs the {name} {a['same_before_parting']}/{a['total']} "
                  f"tokens before the first partings, {len(a['partings'])} "
                  "partings"
                  + "".join(parting_text(p) for p in a["partings"])
                  + f", rows at {a['delta_rows']} agreeing positions differ "
                  f"by at most {a['delta']:.4e}"
                  for name, a in ((("baseline", agree),) if agree else ())
                  + tuple(vs.items()))
        + f"; a round ({MAX_BATCH} slots at 40) eager {rt['eager']:.2f} "
        f"(one), graph {rt['graph']:.2f} ms, replayed logits bit-equal; "
        "memory "
        f"reserved {res['reserved_gib']:.2f} GiB")
    return res


def freed(tag: str) -> float:
    """After the caller has dropped an engine (its loop states, graphs and
    graph pool, and its lut tables, with it): the cache returned to the
    card, and the GiB still reserved, logged."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    gib = torch.cuda.memory_reserved() / 2 ** 30
    log(f"{tag}: freed; memory reserved {gib:.2f} GiB")
    return gib


def spec_path(dev, cfg, model, cp, prompts, main_stats
              ) -> tuple[dict, dict]:
    """The [spec] phase: first the reduced check (``spec_reduced``), then
    phase 5's compressed qwen3-1.7b (28 layers, full width; the live
    ``model`` and ``cp``) served with speculative rounds,
    k = SPEC_K, MAX_BATCH slots, greedy: codebook target with the n-gram
    draft (8 requests, 4 of them repetitive, 16 new tokens), codebook
    target with a lut draft (the same index-form params through the lut
    backend; 4 requests, 8 new tokens), lut target with the n-gram draft
    (4, 8; the lut engines cut for time).  Each (``spec_turns``) against
    a baseline engine of its backend (``baseline_rows``); every engine
    freed before the next.
    Returns (stats, launches)."""
    import torch
    from repro_torch.serving import ServeEngine, SpecConfig
    spec_reduced(dev)
    log(f"[spec] start: memory reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")
    reqs = spec_prompts(prompts, cfg.vocab)
    kw = dict(max_len=128, max_batch=MAX_BATCH, device=dev)
    n_l = cfg.n_layers
    stats, launches = {}, {}
    baselines = {}
    for be, n, new in (("codebook", 8, 16), ("lut", 4, 8)):
        b = ServeEngine(model, cp, backend=be, **kw)
        baselines[be] = (*baseline_rows(b, reqs[:n], new), n, new)
        log(f"[spec] baseline {be}, {n} requests, {new} new tokens: graph "
            f"serve {baselines[be][2]:.1f} tok/s; memory reserved "
            f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB")
        del b
        freed(f"[spec] baseline {be}")
    cases = (("codebook", "ngram", 8, 16), ("codebook", "lut", 4, 8),
             ("lut", "ngram", 4, 8))
    for be, draft, n, new in cases:
        tag = f"[spec] {be} target, {draft} draft"
        sp = SpecConfig(draft="ngram", k=SPEC_K) if draft == "ngram" else \
            SpecConfig(draft="model", k=SPEC_K, draft_params=cp,
                       draft_backend=draft)
        e = ServeEngine(model, cp, backend=be, spec=sp, **kw)
        per_fwd = {f"{be}_matmul": 7 * n_l}
        per_draft = {} if draft == "ngram" else {f"{draft}_matmul": 7 * n_l}
        toks, rec, base_tok_s, base_n, base_new = baselines[be]
        # a shorter run's baseline is the longer one's prefix (greedy)
        want = [t[:len(p) + new] for t, p in zip(toks[:n], reqs)]
        res = spec_turns(tag, e, reqs[:n], per_fwd, per_draft, (want, rec),
                         max_new=new)
        res["baseline_serve_tok_s"] = base_tok_s
        res["decode_step_ms"] = main_stats[be]["decode_step_ms"]
        log(f"{tag}: round {res['round_ms']['graph']:.2f} ms against the "
            f"main path's decode step {res['decode_step_ms']:.2f} ms (graph "
            f"route, 4 slots at 40); serve {res['serve_tok_s']['graph']:.1f} "
            f"tok/s against the baseline's {base_tok_s:.1f} ({base_n} "
            f"requests, {base_new} new tokens)")
        for k, v in res["launches"].items():
            launches[k] = launches.get(k, 0) + v
        res.pop("tokens")
        stats[f"{be}_{draft}"] = res
        del e
        res["reserved_after_free_gib"] = freed(tag)
    return stats, launches


# --- [paged-spec]: speculative decoding on the paged cache --------------------

def paged_spec_reduced(dev):
    """The reduced check of the paged spec path: the 2-layer qwen3 of
    ``spec_reduced`` (f32, k = 3), page 4, on the card and on the CPU:
    n-gram and lut drafts (codebook target) on f32 and int8 pages; greedy
    tokens and the four counters on the card equal the CPU's, the pool
    holds no reservation after each serve, and on f32 pages spec tokens
    equal the paged baseline serve's on the card."""
    from repro_torch.serving import ServeEngine, SpecConfig
    model, trees = reduced_spec_model(dev)
    prompts, stops = REDUCED_SPEC_PROMPTS, REDUCED_SPEC_STOPS
    kw = dict(max_len=64, max_batch=2, backend="codebook", paged=True,
              page_size=4)
    lines = []
    for draft in ("ngram", "lut"):
        for kv in ("bf16", "int8"):
            out = {}
            for where, d in (("cpu", "cpu"), ("card", dev)):
                tp = trees[where]
                sp = SpecConfig(draft="ngram", k=3) if draft == "ngram" else \
                    SpecConfig(draft="model", k=3, draft_backend="lut",
                               lut_levels=512, draft_params=tp["index"])
                e = ServeEngine(model, tp["index"], kv_dtype=kv, device=d,
                                spec=sp, **kw)
                out[where] = (e.serve(prompts, max_new=stops),
                              spec_counts(e.spec_stats))
                if e.pool.reserved_extra or not _pool_clean(e.pool):
                    raise AssertionError(f"[paged-spec] reduced {draft} "
                                         f"{kv}: pool not clean on {where}")
            if out["card"] != out["cpu"]:
                raise AssertionError(
                    f"[paged-spec] reduced {draft} draft, {kv} pages: card "
                    f"{out['card']} against CPU {out['cpu']}")
            if kv == "bf16":
                base = ServeEngine(model, trees["card"]["index"], kv_dtype=kv,
                                   device=dev, **kw).serve(prompts,
                                                           max_new=stops)
                if out["card"][0] != base:
                    raise AssertionError(
                        f"[paged-spec] reduced {draft} draft: spec tokens "
                        f"{out['card'][0]} against the paged baseline's "
                        f"{base} on the card")
            lines.append(f"{draft} {kv} {out['card'][1]}")
    log("[paged-spec] reduced 2-layer qwen3 (f32), k = 3, page 4, 6 "
        "requests over 2 slots, codebook target: tokens and counters "
        "(rounds, proposed, accepted, emitted) on the card equal the CPU's, "
        "no reservation left, and on f32 pages spec tokens equal the paged "
        "baseline's on the card: " + "; ".join(lines))


def paged_spec_path(dev, cfg, model, cp, chats, s_stats, p_stats
                    ) -> tuple[dict, dict]:
    """The [paged-spec] phase: the reduced check (``paged_spec_reduced``),
    then phase 5's compressed qwen3-1.7b (the live ``model`` and ``cp``)
    served by ``ServeEngine(paged=True, spec=...)``, k = SPEC_K, page PAGE,
    max_len PAGED_MAX_LEN, MAX_BATCH slots, greedy, on the paged phase's
    chat requests: codebook with int8 pages and the n-gram draft (4
    requests, 16 new tokens), codebook with bf16 pages and a lut draft
    (4, 8), lut with int8 pages and the n-gram draft (4, 8).  Each
    (``spec_turns``, the pool clean and no page reserved after each serve;
    page_gather one launch a layer of every target forward: verifies and
    prefill chunks) against the paged baseline of its backend and pages
    (``baseline_rows``) by the parting check, and against the contiguous
    spec engine of its backend and draft (``spec_rows``, prefill rows
    included): by the parting check on bf16 pages, reported on int8
    pages, whose quantized K/V are not the bf16 cache's values up to
    rounding; the round beside the
    contiguous round of [spec] and the paged decode step of phase 6.
    Every engine freed before the next.  Returns (stats, launches)."""
    import torch
    from repro_torch.serving import ServeEngine, SpecConfig
    paged_spec_reduced(dev)
    n_l = cfg.n_layers
    kw = dict(max_len=PAGED_MAX_LEN, max_batch=MAX_BATCH, device=dev)
    pkw = dict(paged=True, page_size=PAGE, **kw)
    stats, launches = {}, {}
    # 4 requests at codebook + n-gram (not [spec]'s 8): cut to keep the new
    # phases near 70 s
    for be, kv, draft, n, new in (("codebook", "int8", "ngram", 4, 16),
                                  ("codebook", "bf16", "lut", 4, 8),
                                  ("lut", "int8", "ngram", 4, 8)):
        tag = f"[paged-spec] {be} target, {kv} pages, {draft} draft"
        reqs = chats[:n]
        sp = SpecConfig(draft="ngram", k=SPEC_K) if draft == "ngram" else \
            SpecConfig(draft="model", k=SPEC_K, draft_params=cp,
                       draft_backend=draft)
        b = ServeEngine(model, cp, backend=be, kv_dtype=kv, **pkw)
        base = baseline_rows(b, reqs, new)
        if not _pool_clean(b.pool):
            raise AssertionError(f"{tag}: the baseline's pool is not clean")
        del b
        freed(f"{tag}: paged baseline ({base[2]:.1f} tok/s)")
        c = ServeEngine(model, cp, backend=be, spec=sp, **kw)
        c._graphs = True
        contig = spec_rows(c, reqs, new)
        del c
        freed(f"{tag}: contiguous spec")
        e = ServeEngine(model, cp, backend=be, kv_dtype=kv, spec=sp, **pkw)

        def after_serve(i, pool=e.pool, tag=tag):
            if pool.reserved_extra or not _pool_clean(pool):
                raise AssertionError(f"{tag}: serve {i} left pages "
                                     f"referenced or {pool.reserved_extra} "
                                     "reserved")
        per_fwd = {f"{be}_matmul": 7 * n_l, "page_gather": n_l}
        per_draft = {} if draft == "ngram" else {f"{draft}_matmul": 7 * n_l}
        # int8 pages quantize K/V that the contiguous cache keeps in bf16:
        # the parting check gates that comparison only on bf16 pages, and
        # reports it on int8 pages (the paged baseline gates those)
        res = spec_turns(tag, e, reqs, per_fwd, per_draft, base[:2],
                         max_new=new,
                         others={"contiguous spec": (*contig, kv == "bf16")},
                         after_serve=after_serve)
        res["baseline_serve_tok_s"] = base[2]
        res["contiguous_round_ms"] = s_stats[f"{be}_{draft}"]["round_ms"]
        step = p_stats[f"{be}_{kv}"]["graph"]["step"]
        res["paged_decode_step_ms"] = step["graph"]["mean_wall_ms"]
        res["pool"] = {"truncated_pages": e.pool.stats.truncated_pages,
                       "cow_copies": e.pool.stats.cow_copies,
                       "peak_pages_in_use": e.pool.stats.peak_pages_in_use,
                       "hit_pages": e.pool.stats.hit_pages}
        log(f"{tag}: round {res['round_ms']['graph']:.2f} ms (eager "
            f"{res['round_ms']['eager']:.2f}) against the contiguous round "
            f"{res['contiguous_round_ms']['graph']:.2f} ms of [spec] and the "
            f"paged {kv} decode step {res['paged_decode_step_ms']:.2f} ms of "
            f"phase 6 (graph route, 4 slots at 40 / 120); serve "
            f"{res['serve_tok_s']['graph']:.1f} tok/s against the paged "
            f"baseline's {base[2]:.1f}; pool: {res['pool']}")
        for k_, v in res["launches"].items():
            launches[k_] = launches.get(k_, 0) + v
        res.pop("tokens")
        stats[f"{be}_{kv}_{draft}"] = res
        del e, after_serve
        res["reserved_after_free_gib"] = freed(tag)
    return stats, launches


# --- [sched]: the step-level API, the scheduler and the server ------------------

def count_calls(e, calls: dict | None = None) -> dict:
    """Count, on engine ``e`` into ``calls``, the ``serve_step`` calls that
    decoded, the decode steps run (one device→host read each, and one
    after each such ``serve_step``) and the swap-outs (one page_gather
    launch each).  ``uncount`` takes the counters off."""
    calls = {"serve_step": 0, "step": 0, "swap_out": 0} if calls is None \
        else calls
    serve_step, step, swap_out = e.serve_step, e._step, e.sched_swap_out

    def count_serve_step(*a, **k):
        toks, done = serve_step(*a, **k)
        calls["serve_step"] += bool(toks)      # a round that decoded
        return toks, done

    def count_step(st):
        calls["step"] += 1
        step(st)

    def count_swap_out(*a):
        calls["swap_out"] += 1
        return swap_out(*a)
    e.serve_step, e._step, e.sched_swap_out = (count_serve_step, count_step,
                                               count_swap_out)
    return calls


def uncount(e) -> None:
    del e.serve_step, e._step, e.sched_swap_out


def sched_replay(dev, model, cp, trace, kv: str, graphs: bool = True):
    """One ``Server.replay`` of ``trace`` on a fresh codebook engine at
    ``CONTENDED_ENGINE_KW`` with ``kv`` pages.  Returns (engine, events,
    streams, report, wall seconds, ``serve_step`` calls that decoded,
    decode steps)."""
    from repro_torch.serving import CONTENDED_ENGINE_KW, Server, ServeEngine
    e = ServeEngine(model, cp, backend="codebook", kv_dtype=kv, device=dev,
                    **CONTENDED_ENGINE_KW)
    e._graphs = graphs
    calls = count_calls(e)
    srv = Server(e)
    rep, secs = timed(lambda: srv.replay(trace))
    uncount(e)
    streams = {h.rid: list(h.tokens) for h in srv.sched.handles.values()}
    return (e, srv.sched.events, streams, rep, secs, calls["serve_step"],
            calls["step"])


def sched_path(dev, cfg, model, cp) -> tuple[dict, dict]:
    """The [sched] phase: phase 5's compressed qwen3-1.7b (the live
    ``model`` and ``cp``, codebook) at the contended engine shape
    ``CONTENDED_ENGINE_KW`` (max_len 48, 2 slots, page 8, 9 pages) under
    ``Server.replay(contended_trace(1, vocab))``: two replays on fresh
    engines with equal events, streams and reports; at least one
    preemption, pages swapped out and in; launches per forward whose
    wrappers ran (7 × 28 codebook_matmul, 28 page_gather) plus one
    page_gather a swap-out; the pool clean and nothing reserved after;
    every stream equal to the same engine shape's uncontended ``serve`` of
    the same requests (rows are independent of the batch: exact); then
    one replay with int8 pages, held the same way.  Wall seconds a replay
    and device→host reads a ``serve_step`` (one a decode step, one after
    the round).  Returns (stats, launches)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import contended_trace
    n_l = cfg.n_layers
    trace = contended_trace(1, cfg.vocab)
    prompts = [r["prompt"] for r in trace]
    stops = [r["max_new"] for r in trace]
    stats, launches, first = {}, {}, None
    for i, kv in enumerate(("bf16", "bf16", "int8")):
        tag = f"[sched] {kv} pages, replay {i}"
        ops.reset_launch_counts()
        e, events, streams, rep, secs, n_ss, n_steps = sched_replay(
            dev, model, cp, trace, kv)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        fwd = called_forwards(e)
        want = {"codebook_matmul": 7 * n_l * fwd,
                "page_gather": n_l * fwd + rep.preemptions}
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts} over {fwd} "
                                 f"forwards and {rep.preemptions} swap-outs, "
                                 f"want {want}")
        if rep.preemptions < 1 or not (rep.pages_swapped_out
                                       and rep.pages_swapped_in):
            raise AssertionError(f"{tag}: not contended: {rep}")
        if e.pool.reserved_extra or not _pool_clean(e.pool):
            raise AssertionError(f"{tag}: pool not clean after the replay")
        if i == 1 and (events, streams, rep.to_json()) != first:
            raise AssertionError(f"{tag}: the second replay differs from "
                                 "the first")
        if i != 1:
            want_t = e.serve(prompts, max_new=stops)
            bad = [rid for rid, p in enumerate(prompts)
                   if p + streams[rid] != want_t[rid]]
            if bad:
                raise AssertionError(f"{tag}: streams of requests {bad} "
                                     "differ from the uncontended serve's")
        if i == 0:
            first = (events, streams, rep.to_json())
        for k_, v in counts.items():
            launches[k_] = launches.get(k_, 0) + v
        stats[f"{kv}_{i}"] = {
            "report": rep.to_json(), "wall_s": secs, "serve_steps": n_ss,
            "decode_steps": n_steps,
            "reads_per_serve_step": (n_steps + n_ss) / n_ss,
            "forwards": fwd, "launches": counts, "replays": e.n_replays,
            "captures": e.n_captures, "swapped_out_pool_refs":
            e.pool.stats.swapped_out_pages}
        log(f"{tag}: {len(trace)} requests, {rep.n_tokens} tokens, "
            f"{rep.preemptions} preemptions, pages swapped out/in "
            f"{rep.pages_swapped_out}/{rep.pages_swapped_in}; admission "
            f"order {rep.admission_order}; wall {secs:.3f} s over {n_ss} "
            f"serve_step calls ({n_steps} decode steps, "
            f"{stats[f'{kv}_{i}']['reads_per_serve_step']:.2f} device→host "
            f"reads a serve_step); launches {counts} over {fwd} forwards "
            f"whose wrappers ran + {rep.preemptions} swap-out gathers; pool "
            f"clean"
            + ("; streams equal the uncontended serve's" if i != 1 else
               "; events, streams and report equal the first replay's"))
        del e
    freed("[sched]")
    return stats, launches


# --- [fleet]: the telemetry registry, the router and the fleet ---------------

def fleet_run(engines: dict, trace, tel=None, drain_at=(), **kw):
    """One ``Fleet.replay`` of ``trace`` over ``engines`` (id → engine),
    with registry ``tel`` (None = the null one) and ``Fleet`` keywords
    ``kw``.  Returns (fleet, record, wall s, calls summed over the
    replicas, as ``count_calls``), where the record is (event digest,
    merged events, streams by fleet request id, report JSON)."""
    from repro_torch.serving import Fleet
    calls = None
    for e in engines.values():
        calls = count_calls(e, calls)
    f = Fleet(engines, telemetry=tel, **kw)
    rep, secs = timed(lambda: f.replay(trace, drain_at=drain_at))
    for e in engines.values():
        uncount(e)
    rec = (f.event_digest(), list(f.events),
           {frid: list(h.tokens) for frid, h in f.handles.items()},
           rep.to_json())
    return f, rec, secs, calls


def telemetry_record(tel) -> tuple:
    """(snapshot JSON without its kernels section, event log JSON,
    Perfetto JSON, the kernels section)."""
    snap = json.loads(tel.snapshot_json())
    kern = snap.pop("kernels")
    return (json.dumps(snap, sort_keys=True, separators=(",", ":")),
            tel.event_log_json(), json.dumps(tel.to_perfetto(),
                                             sort_keys=True), kern)


def fleet_reduced(dev) -> dict:
    """[fleet] (a): the reduced 2-layer qwen3 of ``reduced_spec_model``
    (f32, |W| = 256, codebook), 2 replicas at ``CONTENDED_ENGINE_KW`` with
    one ``Telemetry``, replaying ``contended_trace(1, vocab)`` on the card
    and on the CPU: event digest, events, streams, report, snapshot, event
    log and Perfetto JSON equal; the kernels section (on the card the
    launches since attach, on the CPU none) equal to the launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.serving import (CONTENDED_ENGINE_KW, ServeEngine,
                                     Telemetry, contended_trace)
    model, params = reduced_spec_model(dev)
    trace = contended_trace(1, model.cfg.vocab)
    got, out = {}, {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        ops.reset_launch_counts()
        tel = Telemetry()
        f, rec, secs, calls = fleet_run(
            {r: ServeEngine(model, params[where]["index"], backend="codebook",
                            device=device, **CONTENDED_ENGINE_KW)
             for r in ("r0", "r1")}, trace, tel)
        *trec, kern = telemetry_record(tel)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        if kern != {f"launch.{k}": v for k, v in counts.items()}:
            raise AssertionError(f"[fleet] reduced, {where}: kernels section "
                                 f"{kern} != launches {counts}")
        fwd = sum(called_forwards(s.engine) for s in f.replicas.values())
        want = ({"codebook_matmul": 7 * model.cfg.n_layers * fwd,
                 "page_gather": model.cfg.n_layers * fwd + calls["swap_out"]}
                if where == "card" else {})
        if counts != want:
            raise AssertionError(f"[fleet] reduced, {where}: launches "
                                 f"{counts}, want {want}")
        got[where] = (rec, trec)
        out[where] = {"wall_s": secs, "launches": counts,
                      "preemptions": rec[3]["preemptions"]}
        del f, tel                # the registry's providers hold the pools
    if got["card"] != got["cpu"]:
        parts = ("digest", "events", "streams", "report")
        bad = [n for n, a, b in zip(parts, got["card"][0], got["cpu"][0])
               if a != b] + [n for n, a, b in zip(
                   ("snapshot", "event log", "perfetto"), got["card"][1],
                   got["cpu"][1]) if a != b]
        raise AssertionError(f"[fleet] reduced: card and CPU differ in {bad}")
    log(f"[fleet] reduced 2-layer qwen3 (f32, codebook), 2 replicas at the "
        f"contended shape, contended_trace(1): event digest "
        f"{got['card'][0][0][:16]}…, events, streams, report, snapshot, "
        f"event log and Perfetto JSON (kernels section aside) on the card "
        f"equal the CPU's; {got['card'][0][3]['preemptions']} preemptions; "
        f"card launches {out['card']['launches']} = the kernels section; "
        f"wall card {out['card']['wall_s']:.3f} s, CPU "
        f"{out['cpu']['wall_s']:.3f} s")
    freed("[fleet] reduced")
    return out


def fleet_path(dev, cfg, model, cp) -> tuple[dict, dict]:
    """The [fleet] phase.  (a) ``fleet_reduced``.  (b) Phase 5's compressed
    qwen3-1.7b (the live ``model`` and ``cp``, codebook, bf16 pages) at
    ``CONTENDED_ENGINE_KW``, each fleet built fresh and freed before the
    next:

    * drain migration: ``poisson_trace(7, 10, rate 80)`` on 2 replicas with
      ``migrate_on_drain`` and r0 drained at 0.08 s, run as r0, r1 and as
      r1, r0 (null registry), then r0, r1 with a ``Telemetry``: equal
      digests, events, streams and reports, at least one request and one
      page migrated, every stream equal to one ``Server.replay``'s of the
      trace, equal ``serve_step`` calls, decode steps and swap-outs (so
      equal device→host reads a ``serve_step``: the registry adds no
      device read); the registry's ``rN.sched.*`` and ``fleet.*`` counters
      against the report, its kernels section against the launches, and
      its summary logged;
    * the shared tier: two requests sharing a two-page system prompt,
      round robin, without and with ``shared_prefix_tier``: equal tokens,
      at least 2 tier hits, fewer pages materialized with the tier; the
      tier's capture (``register_prefill``, one blocking copy a page a
      plane) timed between synchronizations.

    Every fleet: launches summed over the replicas = 7 × L codebook_matmul
    and L page_gather a forward whose wrappers ran, plus one page_gather a
    swap-out (preemptions, and migrations of running requests); every
    pool clean and nothing reserved.  Returns (stats, launches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import (CONTENDED_ENGINE_KW, Server,
                                     ServeEngine, Telemetry, poisson_trace)
    n_l = cfg.n_layers
    stats, launches = {"reduced": fleet_reduced(dev)}, {}

    def engines(order):
        return {r: ServeEngine(model, cp, backend="codebook", device=dev,
                               **CONTENDED_ENGINE_KW) for r in order}

    def checked(tag, f, calls) -> tuple[dict, int]:
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        fwd = sum(called_forwards(s.engine) for s in f.replicas.values())
        want = {"codebook_matmul": 7 * n_l * fwd,
                "page_gather": n_l * fwd + calls["swap_out"]}
        if counts != want:
            raise AssertionError(f"{tag}: launches {counts} over {fwd} "
                                 f"forwards and {calls['swap_out']} "
                                 f"swap-outs, want {want}")
        pre = f.report().preemptions
        if not pre <= calls["swap_out"] <= pre + f.n_migrated:
            raise AssertionError(f"{tag}: {calls['swap_out']} swap-outs for "
                                 f"{pre} preemptions and {f.n_migrated} "
                                 "migrations")
        for r, s in f.replicas.items():
            if s.engine.pool.reserved_extra or not _pool_clean(s.engine.pool):
                raise AssertionError(f"{tag}: {r}'s pool not clean")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return counts, fwd

    # drain migration, against one server's replay
    trace = poisson_trace(7, 10, rate=80.0, vocab=cfg.vocab, plen=(2, 9),
                          max_new=(6, 10))
    srv = Server(ServeEngine(model, cp, backend="codebook", device=dev,
                             **CONTENDED_ENGINE_KW))
    _, secs = timed(lambda: srv.replay(trace))
    want = {rid: list(h.tokens) for rid, h in srv.sched.handles.items()}
    stats["server_wall_s"] = secs
    del srv
    freed("[fleet] server")
    first = None
    for i, (order, on) in enumerate(((["r0", "r1"], False),
                                     (["r1", "r0"], False),
                                     (["r0", "r1"], True))):
        tag = (f"[fleet] migration {','.join(order)}, "
               + ("telemetry" if on else "null registry"))
        ops.reset_launch_counts()
        tel = Telemetry() if on else None
        f, rec, secs, calls = fleet_run(engines(order), trace, tel,
                                        migrate_on_drain=True,
                                        drain_at=[(0.08, "r0")])
        counts, fwd = checked(tag, f, calls)
        if f.n_migrated < 1 or f.n_migrated_pages < 1:
            raise AssertionError(f"{tag}: nothing migrated ({f.n_migrated} "
                                 f"requests, {f.n_migrated_pages} pages)")
        if rec[2] != want:
            bad = [k for k in want if rec[2].get(k) != want[k]]
            raise AssertionError(f"{tag}: streams of requests {bad} differ "
                                 "from the server's replay")
        if first is None:
            first = (rec, calls)
        elif (rec, calls) != first:
            bad = [n for n, a, b in zip(("digest", "events", "streams",
                                         "report"), rec, first[0]) if a != b]
            raise AssertionError(f"{tag}: differs from the first run in "
                                 f"{bad}, calls {calls} vs {first[1]}")
        rep = f.report()
        res = {"wall_s": secs, "launches": counts, "forwards": fwd,
               "calls": calls, "migrated": f.n_migrated,
               "migrated_pages": f.n_migrated_pages,
               "reads_per_serve_step": (calls["step"] + calls["serve_step"])
               / calls["serve_step"], "report": rep.to_json()}
        if tel is not None:
            *_, kern = telemetry_record(tel)
            if kern != {f"launch.{k}": v for k, v in counts.items()}:
                raise AssertionError(f"{tag}: kernels section {kern} != "
                                     f"launches {counts}")
            c = tel.snapshot()["counters"]
            sums = {k: sum(c.get(f"{r}.sched.{k}", 0) for r in f.replicas)
                    for k in ("preemptions", "pages_swapped_out",
                              "pages_swapped_in", "finished")}
            have = {"preemptions": rep.preemptions,
                    "pages_swapped_out": rep.pages_swapped_out,
                    "pages_swapped_in": rep.pages_swapped_in,
                    "finished": rep.n_requests}
            if sums != have or c.get("fleet.migrated") != f.n_migrated \
                    or c.get("fleet.routed") != len(trace) + f.n_migrated:
                raise AssertionError(f"{tag}: counters {c} disagree with "
                                     f"the report {have}")
            for line in tel.summary().splitlines():
                log(f"{tag}: {line}")
            log(f"{tag}: [telemetry] " + ", ".join(
                f"{k}={v}" for k, v in sorted(c.items())
                if k.startswith("fleet.") or ".sched." in k))
        stats[f"migration_{i}"] = res
        log(f"{tag}: {len(trace)} requests, {rep.n_tokens} tokens, "
            f"{f.n_migrated} migrated ({f.n_migrated_pages} pages), "
            f"{rep.preemptions} preemptions, {calls['swap_out']} swap-outs; "
            f"digest {rec[0][:16]}…; wall {secs:.3f} s; "
            f"{calls['serve_step']} serve_step calls, {calls['step']} decode "
            f"steps ({res['reads_per_serve_step']:.2f} device→host reads a "
            f"serve_step); launches {counts} over {fwd} forwards whose "
            f"wrappers ran; pools clean; streams equal the server's"
            + ("" if i == 0 else "; digest, events, streams, report and "
               "calls equal the first run's"))
        del f, tel                # the registry's providers hold the pools
        freed(tag)

    # the shared prefix tier
    page = CONTENDED_ENGINE_KW["page_size"]
    sys_prompt = list(range(1, 2 * page + 1))
    ttrace = [{"arrival": 0.0, "prompt": sys_prompt + [5, 6], "max_new": 4},
              {"arrival": 0.4, "prompt": sys_prompt + [9], "max_new": 4}]
    tier_runs = {}
    for tier in (False, True):
        tag = f"[fleet] shared tier {'on' if tier else 'off'}"
        ops.reset_launch_counts()
        eng = engines(["r0", "r1"])
        capture = {"s": 0.0, "calls": 0}
        for r in eng:
            time_register(eng[r].pool, capture)
        f, rec, secs, calls = fleet_run(eng, ttrace, policy="round_robin",
                                        shared_prefix_tier=tier)
        counts, fwd = checked(tag, f, calls)
        ts = f.shared_tier_stats()
        res = {"wall_s": secs, "launches": counts, "forwards": fwd,
               "materialized_pages": f.materialized_pages(),
               "tier": ts, "register_prefill_s": capture["s"],
               "register_prefill_calls": capture["calls"]}
        if tier:
            planes = len(eng["r0"].pool.cache)
            res["capture_ms_per_page_plane"] = (
                1e3 * capture["s"] / (ts["puts"] * planes))
        tier_runs[tier] = (rec, res)
        stats[f"tier_{'on' if tier else 'off'}"] = res
        log(f"{tag}: wall {secs:.3f} s; materialized pages "
            f"{res['materialized_pages']}; tier {ts}; register_prefill "
            f"{capture['calls']} calls, {1e3 * capture['s']:.3f} ms in all"
            + (f" ({res['capture_ms_per_page_plane']:.3f} ms a page a "
               f"plane over {ts['puts']} pages × {planes} planes)"
               if tier else "") + f"; launches {counts} over {fwd} forwards "
            "whose wrappers ran; pools clean")
        del f, eng
        freed(tag)
    (off, r_off), (on, r_on) = tier_runs[False], tier_runs[True]
    if on[2] != off[2]:
        raise AssertionError(f"[fleet] shared tier: tokens {on[2]} != "
                             f"{off[2]} without the tier")
    if r_on["tier"]["hits"] < 2 or not (r_on["materialized_pages"]
                                        < r_off["materialized_pages"]):
        raise AssertionError(f"[fleet] shared tier: {r_on['tier']} hits, "
                             f"{r_on['materialized_pages']} pages "
                             f"materialized against {r_off['materialized_pages']}")
    log(f"[fleet] shared tier: tokens equal with and without it, "
        f"{r_on['tier']['hits']} tier hits, {r_on['materialized_pages']} "
        f"pages materialized against {r_off['materialized_pages']}")
    stats["reserved_after_gib"] = freed("[fleet]")
    return stats, launches


# --- [probes]: the numerics probes -----------------------------------------------

PROBE_REPLAYS = 20               # replayed decode steps a timing turn


def probes_model():
    """``tests/test_probes.py``'s reduced qwen3 built by the port: 2 layers,
    f32, k-means |W| = 256 (int8 ids, every matrix of 256 values or more
    in index form), clustered on the CPU.  Returns (model, the same at
    ``act_levels`` 32, {"dense" | "index": params on the CPU})."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import (WeightQuantConfig,
                                            cluster_params, init_state)
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import to_codebook_params
    cfg = configs.get("qwen3-1.7b").reduced().replace(n_layers=2)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    wq = WeightQuantConfig(num_weights=256, method="kmeans")
    pq, st = cluster_params(params, wq, init_state(wq), 200)
    cp = to_codebook_params(pq, wq, st, min_size=256)
    return (model, build(cfg.replace(act_levels=32)),
            {"dense": params, "index": cp})


def probes_reduced(dev) -> dict:
    """[probes] (a): the reduced model of ``probes_model`` on the card (the
    graph route) and on the CPU, in this process.  ``run_golden_scenarios``
    (6 scenarios: dense, codebook, lut × contiguous, int8 pages) with
    probes on and off: tokens equal on and off, and on the card and the
    CPU; ``tokens``, ``matmul_calls``, ``act_total``, ``page_oob`` and the
    ``widx_*`` counts equal on both; the card within the reference's
    sentinel slack of the CPU (``sentinel_check(card,
    golden_entry(cpu))``); lut headroom > 0 bits in every layer.  Then at
    ``act_levels`` 32 on codebook and lut (contiguous): ``act_sat`` > 0,
    the card within the slack of the CPU, tokens equal probes off, and the
    launches a forward whose wrappers ran: with probes the codebook FFN
    takes the unfused chain (7 × L codebook_matmul and L act_quant), without
    them the gated launch (5 × L and L codebook_swiglu).  Returns (the
    figures, the launches on the card)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeEngine
    from repro_torch.serving import probes as nprobes
    model, model32, cpu = probes_model()
    card = _to(cpu, dev)
    L_ = model.cfg.n_layers
    exact = ("tokens", "matmul_calls", "act_total", "page_oob", "widx_neg",
             "widx_oob", "widx_total")
    toks, nums, secs, launches = {}, {}, {}, {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    ops.reset_launch_counts()
    for where, device, p in (("card", dev, card), ("cpu", "cpu", cpu)):
        on, off = {}, {}
        nums[where], secs[where] = timed(
            lambda: nprobes.run_golden_scenarios(
                model, p["dense"], p["index"], device=device, tokens=on))
        nprobes.run_golden_scenarios(model, p["dense"], p["index"],
                                     device=device, probes=False, tokens=off)
        if on != off:
            raise AssertionError(f"[probes] reduced, {where}: probes changed "
                                 "the tokens of "
                                 f"{[n for n in on if on[n] != off[n]]}")
        toks[where] = on
    add(ops.launch_counts())
    if toks["card"] != toks["cpu"]:
        raise AssertionError("[probes] reduced: card tokens differ from the "
                             "CPU's in " + str([n for n in toks["cpu"] if
                                                toks["card"][n]
                                                != toks["cpu"][n]]))
    for name in nprobes.GOLDEN_SCENARIOS:
        c, h = nums["card"][name], nums["cpu"][name]
        bad = [k for k in exact if c[k] != h[k]]
        fails = nprobes.sentinel_check(c, nprobes.golden_entry(h))
        if bad or fails:
            raise AssertionError(f"[probes] reduced {name}: card differs "
                                 f"from the CPU in {bad}; sentinels {fails}")
        if name.startswith("lut") and not min(c["headroom_bits"]) > 0.0:
            raise AssertionError(f"[probes] reduced {name}: headroom "
                                 f"{c['headroom_bits']}")
    out = {"scenarios_s": secs, "audit": {k: nums["card"]["lut/paged"][k]
                                          for k in exact[-3:]}}
    for name in ("lut/contig", "lut/paged", "codebook/paged"):
        n = nums["card"][name]
        out[name] = {"headroom_bits_min": min(n["headroom_bits"]),
                     "kv_err_max": max(n["kv_err_max"]),
                     "acc_max": n["acc_max"]}
    log(f"[probes] reduced 2-layer qwen3 (f32, k-means |W| 256, int8 ids), "
        f"the 6 golden scenarios on the card (graph route, "
        f"{secs['card']:.2f} s) and the CPU ({secs['cpu']:.2f} s): tokens "
        "equal with probes on and off and on both; tokens, matmul_calls, "
        "act_total, page_oob, widx_* equal; the card within the sentinel "
        "slack of the CPU; audit " + json.dumps(out["audit"]) + "; lut "
        "headroom min contiguous "
        f"{out['lut/contig']['headroom_bits_min']:.2f} / int8 pages "
        f"{out['lut/paged']['headroom_bits_min']:.2f} bits (card), kv_err_max "
        f"{out['lut/paged']['kv_err_max']:.4e} (lut) "
        f"{out['codebook/paged']['kv_err_max']:.4e} (codebook)")

    kw = dict(max_len=48, max_batch=2)
    prompts, max_new = nprobes.GOLDEN_PROMPTS, nprobes.GOLDEN_MAX_NEW
    for be in ("codebook", "lut"):
        got = {}
        for probes in (False, True):
            ops.reset_launch_counts()
            e = ServeEngine(model32, card["index"], backend=be, device=dev,
                            probes=probes, **kw)
            t_ = e.serve(prompts, max_new=max_new)
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            if be == "lut":
                per_fwd = {"lut_matmul": 7 * L_, "act_quant": L_}
            elif probes:                     # the unfused chain
                per_fwd = {"codebook_matmul": 7 * L_, "act_quant": L_}
            else:                            # the gated launch
                per_fwd = {"codebook_matmul": 5 * L_, "codebook_swiglu": L_}
            check_launches(f"[probes] reduced act_levels 32, {be}, probes "
                           f"{'on' if probes else 'off'}", counts, per_fwd,
                           called_forwards(e))
            add(counts)
            got[probes] = (t_, e.numerics(), counts)
        num = got[True][1]
        h = ServeEngine(model32, cpu["index"], backend=be, device="cpu",
                        probes=True, **kw)
        if h.serve(prompts, max_new=max_new) != got[True][0] \
                or got[True][0] != got[False][0]:
            raise AssertionError(f"[probes] reduced act_levels 32, {be}: "
                                 "tokens differ (on, off, CPU)")
        hn = h.numerics()
        fails = nprobes.sentinel_check(num, nprobes.golden_entry(hn))
        bad = [k for k in exact if num[k] != hn[k]]
        if not min(num["act_sat"]) > 0.0 or fails or bad:
            raise AssertionError(f"[probes] reduced act_levels 32, {be}: "
                                 f"act_sat {num['act_sat']}, sentinels "
                                 f"{fails}, differs from the CPU in {bad}")
        out[f"act32_{be}"] = {"sat_rate": num["sat_rate"],
                              "cpu_sat_rate": hn["sat_rate"],
                              "launches": {str(k): v[2]
                                           for k, v in got.items()}}
        log(f"[probes] reduced at act_levels 32, {be}: sat_rate "
            f"{[round(s, 4) for s in num['sat_rate']]} (CPU "
            f"{[round(s, 4) for s in hn['sat_rate']]}); tokens equal probes "
            f"off and the CPU's; launches with probes {got[True][2]}, "
            f"without {got[False][2]}")
    freed("[probes] reduced")
    return out, launches


def count_syncs(e) -> dict:
    """Count, on engine ``e``, the decode steps and the synchronizing CUDA
    operations inside them (``torch.cuda.set_sync_debug_mode("warn")``
    warns at each: a device→host read, a blocking copy), by the line that
    made them.  Returns the counters; ``del e._step`` takes the counting
    off."""
    import warnings
    import torch
    calls = {"step": 0, "syncs": 0, "sites": {}}
    step = e._step

    def counted(st):
        calls["step"] += 1
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                step(st)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        for w in caught:     # (the mode's first switch also warns, once)
            if "called a synchronizing CUDA operation" in str(w.message):
                calls["syncs"] += 1
                site = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
                calls["sites"][site] = calls["sites"].get(site, 0) + 1
    e._step = counted
    return calls


def replay_ms(graph, n: int = PROBE_REPLAYS) -> float:
    """Median device ms of ``n`` replays of ``graph``, each between two
    CUDA events."""
    import torch
    ms = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
    return sorted(ms)[n // 2]


def probes_path(dev, cfg, model, cp, prompts) -> tuple[dict, dict]:
    """The [probes] phase.  (a) ``probes_reduced``.  (b) Phase 5's
    compressed qwen3-1.7b (the live ``model`` and ``cp``: 28 layers, d
    2048, vocab 151936, bf16, tied, |W| 1000, int16 ids) in two
    configurations, lut on int8 pages (page 16, no prefix cache, so that
    every serve of the same requests computes the same prefill) and
    codebook on the contiguous bf16 cache, each with an engine without and
    one with probes, MAX_BATCH slots, 4 requests × 16 new tokens:

    * tokens of both engines' graph-route serves equal;
    * the probes engine served again on the eager route after
      ``reset_probes()``: tokens equal, ``numerics()`` JSON byte-equal to
      the graph serve's; then reset and served on the graph route again:
      byte-equal once more, every probe buffer at its first address;
    * launches a forward whose wrappers ran equal with probes on and off
      (7 × 28 lut_matmul + 28 page_gather, or 7 × 28 codebook_matmul), and
      the synchronizing operations a decode step on the eager route
      (``count_syncs``) equal, one a step (the step's read);
    * lut: headroom > 0 bits in all 28 layers (the run-time check of
      ``make_lut_spec``'s no-overflow scale at full width); page_oob 0,
      widx_oob 0, and on int8 pages kv_err_max > 0 in every layer;
    * the replayed decode step with and without probes (``replay_ms``, in
      turns), and the worst-layer summary (``Telemetry.summary()``'s
      numerics line).

    Both engines of a configuration are dropped before the next is built.
    Returns (stats, launches)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeEngine, Telemetry
    t0 = time.time()
    stats, launches = {}, {}
    stats["reduced"], red = probes_reduced(dev)
    n_l = cfg.n_layers
    reqs = prompts[:4]
    for key, be, kw, per_fwd in (
            ("lut_int8_pages", "lut",
             dict(paged=True, kv_dtype="int8", page_size=PAGE,
                  prefix_cache=False),
             {"lut_matmul": 7 * n_l, "page_gather": n_l}),
            ("codebook_contiguous", "codebook", {},
             {"codebook_matmul": 7 * n_l})):
        tag = f"[probes] {be}, " + ("int8 pages" if kw else
                                    "contiguous bf16 cache")
        ops.reset_launch_counts()

        def serve(e, route: str):
            """``e.serve(reqs)`` on ``route``, timed; its launches held to
            ``per_fwd`` a forward whose wrappers ran.  Returns (tokens,
            seconds, launches)."""
            c0, f0 = ops.launch_counts(), called_forwards(e)
            e._graphs = route == "graph"
            toks, secs = timed(lambda: e.serve(reqs, max_new=16))
            e._graphs = True
            counts = {k: v - c0[k] for k, v in ops.launch_counts().items()
                      if v - c0[k]}
            check_launches(f"{tag}, probes {'on' if e.probes else 'off'}, "
                           f"{route}", counts, per_fwd,
                           called_forwards(e) - f0)
            return toks, secs, counts

        eng, res = {}, {}
        for probes in (False, True):
            e = eng[probes] = ServeEngine(
                model, cp, backend=be, max_len=128, max_batch=MAX_BATCH,
                device=dev, probes=probes, **kw)
            toks, secs, counts = serve(e, "graph")
            res[probes] = {"tokens": toks, "graph_serve_s": secs,
                           "launches": counts,
                           "forwards": called_forwards(e)}
        on, off = eng[True], eng[False]
        first = json.dumps(on.numerics(), sort_keys=True)
        if res[True]["tokens"] != res[False]["tokens"]:
            raise AssertionError(f"{tag}: tokens differ with probes on")
        ptrs = {k: v.data_ptr() for k, v in on._ps.items()}
        reads = {}
        for probes, e in ((True, on), (False, off)):
            e.reset_probes()
            calls = count_syncs(e)
            toks, secs, _ = serve(e, "eager")
            del e._step
            reads[probes] = calls["syncs"] / calls["step"]
            res[probes].update(eager_serve_s=secs, eager_steps=calls["step"],
                               syncs_per_step=reads[probes],
                               sync_sites=calls["sites"])
            if toks != res[probes]["tokens"]:
                raise AssertionError(f"{tag}: eager tokens differ from the "
                                     "graph route's")
        eager = json.dumps(on.numerics(), sort_keys=True)
        if eager != first:
            raise AssertionError(f"{tag}: eager numerics {eager} != graph "
                                 f"numerics {first}")
        if reads[True] != reads[False] or not reads[True] >= 1.0:
            raise AssertionError(f"{tag}: synchronizing operations a step "
                                 f"{reads} (probes on, off), by site "
                                 f"{res[True]['sync_sites']}, "
                                 f"{res[False]['sync_sites']}")
        on.reset_probes()
        toks, _, _ = serve(on, "graph")
        if toks != res[True]["tokens"] or json.dumps(
                on.numerics(), sort_keys=True) != first:
            raise AssertionError(f"{tag}: after reset_probes the graph "
                                 "serve differs from the first")
        if {k: v.data_ptr() for k, v in on._ps.items()} != ptrs:
            raise AssertionError(f"{tag}: a probe buffer moved")
        num = json.loads(first)
        if num["page_oob"] != 0.0 or num["widx_oob"] != 0:
            raise AssertionError(f"{tag}: page_oob {num['page_oob']}, "
                                 f"widx_oob {num['widx_oob']}")
        if be == "lut" and not (len(num["headroom_bits"]) == n_l
                                and min(num["headroom_bits"]) > 0.0):
            raise AssertionError(f"{tag}: headroom {num['headroom_bits']}")
        if kw and not min(num["kv_err_max"]) > 0.0:
            raise AssertionError(f"{tag}: kv_err_max {num['kv_err_max']}")
        for k, v in ops.launch_counts().items():
            if v:
                launches[k] = launches.get(k, 0) + v
        # the replayed step: each engine's serve graph, in turns
        graphs = {p: next(iter(e._slot_sets.values())).graphs["step"][0]
                  for p, e in eng.items()}
        turns = {False: [], True: []}
        for p in (False, True, True, False):
            turns[p].append(replay_ms(graphs[p]))
        step = {("on" if p else "off"): sum(v) / len(v)
                for p, v in turns.items()}
        tel = Telemetry()
        tel.add_provider("numerics", lambda: num)
        line = next(ln for ln in tel.summary().splitlines()
                    if "numerics" in ln)
        stats[key] = {
            "step_ms": step, "step_ms_turns": {("on" if p else "off"): v
                                               for p, v in turns.items()},
            "syncs_per_step": reads[True],
            "launches": {("on" if p else "off"): v["launches"]
                         for p, v in res.items()},
            "forwards": {("on" if p else "off"): v["forwards"]
                         for p, v in res.items()},
            "serve_s": {("on" if p else "off"): (v["graph_serve_s"],
                                                 v["eager_serve_s"])
                        for p, v in res.items()},
            "headroom_bits": num["headroom_bits"],
            "headroom_bits_min": min(num["headroom_bits"]),
            "sat_rate_max": max(num["sat_rate"]),
            "kv_err_max": max(num["kv_err_max"]),
            "acc_max_max": max(num["acc_max"]), "tokens": num["tokens"],
            "matmul_calls": num["matmul_calls"],
            "widx": {k: num[k] for k in ("widx_neg", "widx_oob",
                                         "widx_total")}}
        log(f"{tag}: 4 requests × 16 tokens, tokens equal with probes on "
            f"and off and on each route; numerics of the graph serve = the "
            f"eager serve's = after reset_probes, byte for byte, buffers "
            f"unmoved; launches a forward whose wrappers ran {per_fwd} with "
            f"and without probes (graph serves: {res[True]['launches']} over "
            f"{res[True]['forwards']} forwards, {res[False]['launches']} over "
            f"{res[False]['forwards']}); {reads[True]:.2f} synchronizing "
            f"operations an eager decode step either way; replayed decode "
            f"step (median of {PROBE_REPLAYS}, turns off, on, on, off) off "
            f"{step['off']:.3f} ms, on {step['on']:.3f} ms "
            f"({100 * (step['on'] / step['off'] - 1):+.1f} %); headroom min "
            f"{min(num['headroom_bits']):.2f} bits, acc_max max "
            f"{max(num['acc_max']):.0f}, matmul_calls a layer "
            f"{num['matmul_calls'][0]:.0f}; sat_rate max "
            f"{max(num['sat_rate']):.3e}")
        log(f"{tag}: {line}")
        del eng, on, off, e, graphs, tel, serve
        freed(tag)
    for k, v in red.items():
        launches[k] = launches.get(k, 0) + v
    stats["phase_s"] = time.time() - t0
    log(f"[probes] phase {stats['phase_s']:.1f} s")
    return stats, launches


# --- [launch]: the serving launcher ------------------------------------------

LAUNCH_N, LAUNCH_PLEN, LAUNCH_NEW = 8, 8, 16     # (a)'s requests
LAUNCH_BATCH = ("--arch qwen3-1.7b --compress --backend codebook "
                f"--requests {LAUNCH_N} --max-batch {MAX_BATCH} "
                f"--max-new {LAUNCH_NEW}")
LAUNCH_SERVER = ("--arch qwen3-1.7b --compress --backend codebook --server "
                 "--paged --kv-dtype int8 --traffic poisson --rate 40 "
                 f"--requests 16 --max-batch {MAX_BATCH} --priority-levels 2")
# (c): the reduced qwen3, card against CPU; {dir} is a scratch directory
LAUNCH_REDUCED = {
    "lut_int8_probes": "--compress --backend lut --paged --kv-dtype int8 "
                       "--probes --numerics-out {dir}/numerics.json "
                       "--requests 4 --max-new 8",
    "spec_ngram": "--spec-draft ngram --requests 4 --max-new 12",
    "uniform": "--uniform --requests 4 --max-new 8",
    "fleet": "--server --paged --replicas 3 --drain-at 0.3:r0 "
             "--migrate-on-drain --shared-prefix-tier --shed-policy slo "
             "--metrics-out {dir}/metrics.json --requests 12 --rate 120",
}
LAUNCH_WALL = r"in \d+\.\d+s|\d+\.\d+ tok/s|\d+\.\d+ ms/request"


def launch_prompts(vocab: int) -> list:
    """The batch launcher's requests at ``--seed 0``, drawn as it draws
    them."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, vocab, LAUNCH_PLEN)]
            for _ in range(LAUNCH_N)]


def launch_reference(dev, cfg, model, cp) -> list:
    """Phase 5's codebook engine, shaped as the batch launcher shapes its
    own (max_len prompt + max_new + 8), serving the launcher's requests
    as it does: a first serve (captures), then the serve it reports.
    Returns the reported serve's rows, which the first must equal."""
    from repro_torch.serving import ServeEngine
    e = ServeEngine(model, cp, max_len=LAUNCH_PLEN + LAUNCH_NEW + 8,
                    backend="codebook", max_batch=MAX_BATCH, device=dev)
    prompts = launch_prompts(cfg.vocab)
    first = e.serve(prompts, max_new=LAUNCH_NEW)
    outs = e.serve(prompts, max_new=LAUNCH_NEW)
    if outs != first:
        raise AssertionError("[launch] phase 5's codebook engine served the "
                             "launcher's requests differently twice")
    del e
    freed("[launch] phase 5's codebook engine on the launcher's requests")
    return outs


def run_launcher(argv: list, init=None) -> tuple:
    """``repro_torch.launch.serve.main(argv)`` in this process, its stdout
    captured (and logged line by line), with ``init`` in place of its
    ``init_params`` when given.  Returns (stdout lines, the engines and
    the servers it built).  A ``SystemExit`` fails the run."""
    import io
    from repro_torch.launch import serve as TS
    from repro_torch.serving import server as srv_mod

    engines, servers = [], []
    orig = (TS.ServeEngine, srv_mod.Server, TS.init_params)

    def engine(*a, **k):
        engines.append(orig[0](*a, **k))
        return engines[-1]

    class Server(orig[1]):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            servers.append(self)

    TS.ServeEngine, srv_mod.Server = engine, Server
    if init is not None:
        TS.init_params = init
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            TS.main(list(argv))
    except SystemExit as ex:
        raise AssertionError(f"[launch] {' '.join(argv)}: exited "
                             f"{ex.code!r}") from ex
    finally:
        TS.ServeEngine, srv_mod.Server, TS.init_params = orig
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"[launch]   | {ln}")
    return lines, engines, servers


def launch_line(lines: list, tag: str) -> str:
    found = [ln for ln in lines if ln.startswith(tag + " ")]
    if not found:
        raise AssertionError(f"[launch] no {tag} line in {lines}")
    return found[0]


def launch_sample(lines: list) -> tuple:
    """(prompt, tokens) of the ``sample:`` line."""
    import ast
    p, t = launch_line(lines, "sample:")[len("sample: "):].split(" -> ")
    return ast.literal_eval(p), ast.literal_eval(t)


def launch_memory(lines: list, cp_tree, cfg) -> dict:
    """The ``[memory]`` row against a reckoning from the index-form tree
    the launcher served (every clustered leaf: the ids of the matrices,
    the dense leaves the norms keep): params, fp32 and packed megabytes,
    the KV slab and int8 pages; packed under one third of fp32."""
    import re
    from repro_torch.core.export import kv_cache_bytes
    row = launch_line(lines, "[memory]")
    n = sum(int(t.numel()) for path, t in _paths(cp_tree)
            if path[-1] not in ("codebook", "lut_table"))
    table = (32 + 1) * (N_BOOK + 1) * 4 + 4 * 32 * 4 + N_BOOK * 4
    packed = (n * 10 + 7) // 8 + table
    kv_fp = kv_cache_bytes(cfg.n_layers, cfg.n_kv, cfg.hd,
                           MAX_BATCH * (LAUNCH_PLEN + LAUNCH_NEW + 8),
                           dtype_bytes=4 if cfg.dtype == "float32" else 2)
    kv_pk = min(LAUNCH_N, MAX_BATCH) * kv_cache_bytes(
        cfg.n_layers, cfg.n_kv, cfg.hd, LAUNCH_PLEN + LAUNCH_NEW, quant=True,
        page_size=PAGE)
    want = (f"params={n} |W|={N_BOOK} |A|=32 fp32={4 * n / 1e6:.2f}MB "
            f"packed={packed / 1e6:.2f}MB ({100 * (1 - packed / (4 * n)):.1f}"
            "% saved)")
    if not row.startswith(f"[memory] {want}"):
        raise AssertionError(f"[launch] {row!r}: want {want!r} first")
    dep = (f"deployed(w+kv)={(4 * n + kv_fp) / 1e6:.2f}MB->"
           f"{(packed + kv_pk) / 1e6:.2f}MB")
    if dep not in row:
        raise AssertionError(f"[launch] {row!r}: want {dep!r}")
    fp32_mb, packed_mb = (float(x) for x in re.findall(
        r"fp32=([\d.]+)MB packed=([\d.]+)MB", row)[0])
    if not packed_mb < fp32_mb / 3:
        raise AssertionError(f"[launch] packed {packed_mb} MB is not under "
                             f"a third of fp32 {fp32_mb} MB")
    return {"row": row, "n_params": n, "packed_bytes": packed,
            "fp32_bytes": 4 * n, "kv_fp_bytes": kv_fp,
            "kv_packed_bytes": kv_pk, "packed_share": packed / (4 * n)}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def launch_wall(line: str) -> dict:
    """The wall figures of a ``[serve]`` or ``[server]`` line."""
    import re
    out = {"s": float(re.search(r"in (\d+\.\d+)s", line).group(1)),
           "tok_s": float(re.search(r"(\d+\.\d+) tok/s", line).group(1))}
    ms = re.search(r"(\d+\.\d+) ms/request", line)
    if ms:
        out["ms_request"] = float(ms.group(1))
    return out


def launch_masked(lines: list, out_dir: str) -> list:
    """Lines with the wall-clock figures, the device word, the KV errors
    and the output directory masked; the kernels summary line dropped
    (the card counts launches, the CPU's plain versions none), and with
    it the line a registry prints when that was all it had."""
    import re
    out = []
    for ln in lines:
        if ln.startswith(("[telemetry] kernels:",
                          "[telemetry] nothing recorded")):
            continue
        ln = re.sub(r"tok/s on (cpu|cuda),", "tok/s on <dev>,",
                    ln.replace(out_dir, "<dir>"))
        ln = re.sub(LAUNCH_WALL, "<wall>", ln)
        out.append(re.sub(r"kv err max \S+|kv round-trip err \S+", "<kv>",
                          ln))
    return out


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def launch_reduced() -> tuple:
    """(c): the reduced qwen3 (2 layers, f32) through the launcher on the
    card and with ``--device cpu``, with CPU-drawn weights on both: the
    lines equal once the wall figures are masked; the numerics JSON's
    structural fields equal and its KV errors within the sentinel slack;
    the fleet's metrics snapshot equal without its kernels section.
    Returns ({case: seconds on the card}, launches on the card)."""
    import tempfile
    import torch
    from repro_torch.kernels import ops

    def init(model, device):
        return _to(model.init(torch.Generator().manual_seed(0), "cpu"),
                   device)

    secs, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="launch_") as tmp:
        for case, flags in LAUNCH_REDUCED.items():
            outs = {}
            for side in ("cuda", "cpu"):
                d = os.path.join(tmp, f"{case}_{side}")
                os.mkdir(d)
                argv = (["--arch", "qwen3-1.7b", "--reduced"]
                        + flags.format(dir=d).split()
                        + (["--device", "cpu"] if side == "cpu" else []))
                ops.reset_launch_counts()
                t = time.time()
                lines, _, _ = run_launcher(argv, init)
                if side == "cuda":
                    secs[case] = time.time() - t
                    for k, v in ops.launch_counts().items():
                        launches[k] = launches.get(k, 0) + v
                outs[side] = (d, lines)
            launch_against_cpu(case, flags, outs["cuda"], outs["cpu"])
            log(f"[launch] (c) reduced {case}: card = CPU, "
                f"{len(outs['cuda'][1])} lines (wall figures masked), "
                f"{secs[case]:.2f} s on the card")
    return secs, launches


def launch_against_cpu(case: str, flags: str, card, cpu) -> None:
    """One (c) case: the card's (directory, lines) against the CPU's."""
    from repro_torch.serving.probes import golden_entry, sentinel_check
    (dg, got), (dw, want) = card, cpu
    if launch_masked(got, dg) != launch_masked(want, dw):
        raise AssertionError(f"[launch] reduced {case}: the card's lines "
                             f"{got} differ from the CPU's {want}")
    if "--probes" in flags:
        num = [_read_json(f"{d}/numerics.json") for d in (dg, dw)]
        for k, v in num[1].items():
            if not k.startswith("kv_err") and num[0][k] != v:
                raise AssertionError(f"[launch] reduced {case}: numerics "
                                     f"{k} {num[0][k]} != {v}")
        fails = (sentinel_check(num[0], golden_entry(num[1]))
                 + sentinel_check(num[1], golden_entry(num[0])))
        if fails:
            raise AssertionError(f"[launch] reduced {case}: {fails}")
    if "--metrics-out" in flags:
        snaps = [_read_json(f"{d}/metrics.json") for d in (dg, dw)]
        for s in snaps:
            s.pop("kernels", None)
        if snaps[0] != snaps[1]:
            raise AssertionError(f"[launch] reduced {case}: metrics "
                                 "snapshots differ")


def launch_path(cfg, want_rows) -> tuple[dict, dict]:
    """The [launch] phase, after phase 5's model is freed:
    ``repro_torch.launch.serve.main`` in this process.  (a) qwen3-1.7b at
    full width, ``--compress --backend codebook``, 8 requests: the
    ``[memory]`` row against a reckoning from the served tree, packed
    under a third of fp32; the ``sample:`` row equal to phase 5's codebook
    engine's (``want_rows``); 7 × 28 codebook_matmul a forward whose
    wrappers ran; wall tok/s, ms/request and peak memory.  (b) The same
    model as a server: paged int8 pages, a 16-request Poisson trace,
    every request finished, the pool clean, launches per forward plus one
    page_gather a swap-out; wall drain seconds and tok/s.  (c)
    ``launch_reduced``.  (d) ``python -m repro_torch.launch.serve`` as a
    subprocess on the card.  Returns (stats, launches)."""
    import gc
    import re
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.scheduler import FINISHED

    t0 = time.time()
    n_l, stats, launches = cfg.n_layers, {}, {}

    def add(counts):
        for k, v in counts.items():
            if v:
                launches[k] = launches.get(k, 0) + v

    # (a) batch
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.time()
    lines, engines, _ = run_launcher(LAUNCH_BATCH.split())
    secs = time.time() - t
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    (e,) = engines
    fwd = called_forwards(e)
    check_launches("[launch] (a)", counts, {"codebook_matmul": 7 * n_l}, fwd)
    add(counts)
    mem = launch_memory(lines, e.params, cfg)
    prompt, toks = launch_sample(lines)
    if prompt + toks != want_rows[0]:
        raise AssertionError(f"[launch] (a) sample {prompt} -> {toks}, "
                             f"phase 5's engine {want_rows[0]}")
    wall = launch_wall(launch_line(lines, "[serve]"))
    peak = torch.cuda.max_memory_reserved() / 2 ** 30
    stats["batch"] = {"memory": mem, "wall": wall, "peak_gib": peak,
                      "seconds": secs, "forwards": fwd, "launches": counts,
                      "captures": e.n_captures, "replays": e.n_replays}
    log(f"[launch] (a) {LAUNCH_BATCH}: {mem['row']}; packed "
        f"{100 * mem['packed_share']:.2f} % of fp32 (under a third); sample "
        f"= phase 5's codebook engine; {wall['tok_s']} tok/s, "
        f"{wall['ms_request']} ms/request (wall); launches {counts} over "
        f"{fwd} forwards whose wrappers ran; peak reserved {peak:.2f} GiB; "
        f"{secs:.2f} s in all")
    del e, engines
    gc.collect()
    freed("[launch] (a)")

    # (b) server
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.time()
    lines, engines, servers = run_launcher(LAUNCH_SERVER.split())
    secs = time.time() - t
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    (e,), (srv,) = engines, servers
    launch_memory(lines, e.params, cfg)
    handles = list(srv.sched.handles.values())
    if len(handles) != 16 or any(h.state != FINISHED for h in handles):
        raise AssertionError(f"[launch] (b): {len(handles)} requests, "
                             f"states {[h.state for h in handles]}")
    if e.pool.reserved_extra or not _pool_clean(e.pool):
        raise AssertionError("[launch] (b): pool not clean after the drain")
    fwd = called_forwards(e)
    n_pre = int(re.search(r"\[server\] (\d+) preemptions",
                          "\n".join(lines)).group(1))
    want = {"codebook_matmul": 7 * n_l * fwd,
            "page_gather": n_l * fwd + n_pre}
    if counts != want:
        raise AssertionError(f"[launch] (b): launches {counts} over {fwd} "
                             f"forwards and {n_pre} swap-outs, want {want}")
    add(counts)
    wall = launch_wall(launch_line(lines, "[server]"))
    peak = torch.cuda.max_memory_reserved() / 2 ** 30
    stats["server"] = {"wall": wall, "peak_gib": peak, "seconds": secs,
                       "forwards": fwd, "launches": counts,
                       "preemptions": n_pre,
                       "report": [ln for ln in lines
                                  if ln.startswith("[server]")]}
    log(f"[launch] (b) {LAUNCH_SERVER}: 16 requests finished, pool clean; "
        f"drain {wall['s']} s wall, {wall['tok_s']} tok/s; {n_pre} "
        f"preemptions; launches {counts} over {fwd} forwards whose wrappers "
        f"ran + {n_pre} swap-out gathers; peak reserved {peak:.2f} GiB; "
        f"{secs:.2f} s in all")
    del e, engines, srv, servers, handles
    gc.collect()
    freed("[launch] (b)")

    # (c) reduced, card against CPU
    secs_c, counts = launch_reduced()
    add(counts)
    stats["reduced_s"] = secs_c
    freed("[launch] (c)")

    # (d) a fresh process
    t = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--reduced", "--requests", "2", "--max-new", "4"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
    stats["subprocess_s"] = time.time() - t
    if r.returncode != 0 or "tok/s on cuda" not in r.stdout:
        raise AssertionError(f"[launch] (d) exited {r.returncode}: "
                             f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    log(f"[launch] (d) python -m repro_torch.launch.serve --arch qwen3-1.7b "
        f"--reduced --requests 2 --max-new 4: exit 0 on the card, "
        f"{stats['subprocess_s']:.2f} s; "
        + launch_line(r.stdout.splitlines(), "[serve]"))
    stats["phase_s"] = time.time() - t0
    log(f"[launch] phase {stats['phase_s']:.1f} s")
    return stats, launches


def time_register(pool, capture: dict) -> None:
    """Time ``pool.register_prefill`` (with a shared tier, the capture of
    its pages: one blocking copy a page a plane) into ``capture``, between
    synchronizations, so that the prefill's kernels before it are not
    counted."""
    import torch
    register = pool.register_prefill

    def timed_register(adm):
        torch.cuda.synchronize()
        t = time.perf_counter()
        register(adm)
        capture["s"] += time.perf_counter() - t
        capture["calls"] += 1
    pool.register_prefill = timed_register


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
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import kmeans1d as km
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import (ServeEngine, SpecConfig,
                                     to_codebook_params)

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
    launches, graphs = {}, {}
    for name, reqs in (("codebook", prompts[:8]), ("lut", prompts[:4]),
                       ("paged", chats[:8])):
        e = eng[name]
        be = e.backend
        # codebook: w1, w3 and the activation in one gated launch a layer;
        # lut: the activation with its multiplier, one launch a layer
        gated = be == "codebook"
        want = {"act_quant": 0 if gated else n_l,
                "codebook_swiglu": n_l if gated else 0,
                f"{be}_matmul": (5 if gated else 7) * n_l,
                "page_gather": n_l if name == "paged" else 0}
        want = {k_: v for k_, v in want.items() if v}
        act_kernel = "StoreSwiglu" if gated else "act_quant"
        res, _ = graph_vs_eager(
            f"[point] {name}", e, reqs, reqs[:4], want,
            {KERNEL_NAMES[k_]: v for k_, v in want.items()},
            step_pos=120 if name == "paged" else 40, n_pages=N_PAGES,
            match=act_kernel)
        for k_ in want:
            launches[k_] = launches.get(k_, 0) + res["launches"][k_]
        graphs[name] = res
        stats[f"{name}_serve_tok_s"] = res["serve_tok_s"]["graph"]
        stats[f"{name}_serve_tok_s_eager"] = res["serve_tok_s"]["eager"]
    launches["kmeans_assign"] = cl_counts["kmeans_assign"]
    del eng["paged"]
    freed("[point] paged")

    # the paged spec path at the working point: the gated launch in every
    # verify and prefill chunk
    e = ServeEngine(model, cp, backend="codebook", paged=True,
                    page_size=PAGE, kv_dtype="int8", max_len=PAGED_MAX_LEN,
                    max_batch=MAX_BATCH, device=dev,
                    spec=SpecConfig(draft="ngram", k=SPEC_K))

    def after_serve(i, pool=e.pool):
        if pool.reserved_extra or not _pool_clean(pool):
            raise AssertionError(f"[point] paged spec: serve {i} left the "
                                 "pool unclean")
    res = spec_turns("[point] paged spec, codebook, int8 pages, ngram draft",
                     e, chats[:4], {"codebook_matmul": 5 * n_l,
                                    "codebook_swiglu": n_l,
                                    "page_gather": n_l}, {}, None, max_new=8,
                     after_serve=after_serve)
    for k_, v in res["launches"].items():
        launches[k_] = launches.get(k_, 0) + v
    res.pop("tokens")
    stats["paged_spec"] = res
    del e, after_serve
    freed("[point] paged spec")

    # prefill logits codebook vs dense, with every FFN input captured: in
    # bf16 as served, then with the same index-form weights in f32
    toks, lens = eng["dense"]._pad_prompts(prompts[:4])
    act = ActQuantConfig("relu6", ACT_LEVELS)

    def compare(engs, tag):
        """Prefill logits of the two engines, and every FFN's gate input
        G = x·W1 as the unfused chain computes it (``L.dense``; the gated
        launch's G has the same bits, phase 3), with each FFN's input."""
        captured, inputs, orig, lg = {}, {}, L.swiglu, {}
        for be, e in engs.items():
            def capture(p, x, kind, levels, backend, be=be):
                captured.setdefault(be, []).append(
                    L.dense(p["w1"], x, backend).detach().clone())
                inputs.setdefault(be, []).append((p, x.detach().clone()))
                return orig(p, x, kind, levels, backend)
            L.swiglu = capture
            try:
                lg[be] = e._prefill(toks, lens)[0][:, -1, :cfg.vocab].float()
            finally:
                L.swiglu = orig
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
        return r, captured, inputs

    bf16, captured, inputs = compare(
        {be: eng[be] for be in ("dense", "codebook")}, "bf16")
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
    f32, _, _ = compare({be: ServeEngine(m32, cp32, backend=be, **kw)
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
    # the gated launch on the same layer's real FFN input and weights,
    # against the unfused chain of CUDA launches and the plain epilogue
    p_mid, x_mid = inputs["codebook"][n_l // 2]
    x2 = x_mid.reshape(-1, x_mid.shape[-1]).contiguous()
    w1, w3 = p_mid["w1"], p_mid["w3"]
    h = cm.codebook_swiglu_cuda(x2, w1["w_idx"], w1["codebook"], w3["w_idx"],
                                w3["codebook"], "relu6", ACT_LEVELS)
    gs = cm.codebook_matmul_cuda(x2, w1["w_idx"], w1["codebook"])
    us = cm.codebook_matmul_cuda(x2, w3["w_idx"], w3["codebook"])
    chain = aq.act_quant_cuda(gs.to(x2.dtype), "relu6", ACT_LEVELS,
                              form="act_apply", with_index=False,
                              mul=us.to(x2.dtype))[0]
    if not (torch.equal(h, chain) and torch.equal(
            h, cm.swiglu_epilogue_plain(gs, us, x2.dtype, "relu6",
                                        ACT_LEVELS))):
        raise AssertionError("codebook_swiglu on a layer's real input "
                             "differs from the unfused chain")
    log(f"[point] act_quant on layer {n_l // 2}'s real w1 outputs "
        f"{tuple(x.shape)} bf16, both forms: bit-equal to the plain version; "
        f"codebook_swiglu on its real FFN input {tuple(x2.shape)}: bit-equal "
        f"to the unfused chain and to the plain epilogue")
    del captured, inputs, x, x_mid, x2

    # decode step and prefill, as phase 5 times them
    t32, l32 = eng["dense"]._pad_prompts([(prompts[0] * 4)[:32]])
    for be in ("codebook", "lut"):
        e = eng[be]
        pre = [timed(lambda: e._prefill(t32, l32))[1] for _ in range(4)][1:]
        step = graphs[be]["step"]["graph"]
        st = {"prefill_ms": 1e3 * sorted(pre)[len(pre) // 2],
              **step_stats(graphs[be]),
              "act_kernel": "StoreSwiglu" if be == "codebook" else "act_quant",
              "act_kernel_device_ms": step["match_ms"],
              "graph": graphs[be]}
        stats[be] = st
        b = base.get(be, {})
        log(f"[point] {be}, graph route (phase 5, act_levels 0): prefill 1×32 "
            f"{st['prefill_ms']:.2f} ms ({b.get('prefill_ms', 0):.2f}), "
            f"decode step {st['decode_step_ms']:.2f} ms "
            f"({b.get('decode_step_ms', 0):.2f}), device busy "
            f"{st['decode_device_ms']:.2f} ms "
            f"({b.get('decode_device_ms', 0):.2f}), idle share "
            f"{st['decode_idle_share']:.3f} "
            f"({b.get('decode_idle_share', 0):.3f}), {st['decode_kernels']} "
            f"kernels ({b.get('decode_kernels', 0)}), {st['act_kernel']} "
            f"{st['act_kernel_device_ms']:.3f} ms of it ({n_l} launches); "
            f"serve {st['serve_tok_s']:.1f} tok/s "
            f"({b.get('serve_tok_s', 0):.1f})")
    stats["unfused_chain"] = unfused_step(dev, eng["codebook"], L)
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[point] peak memory {stats['peak_mem_gib']:.2f} GiB")
    del eng, cp, model
    return stats, launches, km_row


KVQ_LAYERS = 4                   # codeqwen1.5-7b's 32 layers, cut for time


def kv_quant_path(dev) -> tuple[dict, dict, dict]:
    """The [kvq] phase: codeqwen1.5-7b at full width (d 4096, 32/32 heads,
    hd 128, d_ff 13440, vocab 92416, untied head, bf16), KVQ_LAYERS of its
    32 layers, compressed as ``launch/serve.py --compress`` does, served
    through the codebook backend with its int8 contiguous cache
    (``kv_quant``): 8 requests over 4 slots on the graph route against the
    eager route (``graph_vs_eager``), launches checked (7 × layers + 1
    codebook_matmul a forward); the cache's bytes against a bf16 cache's;
    the decode step (4 slots at 40) with each cache on both routes; the
    gap between the two caches' decode logits over 8 eager forwards fed
    the same tokens; then the [spec] phase's engine on this model: the
    n-gram draft (k = SPEC_K) on the int8 cache, the spec phase's 8
    requests (``spec_turns``) against the int8 engine's baseline.  Returns
    (stats, launches, the spec engine's launches)."""
    import torch
    from repro_torch import configs
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine, SpecConfig
    full = configs.get("codeqwen1.5-7b")
    cfg = full.replace(n_layers=KVQ_LAYERS)
    model, cp = compressed_model(dev, cfg, "[kvq]")
    kw = dict(backend="codebook", max_len=128, max_batch=MAX_BATCH,
              device=dev)
    e8 = ServeEngine(model, cp, **kw)
    e16 = ServeEngine(build(cfg.replace(kv_quant=False)), cp, **kw)
    prompts = prompts_for(8, cfg.vocab)
    per_fwd = 7 * cfg.n_layers + 1
    res, _ = graph_vs_eager("[kvq] codebook int8 cache", e8, prompts,
                            prompts[:4], {"codebook_matmul": per_fwd},
                            {"StoreSum": per_fwd}, step_pos=40)
    step16 = step_turns("[kvq] codebook bf16 cache", e16,
                        step_state(e16, 40), {"StoreSum": per_fwd})
    stats = {"config": f"{full.name} {cfg.n_layers} of {full.n_layers} "
                       "layers, full width",
             "graph": res, "bf16_step": step16,
             "serve_tok_s": res["serve_tok_s"]["graph"],
             "serve_tok_s_eager": res["serve_tok_s"]["eager"],
             "cache_bytes_int8": e8.dense_cache_bytes(),
             "cache_bytes_bf16": e16.dense_cache_bytes()}
    for name, step in (("int8", res["step"]), ("bf16", step16)):
        for route, sfx in (("graph", ""), ("eager", "_eager")):
            stats[f"decode_step_ms_{name}{sfx}"] = step[route]["mean_wall_ms"]
            stats[f"decode_device_ms_{name}{sfx}"] = step[route]["device_ms"]
    # decode logits of the two caches from the same prefill, fed the int8
    # engine's greedy tokens
    toks, lens = e8._pad_prompts(prompts[:4])
    lg8, c8 = e8._prefill(toks, lens)
    lg16, c16 = e16._prefill(toks, lens)
    c8, c16 = e8._grow(c8), e16._grow(c16)
    V = cfg.vocab
    last = lg8[:, -1, :V].argmax(-1).cpu().numpy()
    gaps, scale, agree = [], 0.0, 0
    for _ in range(8):
        lg8, c8 = e8._decode(last, c8)
        lg16, c16 = e16._decode(last, c16)
        a, b = lg8[:, -1, :V].float(), lg16[:, -1, :V].float()
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError("[kvq] non-finite decode logits")
        gaps.append((a - b).abs().max().item())
        scale = max(scale, b.abs().max().item())
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
        last = a.argmax(-1).cpu().numpy()
    if not max(gaps) > 0:
        raise AssertionError("[kvq] the int8 cache's logits equal the bf16 "
                             "cache's: the int8 path did not run")
    stats.update(decode_logit_gap_max=max(gaps), decode_logit_gaps=gaps,
                 max_abs_logit=scale, argmax_agree=agree,
                 argmax_total=4 * len(gaps),
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"[kvq] {stats['config']} (cut from {full.n_layers} to "
        f"{cfg.n_layers} layers for time), codebook backend, int8 "
        f"contiguous cache: serve {stats['serve_tok_s']:.1f} tok/s on the "
        f"graph route, {stats['serve_tok_s_eager']:.1f} eager; cache "
        f"{stats['cache_bytes_int8']} B against a bf16 cache's "
        f"{stats['cache_bytes_bf16']} B "
        f"({stats['cache_bytes_int8'] / stats['cache_bytes_bf16']:.4f}); "
        f"decode step (4 slots at 40), graph (eager) int8 "
        f"{stats['decode_step_ms_int8']:.2f} "
        f"({stats['decode_step_ms_int8_eager']:.2f}) ms (device "
        f"{stats['decode_device_ms_int8']:.3f}), bf16 "
        f"{stats['decode_step_ms_bf16']:.2f} "
        f"({stats['decode_step_ms_bf16_eager']:.2f}) ms (device "
        f"{stats['decode_device_ms_bf16']:.3f}); decode logits int8 vs "
        f"bf16 cache over 8 steps: max |Δ| {max(gaps):.4e} (max |logit| "
        f"{scale:.4e}), argmax agree {agree}/{4 * len(gaps)}; peak memory "
        f"{stats['peak_mem_gib']:.2f} GiB")
    launches = {"codebook_matmul": res["launches"]["codebook_matmul"]}
    del e16
    reqs = spec_prompts(prompts, cfg.vocab)
    toks, rec, base_tok_s = baseline_rows(e8, reqs, 16)
    del e8
    freed("[kvq] baseline")
    tag = "[spec] [kvq] codebook target, ngram draft, int8 cache"
    es = ServeEngine(model, cp, spec=SpecConfig(draft="ngram", k=SPEC_K),
                     **kw)
    sres = spec_turns(tag, es, reqs, {"codebook_matmul": per_fwd}, {},
                      (toks, rec))
    sres.pop("tokens")
    sres["baseline_serve_tok_s"] = base_tok_s
    sres["decode_step_ms"] = stats["decode_step_ms_int8"]
    log(f"{tag}: round {sres['round_ms']['graph']:.2f} ms against the "
        f"decode step {sres['decode_step_ms']:.2f} ms (graph route, 4 slots "
        f"at 40); serve {sres['serve_tok_s']['graph']:.1f} tok/s against "
        f"the baseline's {sres['baseline_serve_tok_s']:.1f} on the same "
        "requests")
    stats["spec"] = sres
    del es, model, cp
    sres["reserved_after_free_gib"] = freed(tag)
    return stats, launches, dict(sres["launches"])


# --- [moe]: the mixture-of-experts family ------------------------------------

MOE_NEW = 16                    # tokens a request of a full-width serve


def moe_compressed(cfg, params, exclude: str = "router"):
    """``params`` compressed as ``launch/serve.py --compress`` does
    (laplacian_l1, |W| = N_BOOK, global) with ``exclude`` kept out of the
    clustering and the index form: (clustered params, index-form params,
    the clustering state, the WeightQuantConfig)."""
    import dataclasses
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.serving import to_codebook_params
    wq = dataclasses.replace(cfg.quantized(n_weights=N_BOOK).wq,
                             exclude=exclude)
    pq, state = cluster_params(params, wq, init_state(wq), wq.interval)
    return pq, to_codebook_params(pq, wq, state), state, wq


def moe_decisions(run) -> list:
    """Every discrete decision ``run()`` takes, in order: (kind, the input
    as f32 on the host, the decision), for the lut activation snap
    (``dispatch.lut_acc``: the input in grid units, the level id), the
    int8 K/V rounding (``attention.quantize_kv``: the input in scale
    units, the code) and the router's top-k (``moe._top_k``: the
    probabilities, the expert ids)."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    events = []
    lut_acc, quantize_kv, top_k = dispatch.lut_acc, A.quantize_kv, M._top_k

    def rec(kind, x, out):
        events.append((kind, x.detach().float().cpu(), out.detach().cpu()))

    def lut(x2, w_idx, codebook, spec, table=None):
        g = (x2.float() - spec.a_min) / dispatch._grid_step(spec, x2.device)
        rec("lut", g, torch.clamp(torch.round(g), 0, spec.levels - 1))
        return lut_acc(x2, w_idx, codebook, spec, table)

    def kvq(t):
        q, sc = quantize_kv(t)
        tf = t.float()
        rec("kvq", tf / (torch.clamp(tf.abs().amax(-1, keepdim=True),
                                     min=1e-6) / A.KV_QMAX), q)
        return q, sc

    def top(probs, k):
        v, ids = top_k(probs, k)
        rec("route", probs, ids)
        return v, ids
    dispatch.lut_acc, A.quantize_kv, M._top_k = lut, kvq, top
    try:
        run()
    finally:
        dispatch.lut_acc, A.quantize_kv, M._top_k = lut_acc, quantize_kv, top_k
    return events


def first_parting(cpu_events: list, card_events: list) -> str:
    """The first decision the card takes otherwise than the CPU, which must
    be a tie: a lut snap (or an int8 K/V rounding) of inputs the two
    computed within 1e-3 of a unit of the same half-way point, one level
    apart, every earlier decision equal.  Returns its description; raises
    for any other first difference (a router choice, a structure that
    differs, a snap away from a half-way point)."""
    import torch
    for i, ((ka, xa, ya), (kb, xb, yb)) in enumerate(zip(cpu_events,
                                                         card_events)):
        if ka != kb or xa.shape != xb.shape:
            raise AssertionError(f"decision {i}: {ka} {tuple(xa.shape)} on "
                                 f"the CPU, {kb} {tuple(xb.shape)} on the "
                                 "card")
        if torch.equal(ya, yb):
            continue
        diff = ya != yb
        what = f"decision {i} of {len(cpu_events)} ({ka}): " \
            f"{int(diff.sum())} of {ya.numel()} differ"
        tie = ka in ("lut", "kvq")
        if tie:
            half = torch.floor(xa[diff]) + 0.5
            tie = (bool(((ya[diff].long() - yb[diff].long()).abs() == 1)
                        .all())
                   and float((xa[diff] - half).abs().max()) <= 1e-3
                   and float((xb[diff] - half).abs().max()) <= 1e-3)
            what += (f"; CPU inputs {xa[diff][:4].tolist()}, card "
                     f"{xb[diff][:4].tolist()}")
        if not tie:
            raise AssertionError("the first decision the card takes "
                                 "otherwise than the CPU is not a tie: "
                                 + what)
        return what
    raise AssertionError("the tokens part, but every decision is equal")


def moe_reduced(dev) -> None:
    """The reduced qwen3-moe-30b-a3b (f32, 8 experts, top-2) and grok-1-314b
    (f32, ``kv_quant``, ``moe_token_chunks=2``), compressed on the CPU as
    ``--compress`` does, through dense, codebook and lut, contiguous
    (``serve`` of 5 requests over 2 slots, ``generate``) and paged (page 8,
    bf16 and int8 pages): the card's greedy tokens equal the CPU's.

    lut alone may part: its activation snap rounds half to even, and a
    value the card computes exactly on a half-way point the CPU may compute
    an f32 ulp beside it (on an H100: 2410.5 against 2410.500244 grid
    units).
    A dense model's next token survives such a snap; a routed one need
    not, once the snap moves a router choice or a capacity rank.  Where
    lut's tokens part, both serves run again eagerly with every discrete
    decision recorded (``moe_decisions``), and the first the card takes
    otherwise must be such a tie (``first_parting``)."""
    import torch
    from repro_torch import configs
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9] * 11, [300, 2, 5, 7, 1, 8],
               [1, 2, 3, 4, 5, 6, 7]]
    caches = {"contiguous": {},
              "paged bf16": dict(paged=True, page_size=8),
              "paged int8": dict(paged=True, page_size=8, kv_dtype="int8")}
    partings = []
    for name, over in (("qwen3-moe-30b-a3b", {}),
                       ("grok-1-314b", {"moe_token_chunks": 2})):
        cfg = configs.get(name).reduced().replace(**over)
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        _, cp, _, _ = moe_compressed(cfg, params)
        cp_dev = _to(cp, dev)
        for be in ("dense", "codebook", "lut"):
            for cache, kw in caches.items():
                kw = dict(max_len=64, max_batch=2, backend=be, **kw)
                on_cpu = ServeEngine(model, cp, device="cpu", **kw)
                on_dev = ServeEngine(model, cp_dev, device=dev, **kw)
                want = [on_cpu.serve(prompts, max_new=8)]
                got = [on_dev.serve(prompts, max_new=8)]
                if cache == "contiguous":
                    want.append(on_cpu.generate(prompts[:3], max_new=8))
                    got.append(on_dev.generate(prompts[:3], max_new=8))
                if got == want:
                    continue
                tag = f"[moe] reduced {name} {over}, {be} {cache}"
                if be != "lut":
                    raise AssertionError(f"{tag}: card tokens {got} != CPU "
                                         f"tokens {want}")
                events = []
                for d, p in (("cpu", cp), (dev, cp_dev)):
                    e = ServeEngine(model, p, device=d, **kw)
                    e._graphs = False
                    events.append(moe_decisions(
                        lambda: e.serve(prompts, max_new=8)))
                part = first_parting(*events)
                partings.append(f"{name} {be} {cache}")
                log(f"{tag}: card tokens part from the CPU's "
                    f"({sum(a != b for a, b in zip(got[0], want[0]))} of "
                    f"{len(prompts)} requests); the first decision the "
                    f"card takes otherwise is a tie: {part}")
    log("[moe] reduced qwen3-moe-30b-a3b and grok-1-314b (moe_token_chunks "
        "2, kv_quant): dense/codebook/lut tokens on the card equal the CPU "
        "path's, contiguous (serve over reused slots, generate) and paged "
        "(bf16 and int8 pages)"
        + (f", but where a lut snap tie parts them ({', '.join(partings)})"
           if partings else ""))


def moe_prompts(n: int, vocab: int, lo: int, hi: int):
    import numpy as np
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, int(k)).tolist()
            for k in rng.integers(lo, hi + 1, n)]


def moe_engine_check(tag: str, e, reqs, want_launches) -> dict:
    """Engine ``e`` (a fresh one) on both routes: ``serve(reqs, MOE_NEW)``
    eager, then on the graph route twice (the first captures, the second
    captures nothing), tokens equal; kernel launches equal to
    ``want_launches(n_prefill, n_decode)`` over the prefill forwards and
    the decode steps whose wrappers ran; then ``step_turns`` on a state of
    its own (``step_state`` at max_len / 2, a distinct token a slot): the
    replayed step's logits bit-equal to eager's, wall and device ms, idle
    share and kernels a step by name.  Returns the figures."""
    import torch
    from repro_torch.kernels import ops
    n_pre = [0]
    for name in ("_prefill", "_prefill_chunk"):
        def counted(*a, _orig=getattr(e, name), **k):
            n_pre[0] += 1
            return _orig(*a, **k)
        setattr(e, name, counted)
    before, c0 = ops.launch_counts(), called_forwards(e)
    res, outs = {"serve_s": {"eager": [], "graph": []}}, {}
    torch.cuda.reset_peak_memory_stats()
    for route in ("eager", "graph", "graph"):
        e._graphs = route == "graph"
        k0 = e.n_captures
        toks, secs = timed(lambda: e.serve(reqs, max_new=MOE_NEW))
        res["serve_s"][route].append(secs)
        if route in outs and e.n_captures != k0:
            raise AssertionError(f"{tag}: the second graph serve captured")
        outs.setdefault(route, toks)
        if toks != outs["eager"]:
            raise AssertionError(f"{tag}: {route} serve's tokens differ from "
                                 "the eager route's")
    del e._prefill, e._prefill_chunk
    for seq in outs["eager"]:
        if not all(0 <= t < e.model.cfg.vocab for t in seq):
            raise AssertionError(f"{tag}: token id out of range")
    after = ops.launch_counts()
    counts = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    n_dec = called_forwards(e) - c0 - n_pre[0]
    want = {k: v for k, v in want_launches(n_pre[0], n_dec).items() if v}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} over {n_pre[0]} "
                             f"prefill and {n_dec} decode forwards, want "
                             f"{want}")
    pos = e.max_len // 2
    n_pages = 1 + MAX_BATCH * -(-e.max_len // e.page_size) if e.paged else 0
    st = step_state(e, pos, n_pages)
    st.last.copy_(torch.arange(1, MAX_BATCH + 1, device=e.device) * 997
                  % e.model.cfg.vocab)
    per_step = {KERNEL_NAMES[k]: v for k, v in want_launches(0, 1).items()
                if v}
    step = step_turns(tag, e, st, per_step)
    del st
    n_tok = sum(len(t) - len(p) for t, p in zip(outs["eager"], reqs))
    res.update(tokens=n_tok, launches=counts, prefill_forwards=n_pre[0],
               decode_forwards=n_dec, step=step,
               tok_s={r: n_tok / min(v) for r, v in res["serve_s"].items()},
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    g, ea = step["graph"], step["eager"]
    log(f"{tag}: serve {len(reqs)} × {MOE_NEW} (eager, graph, graph) "
        + ", ".join(f"{s:.3f}" for r in ("eager", "graph")
                    for s in res["serve_s"][r])
        + f" s → eager {res['tok_s']['eager']:.1f}, graph "
        f"{res['tok_s']['graph']:.1f} tok/s, tokens equal; launches "
        f"{counts} over {n_pre[0]} prefill and {n_dec} decode forwards "
        f"whose wrappers ran; peak allocated {res['peak_gib']:.2f} GiB; "
        f"decode step ({MAX_BATCH} slots at {pos}, in turns) wall eager "
        f"{ea['mean_wall_ms']:.2f} ms, graph {g['mean_wall_ms']:.2f} ms; "
        f"device busy eager {ea['device_ms']:.3f} ms (idle share "
        f"{ea['idle_share']:.3f}), graph {g['device_ms']:.3f} ms (idle "
        f"share {g['idle_share']:.3f}); {g['kernels']} kernels a step, by "
        f"name {g['found']}; replayed logits bit-equal to eager; top "
        "(graph): " + "; ".join(f"{k} {ms:.3f}ms×{n}"
                                for k, ms, n in g["top"]))
    return res


def moe_full(dev, name: str, n_layers: int, prompt_lens: tuple) -> tuple:
    """``name`` at full width, ``n_layers`` of its layers, bf16, random
    weights from a seeded generator, at ``act_levels`` 32 (the experts'
    activation on the act_quant kernel), its sizes logged: (model,
    params, MAX_BATCH prompts of ``prompt_lens`` tokens, config)."""
    import torch
    from repro_torch import configs
    from repro_torch.models.model_zoo import build
    cfg = configs.get(name).replace(n_layers=n_layers,
                                    act_levels=ACT_LEVELS)
    model = build(cfg)
    params, t_init = timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    moe = params["blocks"]["moe"]
    gb = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                        for t in ts) / 1e9
    experts, total = gb(moe[k] for k in ("w1", "w3", "w2")), \
        gb(_leaves(params))
    log(f"[moe] {name}: {n_layers} of {configs.get(name).n_layers} layers, "
        f"d={cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv}, hd {cfg.hd}, "
        f"{cfg.n_experts} experts of f={cfg.d_ff}, top-{cfg.top_k}, "
        f"token chunks {cfg.moe_token_chunks}, vocab {cfg.vocab}, kv_quant "
        f"{cfg.kv_quant}, act_levels {cfg.act_levels}, {cfg.dtype}: "
        f"{total:.2f} GB ({experts:.2f} GB of experts), init {t_init:.2f}s")
    lo, hi = prompt_lens
    return model, params, moe_prompts(MAX_BATCH, cfg.vocab, lo, hi), cfg


def moe_path(dev, smi: str) -> tuple[dict, dict]:
    """The [moe] phase: ``moe_reduced``; qwen3-moe-30b-a3b at full width
    (2 layers, bf16, act_levels 32) served uncompressed on the contiguous
    cache and on int8 pages, then compressed with ``exclude="router"``
    through codebook and lut (and, without the exclusion, the router in
    index form raising ``KeyError`` in the prefill, as the reference's
    does); grok-1-314b at full width (1 layer, bf16, act_levels 32) with
    its int8 contiguous cache and 8 token chunks, 128-token prefills.
    Every engine through ``moe_engine_check``.  Returns the figures and
    the phase's launches."""
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving import ServeEngine, to_codebook_params
    t0 = time.time()
    ops.reset_launch_counts()
    moe_reduced(dev)
    stats = {"reduced_s": time.time() - t0}

    model, params, reqs, cfg = moe_full(dev, "qwen3-moe-30b-a3b", 2, (8, 48))
    L = cfg.n_layers
    kw = dict(max_len=128, max_batch=MAX_BATCH, device=dev)
    caches = {"contiguous": {},
              "paged int8": dict(paged=True, page_size=PAGE,
                                 kv_dtype="int8")}
    for cache, ckw in caches.items():
        gather = L if ckw else 0
        stats[f"qwen3_moe dense {cache}"] = moe_engine_check(
            f"[moe] qwen3-moe-30b-a3b dense {cache}",
            ServeEngine(model, params, **kw, **ckw), reqs,
            lambda pre, dec, g=gather: {"act_quant": L * (pre + dec),
                                        "page_gather": g * (pre + dec)})
        freed(f"[moe] qwen3-moe-30b-a3b dense {cache}")
    (pq, cp, state, wq), t_cl = timed(lambda: moe_compressed(cfg, params))
    del params
    bad = to_codebook_params(pq, dataclasses.replace(wq, exclude=""), state)
    if set(bad["blocks"]["moe"]["router"]) != {"w_idx", "codebook"}:
        raise AssertionError("[moe] the router left out of the index form")
    try:
        model.prefill(bad, {"tokens": torch.tensor(reqs[:1], device=dev)})
    except KeyError as err:
        if err.args != ("w",):
            raise
    else:
        raise AssertionError("[moe] a router in index form served")
    del bad, pq
    log(f"[moe] qwen3-moe-30b-a3b compressed (laplacian_l1, |W| = {N_BOOK}, "
        f"exclude 'router') in {t_cl:.2f}s; without the exclusion the "
        "router is in index form and the prefill raises KeyError('w'), as "
        "the reference's does")
    for be, site in (("codebook", "codebook_matmul"), ("lut", "lut_matmul")):
        stats[f"qwen3_moe {be}"] = moe_engine_check(
            f"[moe] qwen3-moe-30b-a3b {be} contiguous",
            ServeEngine(model, cp, backend=be, **kw), reqs,
            lambda pre, dec, s=site: {s: (4 * L + 1) * (pre + dec),
                                      "act_quant": L * (pre + dec)})
        freed(f"[moe] qwen3-moe-30b-a3b {be}")
    del cp, model
    freed("[moe] qwen3-moe-30b-a3b")

    model, params, reqs, cfg = moe_full(dev, "grok-1-314b", 1, (65, 120))
    chunks = cfg.moe_token_chunks
    stats["grok int8 contiguous"] = moe_engine_check(
        "[moe] grok-1-314b dense, int8 contiguous cache",
        ServeEngine(model, params, max_len=160, max_batch=MAX_BATCH,
                    device=dev), reqs,
        lambda pre, dec: {"act_quant": cfg.n_layers * (chunks * pre + dec)})
    del params, model
    freed("[moe] grok-1-314b")
    launches = ops.launch_counts()
    stats["phase_s"] = time.time() - t0
    log(f"[moe] {smi}: phase {stats['phase_s']:.1f}s (reduced against the "
        f"CPU {stats['reduced_s']:.1f}s); launches {launches}")
    return stats, launches


# --- [recurrent]: RWKV-6 and the Mamba2/Zamba2 hybrid ------------------------



def rec_launches(cfg, be: str) -> dict:
    """Kernel launches of one forward of a recurrent model at act_levels >
    0 (a prefill, a decode step or ``forward``), derived from the code.
    RWKV-6: 9 index-form matmuls a layer (the time mix's wr, wk, wv, wg,
    wo and its LoRA's two, the channel mix's wk, wv) and 2 act_quant (the
    gate with its multiplier, the squared relu's relu6).  The hybrid: 2
    matmuls a Mamba2 layer (in_proj, out_proj) and 2 act_quant (the conv
    output, the z gate with its multiplier); a group's shared block
    in_proj, wq, wk, wv, wo and w2, and its w1/w3 as one gated launch on
    codebook, else as two matmuls and one act_quant with its
    multiplier."""
    L = cfg.n_layers
    if cfg.family == "ssm_rwkv":
        mm, aq, gated = 9 * L, 2 * L, 0
    else:
        g = cfg.n_layers // cfg.shared_attn_every
        mm, aq, gated = 2 * L + 6 * g, 2 * L, g
        if be != "codebook":
            mm, aq, gated = mm + 2 * g, aq + g, 0
    out = {"act_quant": aq}
    if be == "codebook":
        out.update(codebook_matmul=mm, codebook_swiglu=gated)
    elif be == "lut":
        out["lut_matmul"] = mm
    return {k: v for k, v in out.items() if v}


def rec_backend(cp, be: str):
    """(params, BackendSpec) of backend ``be`` on an index-form tree, the
    lut grid and tables made as ServeEngine makes them (fan-in and
    codebooks from ``_index_form_stats``)."""
    from repro_torch.kernels import dispatch
    from repro_torch.serving.engine import _index_form_stats
    if be != "lut":
        return cp, dispatch.BackendSpec(be)
    _, fan_in, book = _index_form_stats(cp)
    spec = dispatch.make_lut_spec(book, fan_in)
    return dispatch.attach_lut_tables(cp, spec), dispatch.BackendSpec(be, spec)


def rec_greedy(model, params, bk, toks, n_new: int, feed: bool):
    """Greedy continuation through the model handle: the prompt by
    ``prefill`` (``feed``: from ``init_cache``, token by token through
    ``decode``, the hybrid's generation path), then ``n_new`` greedy
    decodes.  Returns the (B, n_new) ids."""
    import torch
    B, S = toks.shape
    if feed:
        cache = model.init_cache(B, S + n_new, dtype=torch.float32,
                                 device=toks.device)
        for t in range(S):
            logits, cache = model.decode(params, toks[:, t:t + 1], cache, bk)
    else:
        logits, cache = model.prefill(params, {"tokens": toks}, bk)
    out = []
    for _ in range(n_new):
        nxt = torch.argmax(logits[:, -1], dim=-1)
        out.append(nxt)
        logits, cache = model.decode(params, nxt[:, None], cache, bk)
    return torch.stack(out, dim=1).cpu()


def recurrent_reduced(dev) -> list:
    """The reduced rwkv6-7b (2 layers) and zamba2-2.7b (4 layers, shared
    every 2), f32, compressed on the CPU at |W| 256 (laplacian_l1, global),
    at act_levels 0 and 32, through dense, codebook and lut: rwkv a 2 × 16
    prompt by prefill, zamba2 the prompt fed through decode from
    init_cache, then 8 greedy decodes; the card's tokens equal the CPU's.
    lut alone may part, where ``first_parting`` finds a half-way tie of its
    activation snap first, as in [moe].  Returns the partings."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import to_codebook_params
    partings = []
    for name in ("rwkv6-7b", "zamba2-2.7b"):
        for lv in (0, ACT_LEVELS):
            cfg = configs.get(name).reduced().replace(act_levels=lv)
            model = build(cfg)
            params = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            wq = cfg.quantized(n_weights=256).wq
            pq, state = cluster_params(params, wq, init_state(wq),
                                       wq.interval)
            cp = to_codebook_params(pq, wq, state)
            cp_dev = _to(cp, dev)
            toks = torch.from_numpy(np.random.default_rng(3).integers(
                1, cfg.vocab, (2, cfg.ssm_chunk)))
            feed = cfg.family == "hybrid"
            for be in BACKENDS:
                run = {d: (lambda d=d, p=p: rec_greedy(
                    model, *rec_backend(p, be), toks.to(d), 8, feed))
                       for d, p in (("cpu", cp), (dev, cp_dev))}
                want, got = run["cpu"](), run[dev]()
                if torch.equal(got, want):
                    continue
                tag = f"[recurrent] reduced {name} act_levels {lv} {be}"
                if be != "lut":
                    raise AssertionError(f"{tag}: card tokens {got.tolist()}"
                                         f" != CPU tokens {want.tolist()}")
                part = first_parting(*(moe_decisions(run[d])
                                       for d in ("cpu", dev)))
                partings.append(f"{name} act_levels {lv} lut")
                log(f"{tag}: card tokens part from the CPU's; the first "
                    f"decision the card takes otherwise is a tie: {part}")
    log("[recurrent] reduced rwkv6-7b (prefill of 2 × 16) and zamba2-2.7b "
        "(the prompt fed through decode), |W| 256, act_levels 0 and 32: "
        "dense/codebook/lut greedy tokens on the card equal the CPU path's"
        + (f", but where a lut snap tie parts them ({', '.join(partings)})"
           if partings else ""))
    return partings


def rec_model(dev, name: str, n_layers: int, tag: str, exclude: str = ""):
    """``name`` at full width, ``n_layers`` of its (decoder) layers, bf16,
    random weights from a seeded generator, at act_levels 32, compressed
    as ``launch/serve.py --compress`` does (laplacian_l1, |W| = N_BOOK,
    global; ``moe_compressed``, ``exclude`` kept out of clustering and the
    index form), and ``core/export.memory_report`` of its index form
    (packed under a third of fp32; the leaves kept float are not in it):
    (model, config, index-form params, the norm scales before clustering
    (``_norm_scales``), figures)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.export import memory_report
    from repro_torch.core.quantizer import codebook_indices, param_filter
    from repro_torch.models.model_zoo import build
    cfg = configs.get(name).replace(n_layers=n_layers, act_levels=ACT_LEVELS)
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, t_init = timed(lambda: model.init(
        torch.Generator(device=dev).manual_seed(0), device=dev))
    n_params = sum(t.numel() for t in _leaves(params))
    norms = _norm_scales(params)
    (pq, cp, state, wq), t_cl = timed(lambda: moe_compressed(cfg, params,
                                                             exclude))
    keep = param_filter(wq)
    n_kept = sum(t.numel() for p, t in _paths(params) if keep("/".join(p)))
    del params
    idx, _ = codebook_indices(pq, wq, state)
    del pq
    rep = memory_report(idx, wq.num_weights, ACT_LEVELS)
    del idx
    if not (rep.n_params == n_kept and rep.packed_bytes
            < rep.fp32_bytes / 3):
        raise AssertionError(f"{tag} memory_report {rep.row()}: want "
                             f"{n_kept} params, packed under a third of "
                             "fp32")
    fig = {"params": n_params, "clustered_params": n_kept, "init_s": t_init,
           "cluster_s": t_cl, "memory_row": rep.row(),
           "packed_bytes": rep.packed_bytes, "fp32_bytes": rep.fp32_bytes,
           "packed_share": rep.packed_bytes / rep.fp32_bytes,
           "build_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f"{tag}: {n_layers} of {configs.get(name).n_layers} layers, "
        f"d={cfg.d_model}, d_ff={cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.dtype}, act_levels {cfg.act_levels}: {n_params} params"
        + (f" ({exclude!r}, {n_params - n_kept} of them, kept float)"
           if exclude else "")
        + f", init {t_init:.2f}s, compress {t_cl:.2f}s; [memory] "
        f"{rep.row()} (packed {fig['packed_share']:.3f} of fp32)")
    return model, cfg, cp, norms, fig


def rec_counted(fn):
    """(fn's result, the kernel launches it made)."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    out = fn()
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] > before[k]}


def rec_check(tag: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, want {want}")


def rec_step_figures(fn, n_tok: int) -> dict:
    """A decode step's wall ms (mean of REC_NEW calls, each synchronized),
    the profiler's device ms, idle share and kernels a step, and tok/s."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(REC_NEW):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / REC_NEW
    busy, top, _, n_k, _ = device_time(fn, top=6)
    return {"step_ms": wall, "device_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall), "kernels": n_k,
            "tok_s": n_tok / wall * 1e3,
            "top": [(k, round(ms, 4), n) for k, ms, n in top]}


def _norm_scales(tree, path=()) -> list:
    """[(path, leaf)] of a tree's norm scales (the leaves named 'scale')."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _norm_scales(v, path + (k,))]
    return [(path, tree)] if path[-1] == "scale" else []


def _with_leaves(tree, leaves):
    """``tree`` with each (path, leaf) of ``leaves`` put in (the dicts on
    those paths copied, every other leaf shared)."""
    out = dict(tree)
    for path, leaf in leaves:
        node = out
        for k in path[:-1]:
            node[k] = node = dict(node[k])
        node[path[-1]] = leaf
    return out


@contextlib.contextmanager
def plain_lut():
    """lut_matmul's wrapper routes card tensors to its plain version: the
    same lut arithmetic with no hand-written kernel (nothing launches,
    nothing is counted)."""
    from repro_torch.kernels import lut_matmul as lm
    cuda = lm.lut_matmul_cuda
    lm.lut_matmul_cuda = lambda a, w, t: lm.lut_matmul_plain(a, w, t)
    try:
        yield
    finally:
        lm.lut_matmul_cuda = cuda


@contextlib.contextmanager
def lut_snaps(out: list):
    """Each snap of activations onto the lut grid (``dispatch.lut_acc``)
    appends (K, N, mean |x|, the snap's relative error ‖x̂ − x‖ / ‖x‖) to
    ``out``."""
    import torch
    from repro_torch.kernels import dispatch
    acc = dispatch.lut_acc

    def spy(x2, w_idx, codebook, spec, table=None):
        x = x2.float()
        a = torch.clamp(torch.round((x - spec.a_min) / spec.da), 0,
                        spec.levels - 1)
        err = (spec.a_min + a * spec.da - x).norm() / x.norm().clamp(
            min=1e-30)
        out.append((*w_idx.shape, float(x.abs().mean()), float(err)))
        return acc(x2, w_idx, codebook, spec, table)
    dispatch.lut_acc = spy
    try:
        yield
    finally:
        dispatch.lut_acc = acc


def rec_f32_agreement(tag: str, cfg, cp, norms, toks) -> dict:
    """The same index-form weights in f32 (``_to_f32``) at act_levels 0:
    each backend's last logits of ``forward`` over ``toks`` against
    dense's.  In bf16 at act_levels 32 the backends part at activation
    level flips (a rounding moves a gate across a level boundary, and the
    step is 6/31).  Here codebook differs from dense only in the order of
    its f32 sums (and, in RWKV's scan, at the ties of its bf16 streams), so
    its logits must fall within 1 % of their range.  lut's distance is
    reported with readings that place it: the lut forward over the first
    prompt's first 16 tokens against the same forward on lut_matmul's
    plain version (``plain_lut``; the same index tree and lut spec), which
    must agree within 1e-4 of the range at every position (that forward's
    launches, ``compare_launches``, are not the path's); lut's distance
    from dense with the norm scales given back their values before
    clustering (``norms``: ``cluster_params`` snaps them onto the weights'
    codebook, as the reference's does); and the relative error of each
    snap of activations onto the lut grid (``lut_snaps``), the worst
    sites."""
    import torch
    from repro_torch.models.model_zoo import build
    m32 = build(cfg.replace(dtype="float32", act_levels=0))

    def last(tree, bes):
        out = {}
        for be in bes:
            params, bk = rec_backend(tree, be)
            out[be] = m32.forward(params, {"tokens": toks}, bk)[:, -1]
            del params
        return out
    p32 = _to_f32(cp)
    snaps = []
    with lut_snaps(snaps):
        first = last(p32, BACKENDS)
    worst = sorted(snaps, key=lambda r: -r[3])[:3]
    rng_ = float(first["dense"].max() - first["dense"].min())
    gaps = {be: float((first[be] - first["dense"]).abs().max())
            for be in ("codebook", "lut")}
    if not gaps["codebook"] <= 0.01 * rng_:
        raise AssertionError(f"{tag} f32: codebook logits {gaps['codebook']} "
                             f"from dense's, over 1 % of their range {rng_}")
    params, bk = rec_backend(p32, "lut")
    short = {"tokens": toks[:1, :16]}
    kern, compared = rec_counted(lambda: m32.forward(params, short, bk))
    with plain_lut():
        plain = m32.forward(params, short, bk)
    plain_gap = float((kern - plain).abs().max())
    if not plain_gap <= 1e-4 * rng_:
        raise AssertionError(f"{tag} f32: the lut forward {plain_gap} from "
                             "the same forward on lut_matmul's plain version")
    del params, kern, plain
    unsnapped = last(_to_f32(_with_leaves(cp, norms)), ("dense", "lut"))
    un_rng = float(unsnapped["dense"].max() - unsnapped["dense"].min())
    un_gap = float((unsnapped["lut"] - unsnapped["dense"]).abs().max())
    log(f"{tag} f32, the same weights, act_levels 0: last logits against "
        f"dense max |Δ| codebook {gaps['codebook']:.2e}, lut "
        f"{gaps['lut']:.4f} (dense range {rng_:.2f}; codebook within 1 %); "
        f"the lut forward over 1 × 16 tokens on lut_matmul's plain version "
        f"within {plain_gap:.2e} of the kernel's (limit {1e-4 * rng_:.2e}); "
        f"with the {len(norms)} norm scales unsnapped, lut {un_gap:.4f} from "
        f"dense (dense range {un_rng:.2f}); the {len(snaps)} snaps onto the "
        f"lut grid (step {bk.lut_spec.da:.5f}), worst relative errors "
        + ", ".join(f"{e:.4f} at {k}×{n} (mean |x| {m:.4f})"
                    for k, n, m, e in worst)
        + f", median {sorted(r[3] for r in snaps)[len(snaps) // 2]:.4f}")
    return {"f32_gap_to_dense": gaps, "f32_dense_range": rng_,
            "f32_lut_vs_plain": plain_gap, "f32_lut_snaps_worst": worst,
            "compare_launches": compared,
            "f32_unsnapped_norms": {"lut_gap_to_dense": un_gap,
                                    "dense_range": un_rng}}


def rec_decode_vs_forward(tag: str, cfg, cp, toks) -> float:
    """The reference's decode-against-forward bound, in f32 at act_levels
    0 on dense: the whole prompts fed through ``decode`` from
    ``init_cache``, logits within 2e-2 of ``forward``'s at every position.
    Returns the largest distance."""
    import torch
    from repro_torch.models.model_zoo import build
    m32, p32 = build(cfg.replace(dtype="float32", act_levels=0)), _to_f32(cp)
    B, S = toks.shape
    fwd = m32.forward(p32, {"tokens": toks})
    cache = m32.init_cache(B, S, dtype=torch.float32, device=toks.device)
    worst = 0.0
    for i in range(S):
        logits, cache = m32.decode(p32, toks[:, i:i + 1], cache)
        worst = max(worst, float((logits[:, 0] - fwd[:, i]).abs().max()))
    if not worst < 2e-2:
        raise AssertionError(f"{tag} f32 decode logits {worst} from "
                             "forward's (the reference's bound is 2e-2)")
    log(f"{tag} f32, act_levels 0, dense: the {S}-token prompts fed through "
        f"decode from init_cache give logits within {worst:.2e} of "
        "forward's at every position (the reference's bound 2e-2)")
    return worst


def rec_full(dev, name: str, n_layers: int, seed: int) -> dict:
    """``name`` at full width, ``n_layers`` of its layers (``rec_model``):
    REC_BATCH prompts of REC_PLEN tokens (one chunk) on each backend, by
    ``prefill`` and by ``forward`` (the hybrid's prefill is its forward's
    last logits and a zero cache, the reference's quirk), their last
    logits within 1e-3; then REC_NEW decodes, RWKV's greedy from
    prefill's cache, the hybrid's from ``init_cache`` with the prompts'
    first tokens fed (its generation path); the launches of each call held
    exactly to ``rec_launches``; prefill and forward ms, the decode step's
    figures, peak memory; the prompt's last logits of codebook and lut
    against dense's, and in f32 (``rec_f32_agreement``); for the hybrid,
    decode against forward in f32 (``rec_decode_vs_forward``)."""
    import numpy as np
    import torch
    tag = f"[recurrent] {name}"
    model, cfg, cp, norms, fig = rec_model(dev, name, n_layers, tag)
    S, feed = REC_PLEN[name], cfg.family == "hybrid"
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (REC_BATCH, S))).to(dev)
    batch, first = {"tokens": toks}, {}
    for be in BACKENDS:
        params, bk = rec_backend(cp, be)
        want = rec_launches(cfg, be)
        model.prefill(params, batch, bk)                     # warm
        torch.cuda.reset_peak_memory_stats()
        ((logits, cache), pre_s), n = rec_counted(lambda: timed(
            lambda: model.prefill(params, batch, bk)))
        rec_check(f"{tag} {be} prefill", n, want)
        first[be] = logits[:, -1].float()
        (fwd, fwd_s), n = rec_counted(lambda: timed(
            lambda: model.forward(params, batch, bk)))
        rec_check(f"{tag} {be} forward", n, want)
        fwd_gap = float((fwd[:, -1] - first[be]).abs().max())
        if not fwd_gap <= 1e-3:
            raise AssertionError(f"{tag} {be}: forward's last logits "
                                 f"{fwd_gap} from prefill's")
        del fwd
        if feed:
            cache = model.init_cache(REC_BATCH, S + REC_NEW, device=dev)
        ids = []
        t = time.perf_counter()
        for i in range(REC_NEW):
            nxt = (toks[:, i:i + 1] if feed
                   else torch.argmax(logits[:, -1], dim=-1)[:, None])
            ids.append(nxt)
            (logits, cache), n = rec_counted(
                lambda: model.decode(params, nxt, cache, bk))
            rec_check(f"{tag} {be} decode", n, want)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{tag} {be}: logits not finite")
        step = rec_step_figures(
            lambda: model.decode(params, nxt, cache, bk), REC_BATCH)
        gap = float((first[be] - first["dense"]).abs().max())
        rng_ = float(first["dense"].max() - first["dense"].min())
        fig[be] = {"prefill_ms": pre_s * 1e3, "forward_ms": fwd_s * 1e3,
                   "launches": want, "forward_gap": fwd_gap,
                   "loop_tok_s": REC_BATCH * REC_NEW / loop_s,
                   "gap_to_dense": gap, "dense_range": rng_, "step": step,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if not feed:
            fig[be]["tokens"] = torch.cat(ids, 1)[0].tolist()
        log(f"{tag} {be}: prefill {REC_BATCH} × {S} {pre_s * 1e3:.1f} ms, "
            f"forward {fwd_s * 1e3:.1f} ms; launches a prefill, a forward "
            f"and a decode step {want}, exact; forward's last logits within "
            f"{fwd_gap:.2e} of prefill's; {REC_NEW} decodes "
            f"{'feeding the prompts from init_cache' if feed else 'greedy'} "
            f"{fig[be]['loop_tok_s']:.1f} tok/s; decode step wall "
            f"{step['step_ms']:.2f} ms, device busy {step['device_ms']:.3f} "
            f"ms (idle share {step['idle_share']:.3f}), {step['kernels']} "
            f"kernels, {step['tok_s']:.1f} tok/s; prompt's last logits vs "
            f"dense max |Δ| {gap:.4f} (dense range {rng_:.2f}); peak "
            f"allocated {fig[be]['peak_gib']:.2f} GiB; top {step['top']}")
        del params, cache, logits
    fig.update(rec_f32_agreement(tag, cfg, cp, norms, toks))
    if feed:
        fig["f32_decode_vs_forward"] = rec_decode_vs_forward(tag, cfg, cp,
                                                             toks)
    return fig


def recurrent_path(dev, smi: str) -> tuple[dict, dict]:
    """The [recurrent] phase: ``recurrent_reduced``, then ``rec_full`` of
    rwkv6-7b (4 of 32 layers) and zamba2-2.7b (12 of 54: two groups of
    six Mamba2 blocks, each after the shared block).  Returns the figures
    and the phase's launches."""
    import torch
    from repro_torch.kernels import ops
    t0 = time.time()
    ops.reset_launch_counts()
    stats = {"partings": recurrent_reduced(dev),
             "reduced_s": time.time() - t0}
    stats["rwkv6-7b"] = rec_full(dev, "rwkv6-7b", 4, 5)
    freed("[recurrent] rwkv6-7b")
    stats["zamba2-2.7b"] = rec_full(dev, "zamba2-2.7b", 12, 6)
    freed("[recurrent] zamba2-2.7b")
    launches = ops.launch_counts()
    for name in ("rwkv6-7b", "zamba2-2.7b"):
        for k, v in stats[name]["compare_launches"].items():
            launches[k] -= v
    stats["phase_s"] = time.time() - t0
    torch.cuda.empty_cache()
    log(f"[recurrent] {smi}: phase {stats['phase_s']:.1f}s (reduced against "
        f"the CPU {stats['reduced_s']:.1f}s); launches {launches}")
    return stats, launches


# --- [families]: the encoder-decoder (whisper) and the M-RoPE vlm ------------

FAM_BATCH = 4                    # rows of a full-width run
FAM_NEW = 16                     # greedy decodes a backend at full width
FAM_PROMPT = 32                  # whisper's decoder prompt
VLM_LAYERS = 4                   # qwen2-vl-7b's 28 layers, cut for memory
VLM_LAYOUT = (8, (1, 8, 12), 24)  # text, a t × h × w patch grid, text
VLM_PROMPT = 8 + 8 * 12 + 24     # 128 positions
FAM_REDUCED_NEW = 8


def mrope_positions(B: int, text: int, grid: tuple, tail: int, dev):
    """(3, B, L) int32 M-RoPE positions as Qwen2-VL lays them out: ``text``
    tokens at t = h = w = i, a t × h × w patch grid from the next position,
    each stream stepping along its own axis, then ``tail`` text tokens from
    one past the grid's largest position."""
    import torch
    rows = [(i, i, i) for i in range(text)]
    rows += [(text + t, text + h, text + w) for t in range(grid[0])
             for h in range(grid[1]) for w in range(grid[2])]
    nxt = text + max(grid)
    rows += [(nxt + j,) * 3 for j in range(tail)]
    pos = torch.tensor(rows, dtype=torch.int32, device=dev).T      # (3, L)
    return pos[:, None].expand(3, B, pos.shape[1]).contiguous()


def fam_batch(cfg, B: int, S: int, seed: int, dev) -> dict:
    """Seeded prompt inputs: tokens; whisper's (B, enc_len, d) frames (the
    reference's stub of a conv front end); the vlm's (B, S, d) embeddings
    and its M-RoPE positions (``VLM_LAYOUT`` at full width, 2 text tokens,
    a 1 × 2 × 2 grid and text when reduced)."""
    import torch
    from repro_torch.models.transformer import _dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    b = {"tokens": torch.randint(1, cfg.vocab, (B, S), generator=g,
                                 device=dev)}
    if cfg.family == "audio":
        b["frames"] = torch.randn((B, cfg.enc_len, cfg.d_model), generator=g,
                                  device=dev).to(_dtype(cfg))
    if cfg.family == "vlm":
        b["embeds"] = (torch.randn((B, S, cfg.d_model), generator=g,
                                   device=dev) * 0.5).to(_dtype(cfg))
        text, grid, tail = (VLM_LAYOUT if S == VLM_PROMPT
                            else (2, (1, 2, 2), S - 6))
        b["positions"] = mrope_positions(B, text, grid, tail, dev)
    return b


def fam_grow(cache: dict, n: int) -> dict:
    """The prefill's cache with ``n`` free rows after the prompt's in its
    K/V planes, as a cache of ``max_len`` holds them (a prefill's planes
    end at the prompt)."""
    import torch
    return {**cache, "kv": {k: torch.cat(
        [v, v.new_zeros(v.shape[:2] + (n,) + v.shape[3:])], dim=2)
        for k, v in cache["kv"].items()}}


def fam_greedy(model, params, bk, batch: dict, n_new: int):
    """Prefill, then ``n_new`` greedy decodes on the cache grown to hold
    them: (the (B, n_new) ids, [the prefill's and every decode's logits]),
    on the host."""
    import torch
    logits, cache = model.prefill(params, batch, bk)
    cache = fam_grow(cache, n_new)
    ids, seen = [], [logits.float().cpu()]
    for _ in range(n_new):
        nxt = torch.argmax(logits[:, -1], dim=-1)
        ids.append(nxt)
        logits, cache = model.decode(params, nxt[:, None], cache, bk)
        seen.append(logits.float().cpu())
    return torch.stack(ids, dim=1).cpu(), seen


def families_reduced(dev) -> list:
    """The reduced whisper-small (2 + 2 layers, enc_len 16) and
    qwen2-vl-7b (2 layers, sections (4, 6, 6)), f32, act_levels 32,
    compressed on the CPU at |W| 256 (laplacian_l1, global), through
    dense, codebook and lut: a 2 × 8 prompt by prefill and 8 greedy
    decodes, card against CPU: tokens equal and every logit within 1e-3.
    lut alone may part, where ``first_parting`` finds a half-way tie of its
    activation snap first, as in [moe].  Returns the partings."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import to_codebook_params
    partings, worst = [], 0.0
    for name in ("whisper-small", "qwen2-vl-7b"):
        cfg = configs.get(name).reduced().replace(act_levels=ACT_LEVELS)
        model = build(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        wq = cfg.quantized(n_weights=256).wq
        pq, state = cluster_params(params, wq, init_state(wq), wq.interval)
        cp = to_codebook_params(pq, wq, state)
        cp_dev = _to(cp, dev)
        batch = fam_batch(cfg, 2, 8, 3, "cpu")
        for be in BACKENDS:
            run = {d: (lambda d=d, p=p: fam_greedy(
                model, *rec_backend(p, be), _to(batch, d), FAM_REDUCED_NEW))
                   for d, p in (("cpu", cp), (dev, cp_dev))}
            (want, wl), (got, gl) = run["cpu"](), run[dev]()
            gap = max(float((a - b).abs().max()) for a, b in zip(gl, wl))
            if torch.equal(got, want) and gap <= 1e-3:
                worst = max(worst, gap)
                continue
            tag = f"[families] reduced {name} {be}"
            if be != "lut":
                raise AssertionError(f"{tag}: card tokens {got.tolist()} "
                                     f"(CPU {want.tolist()}), logits {gap} "
                                     "apart")
            part = first_parting(*(moe_decisions(run[d])
                                   for d in ("cpu", dev)))
            partings.append(f"{name} lut")
            log(f"{tag}: card parts from the CPU (logits {gap:.2e}); the "
                f"first decision the card takes otherwise is a tie: {part}")
    log("[families] reduced whisper-small and qwen2-vl-7b, |W| 256, "
        "act_levels 32: dense/codebook/lut greedy tokens on the card equal "
        f"the CPU path's, every logit within {worst:.2e} (limit 1e-3)"
        + (f", but where a lut snap tie parts them ({', '.join(partings)})"
           if partings else ""))
    return partings


def fam_launches(cfg, be: str, what: str) -> dict:
    """Kernel launches of one call at act_levels > 0, from the layer
    structure.  whisper: an encoder layer's wq, wk, wv, wo, w1, w2 and one
    act_quant (relu6 for gelu, no multiplier); a decoder layer's
    self-attention (4), cross-attention (wq, wk and wv over the memory, wo)
    and MLP (2), and one act_quant; the tied logits plain.  A prefill runs
    the encoder and the decoder, a decode step the decoder.  qwen2-vl: a
    layer's wq, wk, wv, wo, w2 and its w1/w3 as one gated launch on
    codebook, else two matmuls and one act_quant with its multiplier; the
    untied head one matmul."""
    L = cfg.n_layers
    if cfg.family == "audio":
        enc = cfg.enc_layers if what == "prefill" else 0
        mm, aq, gated = 6 * enc + 10 * L, enc + L, 0
    else:
        mm, aq, gated = 5 * L + 1, 0, L
        if be != "codebook":
            mm, aq, gated = mm + 2 * L, L, 0
    out = {"act_quant": aq}
    if be == "codebook":
        out.update(codebook_matmul=mm, codebook_swiglu=gated)
    elif be == "lut":
        out["lut_matmul"] = mm
    return {k: v for k, v in out.items() if v}


# new shapes the kernels take on this phase's paths, each held against its
# plain version on the path's own inputs (``fam_record``)
def fam_new_shape(kernel: str, shape: tuple) -> bool:
    """Rows of an encoder (B × enc_len), a vocabulary-wide head at decode
    rows, or the vlm's gated FFN."""
    M, K, N = shape
    if kernel == "act_quant":
        return M >= 1000
    if kernel == "codebook_swiglu":
        return K == 3584
    return (M >= 1000 and N < 100_000) or (N >= 100_000 and M <= 16)


@contextlib.contextmanager
def fam_record(keep: dict):
    """The first call of each kernel at each new shape (``fam_new_shape``)
    through ``ops`` on card tensors: its inputs and its output, kept in
    ``keep[(kernel, (M, K, N))]``.  The wrappers and their launch counts
    stay the kernels' own."""
    from repro_torch.kernels import ops
    orig = {k: getattr(ops, k) for k in ("codebook_matmul", "lut_matmul",
                                         "codebook_swiglu", "_act_quant")}

    def spy(kernel, fn, shape_of):
        def call(*args, **kw):
            out = fn(*args, **kw)
            shape = shape_of(*args)
            key = (kernel, shape)
            if (args[0].is_cuda and key not in keep
                    and fam_new_shape(kernel, shape)):
                keep[key] = (args, kw, out)
            return out
        return call
    ops.codebook_matmul = spy("codebook_matmul", orig["codebook_matmul"],
                              lambda x, w, *_: (*x.shape, w.shape[1]))
    ops.lut_matmul = spy("lut_matmul", orig["lut_matmul"],
                         lambda a, w, *_: (*a.shape, w.shape[1]))
    ops.codebook_swiglu = spy("codebook_swiglu", orig["codebook_swiglu"],
                              lambda x, w1, *_: (*x.shape, w1.shape[1]))
    ops._act_quant = spy("act_quant", orig["_act_quant"],
                         lambda x, *_: (x.reshape(-1, x.shape[-1]).shape[0],
                                        x.shape[-1], 0))
    try:
        yield
    finally:
        for k, f in orig.items():
            setattr(ops, k, f)


def fam_parity(keep: dict, peaks: dict) -> list:
    """Each recorded call (``fam_record``) held against the plain version
    on its own inputs, run again bit-identical, and timed: codebook_matmul
    within ``parity_tolerance``; lut_matmul bit-exact; act_quant bit-equal
    but for level-boundary ties (``parity_ties``); codebook_swiglu
    bit-equal to the unfused chain of CUDA launches, relu6 to the plain
    epilogue of its accumulators, and those accumulators within the
    codebook limit of the plain product.  Kernel, plain and library ms by
    CUDA events, the bound from the bytes each input read once and the
    output written once, or the operations at the card's peak for their
    type.  Returns a row for each."""
    import torch
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm
    rows = []
    for (kernel, shape), (args, kw, out) in sorted(keep.items()):
        M, K, N = shape
        tag = f"[families] {kernel} {M}×{K}×{N}"
        lib = None
        if kernel == "codebook_matmul":
            x, wi, book = args
            want = cm.codebook_matmul_plain(x, wi, book)
            tol = cm.parity_tolerance(x, wi, book)
            share = float(((out - want).abs() / tol).max())
            again = cm.codebook_matmul_cuda(x, wi, book)
            if share > 1 or not torch.equal(again, out):
                raise AssertionError(f"{tag}: {share:.3f} of the limit, or "
                                     "a second run differs")
            err = float((out - want).abs().max())
            ms = time_ms(lambda: cm.codebook_matmul_cuda(x, wi, book))
            plain = time_ms(lambda: cm.codebook_matmul_plain(x, wi, book),
                            reps=5)
            w_deq = book[wi.long()].to(x.dtype)
            lib = time_ms(lambda: torch.matmul(x, w_deq))
            nbytes = (x.numel() * x.element_size() + wi.numel()
                      * wi.element_size() + book.numel() * 4 + M * N * 4)
            ops_ = 2 * M * K * N / peaks["bf16" if x.dtype == torch.bfloat16
                                         else "f32"]
            detail = f"share of the limit {share:.4f}"
        elif kernel == "lut_matmul":
            a, wi, tab = args
            want = lm.lut_matmul_plain(a, wi, tab)
            again = lm.lut_matmul_cuda(a, wi, tab)
            if not (torch.equal(out, want) and torch.equal(again, out)):
                raise AssertionError(f"{tag}: not bit-exact, or a second "
                                     "run differs")
            err = 0.0
            slow = M * K * N > 1e10
            ms = time_ms(lambda: lm.lut_matmul_cuda(a, wi, tab),
                         reps=3 if slow else 10, warm=1)
            plain = time_ms(lambda: lm.lut_matmul_plain(a, wi, tab), reps=1,
                            warm=0)
            # the table entries these inputs address (K chunks of 64 rows)
            C = tab.shape[1]
            touched = torch.zeros(tab.numel(), dtype=torch.bool,
                                  device=a.device)
            kc = max(1, (1 << 27) // (M * N))
            for k0 in range(0, K, kc):
                addr = (a[:, k0:k0 + kc, None].long() * C
                        + wi[None, k0:k0 + kc, :].long() % C)
                touched[addr.reshape(-1).clamp(0, tab.numel() - 1)] = True
            nbytes = (a.numel() * 4 + wi.numel() * wi.element_size()
                      + int(touched.sum()) * 4 + M * N * 4)
            ops_ = 2 * M * K * N / peaks["int32"]
            detail = "bit-exact"
        elif kernel == "act_quant":
            x, kind, levels, form, with_index = args[:5]
            mul = args[5] if len(args) > 5 else kw.get("mul")
            y, idx = out
            if idx is None:
                y2, idx = aq.act_quant_cuda(x, kind, levels, form=form,
                                            mul=mul)
                if not torch.equal(y2, y):
                    raise AssertionError(f"{tag}: a second run differs")
            ref = aq.act_quant_plain(x, kind, levels, form=form, mul=mul)
            ties = aq.parity_ties(y, idx, *ref, kind, levels, mul=mul)
            err = float((y.float() - ref[0].float()).abs().max())
            ms = time_ms(lambda: aq.act_quant_cuda(
                x, kind, levels, form=form, with_index=with_index, mul=mul))
            plain = time_ms(lambda: aq.act_quant_plain(
                x, kind, levels, form=form, with_index=with_index, mul=mul),
                reps=5)
            io = 3 if mul is not None else 2
            nbytes = io * x.numel() * x.element_size() \
                + (x.numel() * 4 if with_index else 0)
            ops_ = 8 * x.numel() / peaks["f32"]
            detail = f"{kind} |A| {levels}, {ties} ties"
        else:
            x, w1, b1, w3, b3, kind, levels = args
            gs = cm.codebook_matmul_cuda(x, w1, b1)
            us = cm.codebook_matmul_cuda(x, w3, b3)
            chain = aq.act_quant_cuda(gs.to(x.dtype), kind, levels,
                                      form="act_apply", with_index=False,
                                      mul=us.to(x.dtype))[0]
            again = cm.codebook_swiglu_cuda(x, w1, b1, w3, b3, kind, levels)
            epi = cm.swiglu_epilogue_plain(gs, us, x.dtype, kind, levels)
            share = max(float(((s - cm.codebook_matmul_plain(x, w, b)).abs()
                               / cm.parity_tolerance(x, w, b)).max())
                        for s, w, b in ((gs, w1, b1), (us, w3, b3)))
            if not (torch.equal(out, chain) and torch.equal(again, out)
                    and torch.equal(out, epi) and share <= 1):
                raise AssertionError(f"{tag}: differs from the unfused "
                                     "chain, the plain epilogue or a second "
                                     f"run, or its sums {share:.3f} of the "
                                     "limit")
            err = float((out.float() - epi.float()).abs().max())
            ms = time_ms(lambda: cm.codebook_swiglu_cuda(x, w1, b1, w3, b3,
                                                          kind, levels))
            plain = time_ms(lambda: cm.codebook_swiglu_plain(
                x, w1, b1, w3, b3, kind, levels), reps=5)
            nbytes = (x.numel() * x.element_size() + 2 * w1.numel()
                      * w1.element_size() + 8 * b1.numel()
                      + M * N * x.element_size())
            ops_ = 4 * M * K * N / peaks["bf16"]
            detail = (f"= the unfused chain and the plain epilogue, sums at "
                      f"{share:.4f} of the limit")
        b_bytes = nbytes / peaks["bytes"]
        row = {"kernel": kernel, "M": M, "K": K, "N": N, "ms": ms,
               "plain_ms": plain, "library_ms": lib, "max_abs_err": err,
               "bound_ms": 1e3 * max(b_bytes, ops_),
               "bound_by": "bytes" if b_bytes >= ops_ else "operations"}
        rows.append(row)
        log(f"{tag}: on the path's own inputs {detail}, max abs err "
            f"{err:.3e}; kernel {ms:.4f} ms, plain {plain:.3f} ms"
            + (f", torch.matmul {lib:.4f} ms" if lib is not None else "")
            + f", bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return rows


def bf16_steps(a, b) -> int:
    """The largest distance of two tensors, element by element, in steps
    of bf16 at the larger magnitude of the pair."""
    import torch
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return int(torch.ceil((a - b).abs() / step).max())


def fam_full(dev, name: str, n_layers: int, exclude: str, S: int,
             seed: int) -> dict:
    """``name`` at full width (``rec_model``): FAM_BATCH prompts of ``S``
    tokens (whisper: with 1500 seeded frames a row; the vlm: seeded
    embeddings with ``VLM_LAYOUT``'s M-RoPE positions) on each backend:
    the encoder alone (whisper), the prefill and ``forward``, their last
    logits within 1e-3; FAM_NEW greedy decodes; the launches of each call
    held exactly to ``fam_launches``; the decode step's figures, peak
    memory; the prompt's last logits of codebook and lut against
    dense's."""
    import torch
    from repro_torch.models import transformer as T
    tag = f"[families] {name}"
    model, cfg, cp, _, fig = rec_model(dev, name, n_layers, tag, exclude)
    batch = fam_batch(cfg, FAM_BATCH, S, seed, dev)
    first = {}
    for be in BACKENDS:
        params, bk = rec_backend(cp, be)
        want_pre = fam_launches(cfg, be, "prefill")
        want_step = fam_launches(cfg, be, "decode")
        model.prefill(params, batch, bk)                     # warm
        torch.cuda.reset_peak_memory_stats()
        enc_s = None
        if cfg.family == "audio":
            _, enc_s = timed(lambda: T._encoder(params, cfg, batch["frames"],
                                                bk))
        ((logits, cache), pre_s), n = rec_counted(lambda: timed(
            lambda: model.prefill(params, batch, bk)))
        rec_check(f"{tag} {be} prefill", n, want_pre)
        first[be] = logits[:, -1, :cfg.vocab].float()    # padding masked
        (fwd, fwd_s), n = rec_counted(lambda: timed(
            lambda: model.forward(params, batch, bk)))
        rec_check(f"{tag} {be} forward", n, want_pre)
        last = fwd[:, -1, :cfg.vocab]
        fwd_gap = float((last - first[be]).abs().max())
        # the tied logits are f32 products; an untied head gives bf16
        # values, whose f32 sums over all positions (forward) and over the
        # last ones (prefill) may round one bf16 step apart
        steps = None if cfg.tie_embeddings else bf16_steps(last, first[be])
        if not (fwd_gap <= 1e-3 if steps is None else steps <= 1):
            raise AssertionError(f"{tag} {be}: forward's last logits "
                                 f"{fwd_gap} ({steps} bf16 steps) from "
                                 "prefill's")
        del fwd, last
        cache = fam_grow(cache, FAM_NEW + 1)
        ids = []
        t = time.perf_counter()
        for _ in range(FAM_NEW):
            nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
            ids.append(nxt)
            (logits, cache), n = rec_counted(
                lambda: model.decode(params, nxt, cache, bk))
            rec_check(f"{tag} {be} decode", n, want_step)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t
        if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
            raise AssertionError(f"{tag} {be}: logits not finite")
        step = rec_step_figures(
            lambda: model.decode(params, nxt, cache, bk), FAM_BATCH)
        gap = float((first[be] - first["dense"]).abs().max())
        rng_ = float(first["dense"].max() - first["dense"].min())
        fig[be] = {"prefill_ms": pre_s * 1e3, "forward_ms": fwd_s * 1e3,
                   "encoder_ms": None if enc_s is None else enc_s * 1e3,
                   "launches_prefill": want_pre, "launches_step": want_step,
                   "forward_gap": fwd_gap, "forward_gap_bf16_steps": steps,
                   "loop_tok_s": FAM_BATCH * FAM_NEW / loop_s,
                   "gap_to_dense": gap, "dense_range": rng_, "step": step,
                   "tokens": torch.cat(ids, 1)[0].tolist(),
                   "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"{tag} {be}: "
            + (f"encoder {FAM_BATCH} × {cfg.enc_len} {enc_s * 1e3:.1f} ms, "
               if enc_s is not None else "")
            + f"prefill {FAM_BATCH} × {S} {pre_s * 1e3:.1f} ms, forward "
            f"{fwd_s * 1e3:.1f} ms; launches a prefill {want_pre} and a "
            f"decode step {want_step}, exact; forward's last logits within "
            f"{fwd_gap:.2e}" + ("" if steps is None else f" ({steps} bf16 "
                                "steps)") + f" of prefill's; {FAM_NEW} "
            f"greedy decodes "
            f"{fig[be]['loop_tok_s']:.1f} tok/s; decode step wall "
            f"{step['step_ms']:.2f} ms, device busy {step['device_ms']:.3f} "
            f"ms (idle share {step['idle_share']:.3f}), {step['kernels']} "
            f"kernels, {step['tok_s']:.1f} tok/s; prompt's last logits vs "
            f"dense max |Δ| {gap:.4f} (dense range {rng_:.2f}); peak "
            f"allocated {fig[be]['peak_gib']:.2f} GiB; top {step['top']}")
        del params, cache, logits
    return fig


def families_path(dev, smi: str, peaks: dict) -> tuple[dict, dict]:
    """The [families] phase: ``families_reduced``, then ``fam_full`` of
    whisper-small (12 + 12 layers, enc_len 1500, ``exclude="enc_pos"``: the
    compressed table raises ``KeyError`` in the encoder, as the
    reference's does) over 4 × 32 tokens and qwen2-vl-7b (4 of 28 layers)
    over 4 × 128 embeddings, launches read; then each kernel at each new
    shape these paths gave it held against its plain version on the
    path's own inputs (``fam_parity``, not counted).  Returns the figures
    and the phase's launches."""
    import torch
    from repro_torch.kernels import ops
    t0 = time.time()
    ops.reset_launch_counts()
    keep = {}
    with fam_record(keep):
        stats = {"partings": families_reduced(dev),
                 "reduced_s": time.time() - t0}
        stats["whisper-small"] = fam_full(dev, "whisper-small", 12,
                                          "enc_pos", FAM_PROMPT, 7)
        freed("[families] whisper-small")
        stats["qwen2-vl-7b"] = fam_full(dev, "qwen2-vl-7b", VLM_LAYERS, "",
                                        VLM_PROMPT, 8)
    launches = ops.launch_counts()
    t1 = time.time()
    stats["new_shapes"] = fam_parity(keep, peaks)
    del keep
    freed("[families] qwen2-vl-7b")
    want = {("codebook_matmul", 6000), ("lut_matmul", 6000),
            ("act_quant", 6000), ("codebook_matmul", 152064),
            ("lut_matmul", 152064), ("codebook_swiglu", 18944)}
    seen = {(r["kernel"], r["M"]) for r in stats["new_shapes"]} | {
        (r["kernel"], r["N"]) for r in stats["new_shapes"]}
    if not want <= seen:
        raise AssertionError(f"[families] new shapes not seen: "
                             f"{sorted(want - seen)}")
    stats["parity_s"] = time.time() - t1
    stats["phase_s"] = time.time() - t0
    torch.cuda.empty_cache()
    log(f"[families] {smi}: phase {stats['phase_s']:.1f}s (reduced against "
        f"the CPU {stats['reduced_s']:.1f}s, new shapes "
        f"{stats['parity_s']:.1f}s); launches {launches}")
    return stats, launches


# --- [paper]: the §4 integer engine and the paper's own nets -----------------

PAPER_MLP = (784, [128, 128], 10)        # benchmarks/memory_savings.py's MLP
PAPER_MLP_BATCH = 256
PAPER_BATCH = 32                         # AlexNet images a forward
PAPER_CPU_BATCH = 4                      # of them, also run on the CPU
PAPER_IMG = 224                          # the paper's ImageNet side
PAPER_W = 1000                           # |W| of both k-means codebooks
PAPER_LOCK_REL = 1e-4    # locked AlexNet sites: card input vs CPU, of max |x|
# (M, K, N) of every lut_matmul launch of the phase: the MLP's three
# layers, and the AlexNet head's f6, f7, f8
PAPER_LUT_SHAPES = ((PAPER_MLP_BATCH, 784, 128), (PAPER_MLP_BATCH, 128, 128),
                    (PAPER_MLP_BATCH, 128, 10), (PAPER_BATCH, 50176, 1024),
                    (PAPER_BATCH, 1024, 1024), (PAPER_BATCH, 1024, 1000))


def paper_tables(book, kind: str, fan_in: int):
    """The §4 tables of a codebook (a tensor) at |A| = ACT_LEVELS: tanh with
    4096 table entries, relu6 with its identity table."""
    from repro_torch.core.activations import ActQuantConfig
    from repro_torch.core.lut import LutConfig, build_tables
    return build_tables(book.cpu().numpy(), LutConfig(
        ActQuantConfig(kind, ACT_LEVELS),
        table_entries=4096 if kind == "tanh" else 0), fan_in=fan_in)


def paper_parity(dev) -> int:
    """lut_matmul on the §4 table (33 × 1001 int32: rows of 4004 bytes,
    which the smem route stages word by word) at every (M, K, N) the phase
    launches, random row ids in [0, 33) and column ids in [0, 1001) (the
    identity column too), on the planned route and each route forced:
    bit-exact against the plain version, and twice bit-identical.
    Returns the launches."""
    import torch
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels._common import is_aligned
    g = torch.Generator(device=dev).manual_seed(26)
    book = torch.sort(torch.randn(PAPER_W, generator=g, device=dev)
                      * 0.05).values
    n = 0
    for M, K, N in PAPER_LUT_SHAPES:
        kind = "tanh" if M == PAPER_MLP_BATCH else "relu6"
        tabs = paper_tables(book, kind, K + 1)
        tab = torch.from_numpy(tabs.mult).to(dev)
        if tuple(tab.shape) != (ACT_LEVELS + 1, PAPER_W + 1) \
                or is_aligned(tab, tab.shape[1]):
            raise AssertionError(f"§4 table {tuple(tab.shape)}: want 33 × "
                                 "1001 with rows off 16-byte boundaries")
        a = torch.randint(0, ACT_LEVELS + 1, (M, K), generator=g, device=dev,
                          dtype=torch.int32)
        w = torch.randint(0, PAPER_W + 1, (K, N), generator=g, device=dev
                          ).to(torch.int16)
        want = lm.lut_matmul_plain(a, w, tab)
        for route, plan in lut_plans(a, w, tab):
            got = lm.lut_matmul_cuda(a, w, tab, plan=plan)
            again = lm.lut_matmul_cuda(a, w, tab, plan=plan)
            n += 2
            if not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(
                    f"[paper] lut_matmul {route} M={M} K={K} N={N} on the "
                    "§4 table: not bit-exact, or two runs differ")
    log(f"[paper] parity: lut_matmul on the §4 table (33 × 1001 int32, "
        f"4004-byte rows) at {list(PAPER_LUT_SHAPES)}, planned and each "
        f"route forced: bit-exact and bit-identical twice in {n} launches")
    return n


def snap_to(tree: dict, book):
    """(index form: {name: (w_idx int16, b_idx int32)}, snapped floats:
    {name: {'w', 'b'}}) of a tree of dense layers on a sorted codebook."""
    import torch
    from repro_torch.core.clustering import (assign_to_centers,
                                             quantize_to_centers)
    idx = {k: (assign_to_centers(p["w"], book).to(torch.int16),
               assign_to_centers(p["b"], book)) for k, p in tree.items()}
    snapped = {k: {n: quantize_to_centers(p[n], book) for n in ("w", "b")}
               for k, p in tree.items()}
    return idx, snapped


def wall_ms(fn, reps: int = 10) -> float:
    """Wall ms of a synchronized call, the mean of ``reps`` (for calls that
    copy from the host, which ``time_ms`` cannot queue behind a sleep)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def paper_lut_rows(a, layers, tabs, names, peaks: dict) -> list:
    """Each layer's lut_matmul on the §4 table, on its own inputs (the
    previous layer's activation indices): ms on the planned route and on
    the other route forced, the plain version's ms, and the bound: a_idx
    and ids read once, the table once (it is staged, or sits in L1/L2),
    the int32 out written once; 2·M·K·N int32 operations (address add,
    accumulate)."""
    import torch
    from repro_torch.core import fixedpoint as fp
    from repro_torch.kernels import lut_matmul as lm
    mult = torch.from_numpy(tabs.mult).to(a.device)
    rows = []
    for (w, _), name in zip(layers, names):
        M, K = a.shape
        N = w.shape[1]
        nbytes = M * K * 4 + K * N * 2 + mult.numel() * 4 + M * N * 4
        b_bytes, b_ops = nbytes / peaks["bytes"], 2 * M * K * N / peaks["int32"]
        route = lm.plan_for(a, w, mult).route
        rows.append({
            "layer": name, "M": M, "K": K, "N": N, "route": route,
            "ms": time_ms(lambda a=a, w=w: lm.lut_matmul_cuda(a, w, mult),
                          reps=5, warm=1),
            "other_routes_ms": {r_: time_ms(
                lambda a=a, w=w, p=p: lm.lut_matmul_cuda(a, w, mult, plan=p),
                reps=5, warm=1) for r_, p in lut_plans(a, w, mult)[1:]
                if r_ != route},
            "plain_ms": time_ms(lambda a=a, w=w: lm.lut_matmul_plain(
                a, w, mult), reps=2, warm=1),
            "bound_ms": 1e3 * max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
        a = fp.acc_to_act_index(lm.lut_matmul_cuda(a, w, mult), tabs)
    return rows


def lut_rows_text(rows: list) -> str:
    return ", ".join(
        f"{x['layer']} ({x['M']}, {x['K']}, {x['N']}) {x['ms']:.4f} ms "
        f"({x['route']}"
        + "".join(f"; {o} route {ms:.4f}"
                  for o, ms in x["other_routes_ms"].items())
        + f"; bound {x['bound_ms']:.4f} {x['bound_by']}, plain "
        f"{x['plain_ms']:.3f})" for x in rows)


def paper_mlp(dev) -> dict:
    """The §4 engine on the paper's MLP (784 → 128 → 128 → 10, tanh), the
    shape of ``benchmarks/memory_savings.py``: ``mlp_init`` on the card
    from a seeded generator, a k-means |W| = 1000 codebook of all weights
    and biases (``clustering.kmeans1d``: 100 kmeans_assign launches), each
    leaf snapped to it, the tanh |A| = 32 tables (4096 entries, fan-in 785),
    ``pseudo_mnist_batch(2000, 256)`` through tanh and
    ``input_to_indices``, and ``int_mlp_forward`` (3 lut_matmul launches).
    The float quantized net on the snapped weights (2 act_quant) and the
    index-form MLP on the codebook and dense backends at act_levels 32 (3
    codebook_matmul and 2 act_quant, then 2 act_quant) are driven too.
    Checks come after the driven part, in ``paper_mlp_checks``."""
    import torch
    from repro_torch.core import fixedpoint as fp
    from repro_torch.core.activations import ActQuantConfig, act_apply
    from repro_torch.core.clustering import kmeans1d
    from repro_torch.data.synthetic import pseudo_mnist_batch
    from repro_torch.kernels import dispatch
    from repro_torch.models import papernets as PN
    d_in, hidden, d_out = PAPER_MLP
    params = PN.mlp_init(torch.Generator(device=dev).manual_seed(26), d_in,
                         hidden, d_out, device=dev)
    flat = torch.cat([t.reshape(-1) for t in _leaves(params)])
    book, t_km = timed(lambda: kmeans1d(flat, PAPER_W))
    idx, snapped = snap_to(params, book)
    tabs = paper_tables(book, "tanh", d_in + 1)
    act = ActQuantConfig("tanh", ACT_LEVELS)
    x = pseudo_mnist_batch(2000, PAPER_MLP_BATCH, device=dev)["x"]
    xi = fp.input_to_indices(torch.tanh(x), act)
    layers = [idx[f"layer{i}"] for i in range(len(idx))]
    acc, t_eng = timed(lambda: fp.int_mlp_forward(layers, xi, tabs))
    lo, _ = act.out_range
    h = lo + xi.to(torch.float32) * act.step
    for i in range(len(snapped)):
        p = snapped[f"layer{i}"]
        h = h @ p["w"] + p["b"]
        if i < len(snapped) - 1:
            h = act_apply(act, h)
    index_form = {k: {"w_idx": w, "codebook": book,
                      "b": snapped[k]["b"]} for k, (w, _) in idx.items()}
    xq = lo + xi.to(torch.float32) * act.step
    by_backend = {be: PN.mlp_apply(index_form, xq, "tanh", ACT_LEVELS,
                                   dispatch.BackendSpec(be))
                  for be in ("codebook", "dense")}
    return {"params": params, "book": book, "idx": idx, "tabs": tabs,
            "xi": xi, "layers": layers, "acc": acc, "float": h,
            "index_form": index_form, "xq": xq, "by_backend": by_backend,
            "kmeans_s": t_km, "first_call_s": t_eng, "flat": flat}


def paper_mlp_checks(dev, r: dict, peaks: dict, smi: str) -> dict:
    """The MLP's gates and readings, after the driven part: the engine on
    the card equals the same call on CPU tensors bit for bit; each layer
    of the codebook backend against the dense backend on the dense run's
    inputs, within the codebook kernel's parity limit
    (``parity_tolerance``); logged only: argmax agreement and the largest
    |decode − float| against the float quantized net (random weights, so
    the reference's trained-net bounds of 0.97 and 0.6 are for reading),
    the codebook MLP's end-to-end gap, the engine's wall ms a forward and
    each layer's lut_matmul (``paper_lut_rows``)."""
    import torch
    from repro_torch.core import fixedpoint as fp
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.models import layers as L
    cpu_layers = [(w.cpu(), b.cpu()) for w, b in r["layers"]]
    want = fp.int_mlp_forward(cpu_layers, r["xi"].cpu(), r["tabs"])
    if not torch.equal(r["acc"].cpu(), want):
        raise AssertionError("[paper] int_mlp_forward on the card differs "
                             "from the same call on CPU tensors")
    km_err = kmeans_case(r["flat"], r["book"])
    dec = torch.from_numpy(r["tabs"].decode(r["acc"]))
    flo = r["float"].double().cpu()
    agree = (dec.argmax(-1) == flo.argmax(-1)).double().mean().item()
    gap = (dec - flo).abs().max().item()
    # the codebook backend layer by layer on the dense run's inputs
    h, shares = r["xq"], []
    n = len(r["index_form"])
    for i in range(n):
        p = r["index_form"][f"layer{i}"]
        got = cm.codebook_matmul_cuda(h, p["w_idx"], p["codebook"])
        ref = h @ L.dequantize(p)
        tol = cm.parity_tolerance(h, p["w_idx"], p["codebook"])
        shares.append(((got - ref).abs() / tol).max().item())
        if shares[-1] > 1:
            raise AssertionError(f"[paper] codebook backend layer {i}: "
                                 f"{shares[-1]:.3f} of the parity limit "
                                 "against the dense backend")
        h = L.dense(p, h)
        if i < n - 1:
            h = L.ffn_act(h, "tanh", ACT_LEVELS)
    cb, dn = r["by_backend"]["codebook"], r["by_backend"]["dense"]
    out = {"engine_agree_float": agree, "engine_max_gap": gap,
           "tables": {"mult": list(r["tabs"].mult.shape),
                      "s": r["tabs"].s,
                      "zero_offset": r["tabs"].zero_offset,
                      "act_table": int(r["tabs"].act_table.shape[0])},
           "codebook_share_of_limit": max(shares),
           "codebook_vs_dense_gap": (cb - dn).abs().max().item(),
           "codebook_vs_dense_argmax": (cb.argmax(-1) == dn.argmax(-1))
           .double().mean().item(),
           "kmeans_s": r["kmeans_s"], "kmeans_values": r["flat"].numel(),
           "kmeans_vs_plain": km_err,
           "engine_first_call_s": r["first_call_s"],
           "engine_wall_ms": wall_ms(lambda: fp.int_mlp_forward(
               r["layers"], r["xi"], r["tabs"])),
           "lut": paper_lut_rows(r["xi"], r["layers"], r["tabs"],
                                 [f"layer{i}" for i in range(n)], peaks)}
    log(f"[paper] {smi}: engine MLP {PAPER_MLP[0]}→{PAPER_MLP[1]}→"
        f"{PAPER_MLP[2]} "
        f"tanh |A| {ACT_LEVELS}, k-means |W| {PAPER_W} over "
        f"{r['flat'].numel()} values in {r['kmeans_s']:.2f}s ("
        f"kmeans_assign on them against the plain version: {km_text(km_err)}"
        f"), tables "
        f"{out['tables']}: int_mlp_forward of {PAPER_MLP_BATCH} "
        f"pseudo-MNIST rows on the card = the CPU's bit for bit; "
        f"{out['engine_wall_ms']:.3f} ms wall a forward; against the float "
        f"quantized net argmax agreement {agree:.4f}, max |decode − float| "
        f"{gap:.4f} (random weights: read only); codebook backend within "
        f"{max(shares):.4f} of its parity limit layer by layer, end to end "
        f"max |codebook − dense| {out['codebook_vs_dense_gap']:.3e}, argmax "
        f"agreement {out['codebook_vs_dense_argmax']:.4f}; lut_matmul by "
        f"layer: " + lut_rows_text(out["lut"]))
    return out


def paper_alexnet(dev) -> dict:
    """paper-alexnet as the registry gives it (width d_model/96 = 1.0, 1000
    classes, relu6) at img 224, batch 32 of ``class_images`` at side 224:
    ``alexnet_init`` on the card; the forward at act_levels 0, and at 32
    as ``alexnet_features`` then ``alexnet_head`` (7 act_quant: c1–c5,
    f6, f7; held exactly); the integer head: a k-means |W| = 1000 codebook
    of f6–f8's weights and biases (100 kmeans_assign launches), the relu6
    |A| = 32 tables at fan-in 50177, ``act_index`` of that forward's
    flattened pooled c5 output (1 act_quant), ``int_mlp_forward`` over f6,
    f7 and f8 (3 lut_matmul launches), and the float head on the snapped
    weights (2 act_quant)."""
    import torch
    from repro_torch import configs
    from repro_torch.core import fixedpoint as fp
    from repro_torch.core.activations import ActQuantConfig, act_index
    from repro_torch.core.clustering import kmeans1d
    from repro_torch.data.synthetic import class_images
    from repro_torch.models import papernets as PN
    from repro_torch.models.layers import dense, ffn_act
    cfg = configs.get("paper-alexnet")
    width = cfg.d_model / 96
    params = PN.alexnet_init(torch.Generator(device=dev).manual_seed(26),
                             n_classes=cfg.vocab, width=width,
                             img=PAPER_IMG, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    x = class_images(0, PAPER_BATCH, PAPER_IMG, n_classes=cfg.vocab,
                     device=dev)["x"]
    kind = cfg.act_kind
    logits = {0: PN.alexnet_apply(params, x, kind, 0)}

    def forward_32():
        f = PN.alexnet_features(params, x, kind, ACT_LEVELS)
        return f, PN.alexnet_head(params, f, kind, ACT_LEVELS)
    (feat, logits[ACT_LEVELS]), per_fwd = rec_counted(forward_32)
    rec_check("[paper] AlexNet forward at act_levels 32", per_fwd,
              {"act_quant": 7})
    head = {k: params[k] for k in ("f6", "f7", "f8")}
    flat = torch.cat([t.reshape(-1) for t in _leaves(head)])
    book, t_km = timed(lambda: kmeans1d(flat, PAPER_W))
    idx, snapped = snap_to(head, book)
    tabs = paper_tables(book, kind, head["f6"]["w"].shape[0] + 1)
    feat = feat.reshape(feat.shape[0], -1)
    xi = act_index(ActQuantConfig(kind, ACT_LEVELS), feat)
    layers = [idx[k] for k in ("f6", "f7", "f8")]
    acc = fp.int_mlp_forward(layers, xi, tabs)
    h = feat
    for i, k in enumerate(("f6", "f7", "f8")):
        h = dense(snapped[k], h)
        if i < 2:
            h = ffn_act(h, kind, ACT_LEVELS)
    return {"cfg": cfg, "width": width, "params": params,
            "n_params": n_params, "x": x, "logits": logits, "book": book,
            "tabs": tabs, "feat": feat, "xi": xi, "layers": layers,
            "acc": acc, "head_float": h, "kmeans_s": t_km, "flat": flat}


def tie_flips(xp, xw, yp, yw, acfg, tol: float, what: str) -> int:
    """The levels of two runs' snapped activations ``yp`` and ``yw`` (of
    the inputs ``xp`` and ``xw``, tensors on one device; ``acfg`` their
    ``ActQuantConfig``) equal but where a level flipped at a boundary tie:
    one level apart, both inputs within ``tol`` of the boundary between the
    two levels.  Returns the flips; any other difference raises, naming
    ``what``."""
    import torch
    from repro_torch.core.activations import act_input_boundaries
    lo = acfg.out_range[0]
    lp, lw = (torch.round((t.double() - lo) / acfg.step).long()
              for t in (yp, yw))
    flip = lp != lw
    if bool(flip.any()):
        edge = torch.from_numpy(act_input_boundaries(acfg)).to(
            xp.device, torch.float64)[torch.minimum(lp, lw)[flip]]
        if bool(((lp - lw).abs()[flip] != 1).any()) or not bool(
                ((xp[flip].double() - edge).abs() <= tol).all()
                and ((xw[flip].double() - edge).abs() <= tol).all()):
            raise AssertionError(f"{what}: a level differs off a boundary "
                                 "tie, or by more than one")
    return int(flip.sum())


def paper_locked(cpu_params, params, xc, x, kind: str) -> dict:
    """AlexNet at act_levels 32 on the card against the CPU, every
    activation site locked to the CPU run's, as the port's CPU tests lock
    it to the reference's: the CPU forward records each ``ffn_act``'s input
    and output; each card site, in the same order, holds its input within
    PAPER_LOCK_REL of the site's largest |x|, and its output's levels equal
    but where a level flipped at a boundary tie (one level apart, both
    inputs within that bound of the boundary between the two levels),
    counted; the card then goes on with the CPU's output.  The logits
    within 1e-4 of the CPU's range.  Returns the CPU logits and the
    counts."""
    from repro_torch.core.activations import ActQuantConfig
    from repro_torch.models import papernets as PN
    from repro_torch.models.layers import _bounded
    act = PN.ffn_act
    recorded = []
    cfg = ActQuantConfig(_bounded(kind), ACT_LEVELS)
    st = {"sites": 0, "acts": 0, "flips": 0, "input_share_of_bound": 0.0}

    def cpu_site(v, k, lv, mul=None):
        y = act(v, k, lv, mul)
        recorded.append((v, y))
        return y

    def card_site(v, k, lv, mul=None):
        xw, yw = recorded.pop(0)
        xp, yp = v.cpu(), act(v, k, lv, mul).cpu()
        tol = PAPER_LOCK_REL * max(1.0, xw.abs().max().item())
        if xp.shape != xw.shape or not (xp - xw).abs().max().item() <= tol:
            raise AssertionError(f"[paper] locked AlexNet site {st['sites']}"
                                 ": card input off the CPU's")
        st["input_share_of_bound"] = max(st["input_share_of_bound"], (
            xp - xw).abs().max().item() / tol)
        st["flips"] += tie_flips(xp, xw, yp, yw, cfg, tol,
                                 f"[paper] locked AlexNet site {st['sites']}")
        st["sites"] += 1
        st["acts"] += yw.numel()
        return yw.to(v.device)

    try:
        PN.ffn_act = cpu_site
        want = PN.alexnet_apply(cpu_params, xc, kind, ACT_LEVELS)
        PN.ffn_act = card_site
        got = PN.alexnet_apply(params, x, kind, ACT_LEVELS).cpu()
    finally:
        PN.ffn_act = act
    gap = (got - want).abs().max().item()
    rng_ = (want.max() - want.min()).item()
    if recorded or st["sites"] != 7 or not gap <= 1e-4 * rng_:
        raise AssertionError(f"[paper] locked AlexNet at act_levels 32: "
                             f"{st['sites']} sites, max |Δ| {gap:.3e} of the "
                             f"range {rng_:.3f}")
    return {"want": want, **st, "gap": gap, "range": rng_}


def paper_alexnet_checks(dev, r: dict, peaks: dict, smi: str) -> dict:
    """AlexNet's gates and readings, after the driven part: the float
    forward at act_levels 0 on the card against the CPU's on the same
    weights and the first PAPER_CPU_BATCH images, within 1e-4 of the
    output's range (TF32 off); at act_levels 32 the same with the sites
    locked (``paper_locked``); the head's k-means values through
    kmeans_assign against the plain version (``kmeans_case``); the
    integer head bit-exact against itself with lut_matmul's plain version
    on the card (``plain_lut``); logged: act_levels 32 against 0 (top-1
    agreement, logit gap), the driven act_levels 32 forward against the
    CPU's, unlocked, the head's top-1 agreement with the float head on the
    same snapped weights; the forward's ms at both act_levels and its peak
    memory; each head layer's lut_matmul (``paper_lut_rows``)."""
    import torch
    from repro_torch.core import fixedpoint as fp
    from repro_torch.models import papernets as PN
    kind, B = r["cfg"].act_kind, PAPER_CPU_BATCH
    cpu_params = _to(r["params"], "cpu")
    xc = r["x"][:B].cpu()
    out = {"params": r["n_params"], "width": r["width"], "img": PAPER_IMG,
           "batch": PAPER_BATCH}
    locked = paper_locked(cpu_params, r["params"], xc, r["x"][:B], kind)
    wants = {0: PN.alexnet_apply(cpu_params, xc, kind, 0),
             ACT_LEVELS: locked.pop("want")}
    out["locked_32"] = locked
    for lv, want in wants.items():
        got = r["logits"][lv][:B].cpu()
        gap = (got - want).abs().max().item()
        rng_ = (want.max() - want.min()).item()
        out[f"card_vs_cpu_{lv}"] = {"gap": gap, "range": rng_, "top1": (
            got.argmax(-1) == want.argmax(-1)).double().mean().item()}
        if lv == 0 and not gap <= 1e-4 * rng_:
            raise AssertionError(f"[paper] AlexNet float forward: card vs "
                                 f"CPU max |Δ| {gap:.3e} over 1e-4 of the "
                                 f"range {rng_:.3f}")
    del cpu_params
    km_err = kmeans_case(r["flat"], r["book"])
    l0, l32 = r["logits"][0], r["logits"][ACT_LEVELS]
    out["act32_vs_float"] = {
        "top1": (l0.argmax(-1) == l32.argmax(-1)).double().mean().item(),
        "gap": (l0 - l32).abs().max().item(),
        "range": (l0.max() - l0.min()).item()}
    with plain_lut():
        want = fp.int_mlp_forward(r["layers"], r["xi"], r["tabs"])
    if not torch.equal(r["acc"], want):
        raise AssertionError("[paper] AlexNet integer head: the lut_matmul "
                             "kernel differs from its plain version")
    dec = torch.from_numpy(r["tabs"].decode(r["acc"]))
    hf = r["head_float"].double().cpu()
    out["head"] = {
        "top1_vs_float_head": (dec.argmax(-1) == hf.argmax(-1)).double()
        .mean().item(),
        "max_gap": (dec - hf).abs().max().item(),
        "float_range": (hf.max() - hf.min()).item(),
        "tables": {"mult": list(r["tabs"].mult.shape), "s": r["tabs"].s,
                   "act_table": int(r["tabs"].act_table.shape[0])},
        "kmeans_s": r["kmeans_s"], "kmeans_values": r["flat"].numel(),
        "kmeans_vs_plain": km_err}
    # figures: the forward at both act_levels, its peak, the head's layers
    params, x = r["params"], r["x"]
    for lv in (0, ACT_LEVELS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = time_ms(lambda lv=lv: PN.alexnet_apply(params, x, kind, lv),
                     reps=5, warm=1)
        out[f"forward_ms_{lv}"] = ms
        out[f"forward_peak_gib_{lv}"] = (torch.cuda.max_memory_allocated()
                                         - base) / 2 ** 30
    out["head_lut"] = paper_lut_rows(r["xi"], r["layers"], r["tabs"],
                                     ("f6", "f7", "f8"), peaks)
    log(f"[paper] {smi}: AlexNet (paper-alexnet: width {r['width']:.2f}, "
        f"{r['cfg'].vocab} classes, {kind}) at img {PAPER_IMG}: "
        f"{r['n_params']} params; float forward card vs CPU (batch {B}) max "
        f"|Δ| {out['card_vs_cpu_0']['gap']:.3e} of range "
        f"{out['card_vs_cpu_0']['range']:.3f}; act_levels 32 card vs CPU "
        f"with the {locked['sites']} sites locked: max |Δ| "
        f"{locked['gap']:.3e} of range {locked['range']:.3f}, "
        f"{locked['flips']} flips at boundary ties in {locked['acts']} "
        f"activations, inputs within {locked['input_share_of_bound']:.4f} "
        f"of their bound; unlocked (the driven forward) "
        f"{out[f'card_vs_cpu_{ACT_LEVELS}']}; act_levels 32 vs float "
        f"(batch {PAPER_BATCH}) {out['act32_vs_float']}; forward "
        f"{out['forward_ms_0']:.3f} ms (peak +"
        f"{out['forward_peak_gib_0']:.2f} GiB) at act_levels 0, "
        f"{out[f'forward_ms_{ACT_LEVELS}']:.3f} ms (peak +"
        f"{out[f'forward_peak_gib_{ACT_LEVELS}']:.2f} GiB) at 32")
    log(f"[paper] {smi}: AlexNet integer head f6–f8: k-means |W| "
        f"{PAPER_W} over "
        f"{r['flat'].numel()} values in {r['kmeans_s']:.2f}s (kmeans_assign "
        f"on them against the plain version: {km_text(km_err)}), relu6 tables "
        f"{out['head']['tables']}; int_mlp_forward bit-exact against "
        f"lut_matmul's plain version on the card; top-1 against the float "
        f"head on the snapped weights {out['head']['top1_vs_float_head']:.4f}"
        f", max |decode − float| {out['head']['max_gap']:.4f} of range "
        f"{out['head']['float_range']:.3f}; lut_matmul by layer: "
        + lut_rows_text(out["head_lut"]))
    return out


def km_text(e: dict) -> str:
    """A ``kmeans_case`` result in a line."""
    return (f"idx and counts exact, sums − plain max abs "
            f"{e['max_abs_err']:.3e}, {e['kernel_share_of_limit']:.4f} of "
            f"the tolerance and {e['kernel_fixed_point_share_of_limit']:.4f}"
            f" of the fixed-point bound")


def _detached(got: tuple) -> tuple:
    """A launch's outputs without their autograd history: inside
    ``_ActApply.forward`` the output is the tensor autograd hands back, so
    a record of it would hold the step's graph, and through its saved
    tensors the weights of that step, after a clustering event replaced
    them."""
    return tuple(t if t is None else t.detach() for t in got)


@contextlib.contextmanager
def record_act_quant(out: list):
    """Each act_quant launch through ``ops`` appends (x, kind, levels,
    form, mul, (y, idx)) to ``out``: the inputs the driven path gave the
    kernel and what it returned, to hold against the plain version
    afterwards.  The wrapper and its launch count stay the kernel's own."""
    from repro_torch.kernels import ops
    route = ops._act_quant

    def spy(x, kind, levels, form, with_index, mul=None):
        got = route(x, kind, levels, form, with_index, mul)
        if ops._route(x) == "cuda":
            out.append((x, kind, levels, form, mul, _detached(got)))
        return got

    ops._act_quant = spy
    try:
        yield
    finally:
        ops._act_quant = route


def paper_act_parity(records: list) -> dict:
    """Every act_quant launch of the driven path (``record_act_quant``)
    held against the plain version on the same input: a launch made
    without the index runs once more with it, its output bit-equal to the
    path's; then outputs and indices bit-equal but for level-boundary ties
    (``parity_ties``, which raises on anything else), relu6 bit-equal."""
    import torch
    from repro_torch.kernels import act_quant as aq
    ties, worst, seen = 0, 0.0, {}
    for x, kind, levels, form, mul, (y, idx) in records:
        if idx is None:
            y2, idx = aq.act_quant_cuda(x, kind, levels, form=form, mul=mul)
            if not torch.equal(y2, y):
                raise AssertionError(f"act_quant {kind} {tuple(x.shape)}: "
                                     "a second run differs")
        want = aq.act_quant_plain(x, kind, levels, form=form, mul=mul)
        ties += aq.parity_ties(y, idx, *want, kind, levels, mul=mul)
        worst = max(worst, (y.float() - want[0].float()).abs().max().item())
        key = f"{kind} {tuple(x.shape)}"
        seen[key] = seen.get(key, 0) + 1
    return {"launches": len(records), "ties": ties, "max_abs_err": worst,
            "sites": seen}


def paper_path(dev, smi: str, peaks: dict) -> tuple[dict, dict]:
    """The [paper] phase: ``paper_parity``; then, with every launch count
    set to 0, ``paper_mlp`` and ``paper_alexnet`` (the driven path, whose
    launches are held to the code's count and returned, and whose
    act_quant launches are recorded); then their checks and figures,
    uncounted, the recorded act_quant launches first
    (``paper_act_parity``)."""
    import torch
    from repro_torch.kernels import ops
    t0 = time.time()
    n_parity = paper_parity(dev)
    t_parity = time.time() - t0
    acts = []
    ops.reset_launch_counts()
    with record_act_quant(acts):
        mlp = paper_mlp(dev)
        alex = paper_alexnet(dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    # 2 × 50 Lloyd steps a k-means; lut: the MLP's 3 layers and f6–f8;
    # act_quant: the float MLP's 2, the backends' 2 + 2, the AlexNet
    # forward's 7 at act_levels 32 (c1–c5, f6, f7), act_index of its c5
    # output, the float head's 2; codebook_matmul: the codebook MLP's 3
    want = {"kmeans_assign": 200, "lut_matmul": 6,
            "act_quant": 2 + 2 + 2 + 7 + 1 + 2, "codebook_matmul": 3}
    rec_check("[paper] the driven path", launches, want)
    t_path = time.time() - t0 - t_parity
    act_par = paper_act_parity(acts)
    del acts
    log(f"[paper] act_quant on the driven path's own inputs: "
        f"{act_par['launches']} launches ({act_par['sites']}) against the "
        f"plain version: bit-equal but for {act_par['ties']} level-boundary "
        f"ties (each one level apart), relu6 bit-equal; max abs err "
        f"{act_par['max_abs_err']:.3e}")
    stats = {"act_quant_vs_plain": act_par,
             "mlp": paper_mlp_checks(dev, mlp, peaks, smi),
             "alexnet": paper_alexnet_checks(dev, alex, peaks, smi),
             "parity_launches": n_parity, "parity_s": t_parity,
             "path_s": t_path}
    del mlp, alex
    torch.cuda.empty_cache()
    stats["phase_s"] = time.time() - t0
    log(f"[paper] {smi}: phase {stats['phase_s']:.1f}s (parity "
        f"{t_parity:.1f}s, driven path {t_path:.1f}s); launches {launches}")
    return stats, launches


# --- [train] -----------------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"
TRAIN_REDUCED = dict(steps=10, batch=2, seq=16, log_every=1)
TRAIN_REDUCED_EVENT = 5          # laplacian_l1 |W| 1000, global, at step 5
TRAIN_FAIL_AT, TRAIN_CKPT_EVERY = 6, 4
TRAIN_FULL = dict(steps=6, batch=2, seq=128, log_every=1)
TRAIN_FULL_EVENT = 3
TRAIN_LOCK_REL = 1e-5     # locked sites: card input vs CPU, of max |x|
TRAIN_LOSS_TOL = 1e-4     # reduced losses, card vs CPU (the tests' bound)
TRAIN_CM = (256, 2048, 6144)     # codebook_matmul's gradient: 2 × 128 rows
MLP_STEPS, MLP_ENGINE_STEPS, PARABOLA_STEPS = 250, 200, 600
ALEX_STEPS, ALEX_EVENT, ALEX_SUBSAMPLE = 4, 2, 0.02


def quant_cfg(cfg, interval: int):
    """The paper's working point as ``launch/train.py --quant`` sets it:
    |A| 32, |W| 1000 laplacian_l1 global, the event every ``interval``."""
    import dataclasses
    q = cfg.quantized()
    return q.replace(wq=dataclasses.replace(q.wq, interval=interval))


@contextlib.contextmanager
def ffn_sites(records: list, stats: dict | None = None,
              rel: float = TRAIN_LOCK_REL):
    """Every FFN activation site (``ffn_act`` in ``layers``, ``moe``,
    ``rwkv`` and ``ssm``): without ``stats``
    each call appends its input and output, on the host, to ``records``
    (the CPU run); with ``stats`` each call takes the next record, checks
    its own input within ``rel`` of the site's largest |x| and
    its levels equal but where one flipped at a boundary tie (one level
    apart, both inputs within that bound of the boundary), counted, and
    goes on with the recorded output, straight through (the card run),
    as the port's CPU tests lock the card's twin, the reference."""
    from repro_torch.core.activations import ActQuantConfig
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    from repro_torch.models import rwkv as R
    from repro_torch.models import ssm as S
    mods = (L, M, R, S)          # each binds ffn_act under its own name
    route = L.ffn_act

    def record(x, kind, levels, mul=None):
        y = route(x, kind, levels)
        records.append((x.detach().cpu(), y.detach().cpu()))
        return y if mul is None else y * mul

    def lock(x, kind, levels, mul=None):
        y = route(x, kind, levels)
        xw, yw = records.pop(0)
        xp, yp = x.detach().float().cpu(), y.detach().float().cpu()
        xw = xw.float()
        tol = rel * max(1.0, xw.abs().max().item())
        gap = (xp - xw).abs().max().item() if xp.shape == xw.shape \
            else float("inf")
        stats["max_input_gap"] = max(stats["max_input_gap"], gap)
        if gap > tol:
            raise AssertionError(
                f"[train] FFN site {stats['sites']}: its input on the card "
                f"is {gap:.3e} from the CPU's (bound {tol:.3e})")
        stats["flips"] += tie_flips(
            xp, xw, yp, yw.float(), ActQuantConfig(L._bounded(kind), levels),
            tol, f"[train] FFN site {stats['sites']}")
        stats["sites"] += 1
        stats["acts"] += yw.numel()
        y = y + (yw.to(y.device, y.dtype) - y).detach()
        return y if mul is None else y * mul

    for m in mods:
        m.ffn_act = record if stats is None else lock
    try:
        yield
    finally:
        for m in mods:
            m.ffn_act = route


def train_reduced(dev) -> dict:
    """(a) The reduced qwen3 at ``--quant`` (act_levels 32, laplacian_l1
    event at step 5, remat on), 10 steps of ``launch.train.train`` on the
    CPU, then on the card from the same initial params (the CPU's, moved:
    a CUDA generator draws other numbers) with every FFN site locked to
    the CPU run's (``ffn_sites``): each logged loss within
    ``TRAIN_LOSS_TOL``, flips counted.  Then on the card a run with
    checkpoints every 4 steps and a failure injected at step 6, resumed
    from step 4, against an uninterrupted card run: the resumed steps'
    losses equal."""
    import tempfile
    from repro_torch import checkpoint as CKPT
    from repro_torch import configs
    from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                         SimulatedFailure)
    import torch
    from repro_torch.launch import train as TT
    from repro_torch.models.model_zoo import Model, build
    quiet = lambda *a: None                                  # noqa: E731
    cfg = quant_cfg(configs.get(TRAIN_ARCH).reduced(), TRAIN_REDUCED_EVENT)
    recs = []
    t0 = time.time()
    with ffn_sites(recs):
        _, cq, cpu = TT.train(cfg, TT.TrainLoopConfig(**TRAIN_REDUCED,
                                                      device="cpu"),
                              log=quiet)
    lock = {"sites": 0, "acts": 0, "flips": 0, "max_input_gap": 0.0}
    init = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
    route = Model.init
    Model.init = lambda self, gen, device=None: _to(init, device)
    try:
        with ffn_sites(recs, lock):
            _, gq, card = TT.train(cfg, TT.TrainLoopConfig(**TRAIN_REDUCED,
                                                           device="cuda"),
                                   log=quiet)
    finally:
        Model.init = route
    if recs:
        raise AssertionError("[train] the card ran fewer FFN sites than "
                             "the CPU")
    gap = max(abs(a["loss"] - b["loss"]) for a, b in zip(card, cpu))
    if [h["step"] for h in card] != [h["step"] for h in cpu] or \
            gap > TRAIN_LOSS_TOL:
        raise AssertionError(f"[train] reduced losses card vs CPU: {gap}")
    if (gq.last_step, cq.last_step) != (TRAIN_REDUCED_EVENT,) * 2:
        raise AssertionError("[train] the clustering event did not run")
    t_lock = time.time() - t0
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ck:
        loop = TT.TrainLoopConfig(**TRAIN_REDUCED, device="cuda",
                                  ckpt_dir=ck, ckpt_every=TRAIN_CKPT_EVERY)
        try:
            TT.train(cfg, loop, injector=FailureInjector(
                fail_at_step=TRAIN_FAIL_AT), log=quiet)
            raise AssertionError("[train] the injected failure did not "
                                 "fire")
        except SimulatedFailure:
            pass
        if CKPT.latest_step(ck) != TRAIN_CKPT_EVERY:
            raise AssertionError("[train] no checkpoint at step 4")
        lines = []
        _, _, resumed = TT.train(cfg, loop, log=lines.append)
    _, _, clean = TT.train(cfg, TT.TrainLoopConfig(**TRAIN_REDUCED,
                                                   device="cuda"), log=quiet)
    clean = {h["step"]: h["loss"] for h in clean}
    resume_gap = max(abs(h["loss"] - clean[h["step"]]) for h in resumed)
    if lines[0] != f"[resume] from step {TRAIN_CKPT_EVERY}" or \
            [h["step"] for h in resumed] != list(range(TRAIN_CKPT_EVERY,
                                                       10)) or \
            resume_gap > 1e-5:
        raise AssertionError(f"[train] resumed run: {lines[0]}, gap "
                             f"{resume_gap}")
    out = {"loss_gap_card_cpu": gap, "lock": lock,
           "losses": [h["loss"] for h in card],
           "resume_gap": resume_gap, "locked_runs_s": t_lock}
    log(f"[train] (a) reduced {TRAIN_ARCH} --quant, {TRAIN_REDUCED['steps']}"
        f" steps, event at {TRAIN_REDUCED_EVENT}: card vs CPU max |Δloss| "
        f"{gap:.3e} (gate {TRAIN_LOSS_TOL}), every FFN site locked: "
        f"{lock['sites']} sites, {lock['flips']} flips at boundary ties in "
        f"{lock['acts']} activations, inputs within "
        f"{lock['max_input_gap']:.3e}; failure at step {TRAIN_FAIL_AT}, "
        f"resumed from {TRAIN_CKPT_EVERY}: max |Δloss| against the "
        f"uninterrupted card run {resume_gap:.3e}")
    return out


def train_codebook_grad(dev) -> list:
    """(c) codebook_matmul under its gradient at 256 × 2048 × 6144 (int16
    ids into |W| = 1000), f32 and bf16 x: one launch each; returns the
    inputs and results for ``train_codebook_checks``."""
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(27)
    M, K, N = TRAIN_CM
    ids = torch.randint(0, N_BOOK, (K, N), generator=g, device=dev).to(
        torch.int16)
    book = torch.randn(N_BOOK, generator=g, device=dev)
    out = []
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(M, K, generator=g, device=dev).to(dt)
        gy = torch.randn(M, N, generator=g, device=dev)
        xr, br = x.clone().requires_grad_(True), book.clone().requires_grad_(
            True)
        y = ops.codebook_matmul(xr, ids, br)
        y.backward(gy)
        out.append({"x": x, "ids": ids, "book": book, "gy": gy,
                    "y": y.detach(), "dx": xr.grad, "dbook": br.grad})
    return out


def train_codebook_checks(cases: list) -> dict:
    """The card's forward within the kernel's parity limit of the plain
    version, and its gradients against the same function on CPU tensors
    (the plain version and the same backward): dbook (f32) within 1e-5 of
    its largest |g|, dx within that or, in bf16, one bf16 ulp of each
    element."""
    import torch
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import ops
    out = {}
    for c in cases:
        x, ids, book = c["x"].cpu(), c["ids"].cpu(), c["book"].cpu()
        xr, br = x.clone().requires_grad_(True), book.clone().requires_grad_(
            True)
        y = ops.codebook_matmul(xr, ids, br)
        y.backward(c["gy"].cpu())
        tol = cm.parity_tolerance(c["x"], c["ids"], c["book"])
        share = ((c["y"] - cm.codebook_matmul_plain(c["x"], c["ids"],
                                                    c["book"])).abs()
                 / tol).max().item()
        db = (c["dbook"].cpu() - br.grad).abs().max().item() / \
            br.grad.abs().max().item()
        dxg, dxw = c["dx"].cpu().float(), xr.grad.float()
        lim = 1e-5 * dxw.abs().max()
        if x.dtype == torch.bfloat16:
            lim = torch.maximum(lim, torch.finfo(torch.bfloat16).eps
                                * dxw.abs())
        dx_ok = bool(((dxg - dxw).abs() <= lim).all())
        if share > 1 or db > 1e-5 or not dx_ok:
            raise AssertionError(f"[train] codebook_matmul gradient {x.dtype}"
                                 f": forward {share:.3f} of its limit, dbook "
                                 f"{db:.3e}, dx within bound {dx_ok}")
        out[str(x.dtype).split(".")[-1]] = {
            "forward_share_of_limit": share, "dbook_rel_err": db,
            "dx_max_abs_err": (dxg - dxw).abs().max().item()}
    log(f"[train] (c) codebook_matmul at {TRAIN_CM} under its gradient, card"
        f" against the plain version on CPU tensors: {json.dumps(out)}")
    return out


def train_full(dev, acts: list) -> dict:
    """(b) ``launch.train.train`` on qwen3-1.7b at full width and depth
    (28 layers, bf16, remat), ``--quant`` with the event at step 3, 2 ×
    128 tokens a step, 6 steps.  The event is timed and checked as it
    returns (every weight equal to one of the |W| centers in its dtype);
    the act_quant launches are recorded (``record_act_quant``)."""
    import torch
    from repro_torch import configs
    from repro_torch.launch import train as TT
    cfg = quant_cfg(configs.get(TRAIN_ARCH), TRAIN_FULL_EVENT)
    events, lines = [], []
    route = TT.cluster_params

    def event(params, wq, qstate, step, gen):
        out, secs = timed(lambda: route(params, wq, qstate, step, gen))
        book = torch.unique(out[1].codebooks[""].to(torch.bfloat16)).float()
        off = n = 0
        for leaf in _leaves(out[0]):
            v = leaf.reshape(-1).float()
            i = torch.searchsorted(book, v).clamp(max=book.numel() - 1)
            off += int((book[i] != v).sum())
            n += v.numel()
        events.append({"step": step, "s": secs, "values": n,
                       "off_center": off})
        return out

    TT.cluster_params = event
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()
    try:
        with record_act_quant(acts):
            (params, qstate, hist), launches = rec_counted(
                lambda: TT.train(cfg, TT.TrainLoopConfig(**TRAIN_FULL,
                                                         device="cuda"),
                                 log=lines.append))
    finally:
        TT.cluster_params = route
    # a step: each layer's FFN in the forward and in its remat recompute
    rec_check("[train] (b) the full-width trainer", launches,
              {"act_quant": 2 * cfg.n_layers * TRAIN_FULL["steps"]})
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_stats()
    allocator = {k: after.get(k, 0) - before.get(k, 0) for k in (
        "num_alloc_retries", "num_device_alloc", "num_device_free")}
    finite = all(bool(torch.isfinite(t).all()) for t in _leaves(params))
    n_params = sum(t.numel() for t in _leaves(params))
    return {"cfg": cfg, "hist": hist, "events": events, "peak": peak,
            "finite": finite, "n_params": n_params, "lines": lines,
            "book": int(qstate.codebooks[""].numel()), "params": params,
            "allocator": allocator}


def train_step_split(cfg, params, batch=None) -> dict:
    """One more full-width step on the trained params, its two halves
    timed apart (each synchronized): the loss's forward and backward
    (``value_and_grad``, remat included, the whole batch at once) and the
    optimizer's update (``apply_updates``, adamw on f32 moments, fresh);
    then each half again under the profiler: device busy ms, the idle
    share against the timed call's wall, kernels launched, the largest
    kernels.  The update is donated, as the trainer's: each call writes
    ``params`` and the moments in place (and consumes a shallow copy of
    the gradient tree).  ``batch``: the step's inputs (the next
    ``TokenPipeline`` batch of ``TRAIN_FULL`` when None)."""
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.model_zoo import build
    from repro_torch.optim import OptConfig, apply_updates_, init_opt_state
    from repro_torch.tree import tree_map
    model = build(cfg)
    ocfg = OptConfig(name="adamw", lr=3e-3, moments_dtype=cfg.moments_dtype)
    if batch is None:
        batch = TokenPipeline(
            vocab=cfg.vocab, batch=TRAIN_FULL["batch"], seq=TRAIN_FULL["seq"],
            device=params["embed"]["table"].device).batch_at(
                TRAIN_FULL["steps"])
    opt = init_opt_state(params, ocfg)

    def grad():
        return value_and_grad(model.loss, params, batch)
    (_, grads), t_grad = timed(grad)

    def update():
        return apply_updates_(params, tree_map(lambda g: g, grads), opt,
                              ocfg)
    _, t_upd = timed(update)
    out = {"grad_ms": t_grad * 1e3, "update_ms": t_upd * 1e3}
    for name, fn, wall in (("grad", grad, t_grad), ("update", update,
                                                    t_upd)):
        busy, top, _, n, _ = device_time(fn, top=4, match="act_quant")
        out[name] = {"busy_ms": busy, "idle_share": 1 - busy / (wall * 1e3),
                     "kernels": n, "top": top}
    return out


def train_full_checks(r: dict, smi: str) -> dict:
    import statistics
    hist, ev = r["hist"], r["events"]
    cfg = r["cfg"]
    if not r["finite"] or not all(math_finite(h["loss"]) for h in hist):
        raise AssertionError("[train] full width: a loss or parameter is "
                             "not finite")
    if len(ev) != 1 or ev[0]["step"] != TRAIN_FULL_EVENT or \
            ev[0]["off_center"] or ev[0]["values"] != r["n_params"] or \
            r["book"] != cfg.wq.num_weights:
        raise AssertionError(f"[train] full width clustering event: {ev}")
    step_ms = statistics.median(h["sec"] for h in hist[1:]) * 1e3
    tokens = TRAIN_FULL["batch"] * TRAIN_FULL["seq"]
    split = train_step_split(cfg, r.pop("params"))
    out = {"params": r["n_params"], "losses": [h["loss"] for h in hist],
           "step_ms": step_ms, "first_step_ms": hist[0]["sec"] * 1e3,
           "event_step_ms": hist[TRAIN_FULL_EVENT]["sec"] * 1e3,
           "tokens_per_s": tokens / step_ms * 1e3,
           "peak_gib": r["peak"] / 2**30, "event_s": ev[0]["s"],
           "event_values": ev[0]["values"]}
    log(f"[train] (b) {smi}: {TRAIN_ARCH} full width ({cfg.n_layers} layers,"
        f" {r['n_params']} params, {cfg.dtype}, remat {cfg.remat}), --quant "
        f"(|A| {cfg.act_levels}, |W| {cfg.wq.num_weights} "
        f"{cfg.wq.method}), {TRAIN_FULL['batch']} × {TRAIN_FULL['seq']} "
        f"tokens, {TRAIN_FULL['steps']} steps: step {step_ms:.1f} ms "
        f"(median after the first; first {out['first_step_ms']:.1f}, the "
        f"event's step {out['event_step_ms']:.1f}), "
        f"{out['tokens_per_s']:.0f} tokens/s (a step apart: forward and "
        f"backward {split['grad_ms']:.1f} ms wall, "
        f"{split['grad']['busy_ms']:.1f} busy, idle {split['grad']['idle_share']:.3f}, "
        f"{split['grad']['kernels']} kernels, the largest "
        f"{split['grad']['top']}; update {split['update_ms']:.1f} ms wall, "
        f"{split['update']['busy_ms']:.1f} busy, idle "
        f"{split['update']['idle_share']:.3f}, {split['update']['kernels']} "
        f"kernels; allocator during train() {r['allocator']}), peak "
        f"{out['peak_gib']:.2f} GiB allocated; event at step "
        f"{TRAIN_FULL_EVENT} {ev[0]['s']:.2f}s, every one of "
        f"{ev[0]['values']} weights on one of the {r['book']} centers; "
        f"losses {[round(x, 4) for x in out['losses']]}, all finite")
    return out


def math_finite(v: float) -> bool:
    return v == v and abs(v) != float("inf")


def train_mlp(dev, levels: int, n_weights: int, steps: int, hidden):
    """The reference's ``_train_mlp`` (tests/test_papernets_integration)
    through ``launch/paper_loops.train_classifier``: adam lr 2e-3 on
    pseudo-MNIST batches of 64, laplacian_l1 events every 50 steps and a
    final snap.  Returns (params, qstate)."""
    from repro_torch.data.synthetic import pseudo_mnist_batch
    from repro_torch.launch.paper_loops import train_classifier
    from repro_torch.models import papernets as PN
    params, qstate, _ = train_classifier(
        lambda gen: PN.mlp_init(gen, 784, list(hidden), 10, device=dev),
        lambda p, x, lv, gen: PN.mlp_apply(p, x, "tanh", lv),
        lambda s: pseudo_mnist_batch(s, 64, device=dev), steps=steps,
        act_levels=levels, n_weights=n_weights, cluster_every=50,
        device=dev)
    return params, qstate


def mlp_accuracy(dev, params, levels: int) -> float:
    import torch
    from repro_torch.data.synthetic import pseudo_mnist_batch
    from repro_torch.models import papernets as PN
    hits = tot = 0
    with torch.no_grad():
        for s in range(1000, 1005):
            b = pseudo_mnist_batch(s, 128, device=dev)
            pred = PN.mlp_apply(params, b["x"], "tanh", levels).argmax(-1)
            hits += int((pred == b["y"]).sum())
            tot += pred.numel()
    return hits / tot


@contextlib.contextmanager
def record_lut(out: list):
    """Each ``ops.lut_matmul`` call appends (a_idx, w_idx, table, acc):
    the inputs the driven path gave the kernel and what it returned."""
    from repro_torch.kernels import ops
    route = ops.lut_matmul

    def spy(a_idx, w_idx, table):
        acc = route(a_idx, w_idx, table)
        out.append((a_idx, w_idx, table, acc))
        return acc

    ops.lut_matmul = spy
    try:
        yield
    finally:
        ops.lut_matmul = route


def train_paper_mlp(dev) -> dict:
    """(d) The paper's MLP loop on the card, the reference's contracts:
    the continuous and the |A| 32, |W| 256 MLP (250 steps each) and their
    accuracies; the |A| 16, |W| 128 MLP (200 steps) trained into the §4
    engine (tables at 8192 entries, fan-in 785) and the float quantized net
    beside it; the Fig. 2 parabola at |A| 2, 8, 256 (600 steps each)."""
    import torch
    from repro_torch.core import clustering
    from repro_torch.core import fixedpoint as fp
    from repro_torch.core.activations import ActQuantConfig, act_apply
    from repro_torch.core.lut import LutConfig, build_tables
    from repro_torch.data.synthetic import parabola_batch, pseudo_mnist_batch
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import papernets as PN
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    t0 = time.time()
    p_cont, _ = train_mlp(dev, 0, 0, MLP_STEPS, (32,))
    p_q, _ = train_mlp(dev, ACT_LEVELS, 256, MLP_STEPS, (32,))
    acc = {"continuous": mlp_accuracy(dev, p_cont, 0),
           "quantized": mlp_accuracy(dev, p_q, ACT_LEVELS)}
    act = ActQuantConfig("tanh", 16)
    params, qstate = train_mlp(dev, 16, 128, MLP_ENGINE_STEPS, (24,))
    book = qstate.codebooks[""]
    tabs = build_tables(book.cpu().numpy(), LutConfig(act=act,
                                                      table_entries=8192),
                        fan_in=785)
    layers = [(clustering.assign_to_centers(params[f"layer{i}"]["w"], book),
               clustering.assign_to_centers(params[f"layer{i}"]["b"], book))
              for i in range(len(params))]
    b = pseudo_mnist_batch(2000, 256, device=dev)
    xi = fp.input_to_indices(torch.tanh(b["x"]), act)
    with torch.no_grad():
        lo, _ = act.out_range
        h = lo + xi.to(torch.float32) * act.step
        for i in range(len(params) - 1):
            h = act_apply(act, h @ params[f"layer{i}"]["w"]
                          + params[f"layer{i}"]["b"])
        last = params[f"layer{len(params) - 1}"]
        yf = h @ last["w"] + last["b"]
    luts = []
    with record_lut(luts):
        acc_int = fp.int_mlp_forward(layers, xi, tabs)
    errs = {}
    for levels in (2, 8, 256):
        p = PN.mlp_init(torch.Generator(device=dev).manual_seed(1), 1, [2], 1,
                        device=dev)
        ocfg = OptConfig(name="adam", lr=2e-2)
        opt = init_opt_state(p, ocfg)

        def mse(q, bb):
            loss = torch.mean((PN.mlp_apply(q, bb["x"], "tanh", levels)
                               - bb["y"]) ** 2)
            return loss, loss
        for s in range(PARABOLA_STEPS):
            (loss, _), g = value_and_grad(mse, p, parabola_batch(s,
                                                                 device=dev))
            p, opt, _ = apply_updates(p, g, opt, ocfg)
        errs[levels] = float(loss)
    return {"acc": acc, "tabs": tabs, "layers": layers, "xi": xi,
            "float": yf, "acc_int": acc_int, "luts": luts, "parabola": errs,
            "s": time.time() - t0}


def train_paper_mlp_checks(r: dict, smi: str) -> dict:
    """The reference's contracts, then the engine's layers on the trained
    tables: each layer's lut_matmul on the card bit-exact against the
    plain version on the same inputs, and int_mlp_forward on the card
    equal to the same call on CPU tensors."""
    import numpy as np
    import torch
    from repro_torch.core import fixedpoint as fp
    from repro_torch.kernels import lut_matmul as lm
    acc, errs = r["acc"], r["parabola"]
    dec = r["tabs"].decode(r["acc_int"])
    yf = r["float"].double().cpu().numpy()
    agree = float(np.mean(dec.argmax(-1) == yf.argmax(-1)))
    gap = float(np.abs(dec - yf).max())
    if not (acc["continuous"] > 0.85
            and acc["quantized"] > acc["continuous"] - 0.05
            and agree > 0.97 and gap < 0.6
            and errs[8] < errs[2] and errs[256] < errs[2]
            and errs[256] < 5e-3):
        raise AssertionError(f"[train] paper MLP contracts: {acc}, engine "
                             f"agreement {agree}, gap {gap}, parabola "
                             f"{errs}")
    if len(r["luts"]) != len(r["layers"]):
        raise AssertionError("[train] the engine MLP launched "
                             f"{len(r['luts'])} lut_matmul")
    for i, (a, w, table, got) in enumerate(r["luts"]):
        if not torch.equal(got, lm.lut_matmul_plain(a, w, table)):
            raise AssertionError(f"[train] lut_matmul layer {i} on the "
                                 "trained tables differs from plain")
    cpu = fp.int_mlp_forward([(w.cpu(), b.cpu()) for w, b in r["layers"]],
                             r["xi"].cpu(), r["tabs"])
    if not torch.equal(cpu, r["acc_int"].cpu()):
        raise AssertionError("[train] the trained engine MLP on the card "
                             "differs from the CPU's")
    out = {"accuracy": acc, "engine_agreement": agree, "engine_max_gap": gap,
           "parabola": errs, "s": r["s"]}
    log(f"[train] (d) {smi}: paper MLP on the card: accuracy continuous "
        f"{acc['continuous']:.4f}, |A| {ACT_LEVELS} |W| 256 "
        f"{acc['quantized']:.4f}; trained into the §4 engine (tanh |A| 16, "
        f"|W| 128): agreement with the float quantized net {agree:.4f}, max"
        f" |decode − float| {gap:.4f}, lut_matmul bit-exact against the "
        f"plain version on the trained tables, card = CPU; parabola e2 "
        f"{errs[2]:.5f} e8 {errs[8]:.5f} e256 {errs[256]:.5f}; "
        f"{r['s']:.1f}s")
    return out


def alexnet_ce(params, x, y, levels):
    import torch
    from repro_torch.models import papernets as PN
    logits = PN.alexnet_apply(params, x, "relu6", levels)
    loss = torch.mean(torch.logsumexp(logits, -1) - torch.take_along_dim(
        logits, y[:, None].long(), -1)[:, 0])
    return loss, loss


def train_alexnet(dev) -> dict:
    """(e) paper-alexnet at width 1.0, img 224, 1000 classes, relu6 at |A|
    32, batch 32 of ``class_images``: 4 adam steps (lr 1e-3, no dropout,
    as ``benchmarks/table1_alexnet.py`` trains) with a k-means |W| 1000
    event before step 2 on a 2 % subsample of all weights and biases
    (Table 1 #6), drawn from a folded generator; the subsample kept for
    the kernel check, each step synchronized."""
    import torch
    from repro_torch import configs
    from repro_torch.core import clustering
    from repro_torch.core.quantizer import (WeightQuantConfig,
                                            cluster_params, fold_in,
                                            init_state)
    from repro_torch.data.synthetic import class_images
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import papernets as PN
    from repro_torch.optim import OptConfig, apply_updates, init_opt_state
    cfg = configs.get("paper-alexnet")
    params = PN.alexnet_init(torch.Generator(device=dev).manual_seed(27),
                             n_classes=cfg.vocab, width=cfg.d_model / 96,
                             img=PAPER_IMG, device=dev)
    ocfg = OptConfig(name="adam", lr=1e-3)
    opt = init_opt_state(params, ocfg)
    wq = WeightQuantConfig(num_weights=PAPER_W, method="kmeans",
                           subsample=ALEX_SUBSAMPLE, interval=ALEX_EVENT)
    qstate = init_state(wq)
    drawn = []
    route = clustering.subsample

    def keep(values, fraction, gen):
        out = route(values, fraction, gen)
        drawn.append(out)
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, losses, event_s = [], [], None
    clustering.subsample = keep
    try:
        for s in range(ALEX_STEPS):
            if wq.due(s):
                gen = fold_in(torch.Generator(device=dev).manual_seed(27), s)
                (params, qstate), event_s = timed(lambda: cluster_params(
                    params, wq, qstate, s, gen))
            b = class_images(s, PAPER_BATCH, PAPER_IMG, n_classes=cfg.vocab,
                             device=dev)

            def step():
                (loss, _), g = value_and_grad(alexnet_ce, params, b["x"],
                                              b["y"], ACT_LEVELS)
                return (loss,) + apply_updates(params, g, opt, ocfg)[:2]
            (loss, params, opt), secs = timed(step)
            steps.append(secs)
            losses.append(float(loss))
    finally:
        clustering.subsample = route
    return {"params": params, "qstate": qstate, "drawn": drawn,
            "steps": steps, "losses": losses, "event_s": event_s,
            "peak": torch.cuda.max_memory_allocated(),
            "n_params": sum(t.numel() for t in _leaves(params))}


def train_alexnet_checks(r: dict, smi: str) -> dict:
    import statistics
    import torch
    if len(r["drawn"]) != 1 or r["qstate"].last_step != ALEX_EVENT:
        raise AssertionError("[train] AlexNet: no subsampled event")
    v, book = r["drawn"][0], r["qstate"].codebooks[""]
    if v.numel() != int(r["n_params"] * ALEX_SUBSAMPLE) or \
            book.numel() != PAPER_W:
        raise AssertionError(f"[train] AlexNet subsample {v.numel()} of "
                             f"{r['n_params']}, {book.numel()} centers")
    if not all(math_finite(x) for x in r["losses"]) or not all(
            bool(torch.isfinite(t).all()) for t in _leaves(r["params"])):
        raise AssertionError("[train] AlexNet: not finite")
    km = kmeans_case(v, book)
    out = {"params": r["n_params"], "losses": r["losses"],
           "step_ms": statistics.median(r["steps"][1:]) * 1e3,
           "first_step_ms": r["steps"][0] * 1e3,
           "peak_gib": r["peak"] / 2**30, "event_s": r["event_s"],
           "subsample": v.numel(), "kmeans_vs_plain": km}
    log(f"[train] (e) {smi}: paper-alexnet width 1.0 img {PAPER_IMG}, "
        f"{r['n_params']} params, relu6 |A| {ACT_LEVELS}, batch "
        f"{PAPER_BATCH}, {ALEX_STEPS} adam steps: step "
        f"{out['step_ms']:.1f} ms (median after the first; first "
        f"{out['first_step_ms']:.1f}), peak {out['peak_gib']:.2f} GiB "
        f"allocated; k-means |W| {PAPER_W} event at step {ALEX_EVENT} on a "
        f"{ALEX_SUBSAMPLE:.0%} subsample ({v.numel()} values) "
        f"{r['event_s']:.2f}s, kmeans_assign on them against the plain "
        f"version: {km_text(km)}; losses "
        f"{[round(x, 4) for x in r['losses']]}")
    return out


def train_path(dev, smi: str) -> tuple[dict, dict]:
    """The [train] phase: (a) the reduced trainer card against CPU and the
    resume, uncounted; then, with every launch count set to 0, the driven
    path: (c) codebook_matmul's gradient, (b) the full-width trainer, (d)
    the paper MLP's loop, (e) AlexNet's steps with the subsampled event;
    the launches held exactly to the code's count; then the checks, the
    recorded act_quant launches first, against the plain version."""
    import torch
    from repro_torch.kernels import ops
    t0 = time.time()
    red = train_reduced(dev)
    t_red = time.time() - t0
    acts = []
    ops.reset_launch_counts()
    cm_cases = train_codebook_grad(dev)
    full = train_full(dev, acts)
    t_full = time.time() - t0 - t_red
    with record_act_quant(acts):
        mlp = train_paper_mlp(dev)
        alex = train_alexnet(dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    L = full["cfg"].n_layers
    # act_quant: each FFN of the full width's forwards and remat
    # recomputes; the MLP loops' one hidden site a forward (250 quantized
    # steps + 5 accuracy batches, 200 engine steps + the float net, 3 ×
    # 600 parabola steps); AlexNet's 7 sites a step.  kmeans_assign: 2 ×
    # 25 Lloyd steps of AlexNet's event; lut_matmul: the engine MLP's 2
    # layers; codebook_matmul: (c)'s two forwards
    want = {"act_quant": 2 * L * TRAIN_FULL["steps"]
            + MLP_STEPS + 5 + MLP_ENGINE_STEPS + 1 + 3 * PARABOLA_STEPS
            + 7 * ALEX_STEPS,
            "kmeans_assign": 50, "lut_matmul": 2, "codebook_matmul": 2}
    rec_check("[train] the driven path", launches, want)
    t_path = time.time() - t0 - t_red
    act_par = paper_act_parity(acts)
    del acts
    log(f"[train] act_quant on the driven path's own inputs: "
        f"{act_par['launches']} launches against the plain version: "
        f"bit-equal but for {act_par['ties']} level-boundary ties, relu6 "
        f"bit-equal; max abs err {act_par['max_abs_err']:.3e}")
    stats = {"reduced": red, "act_quant_vs_plain": {
                 k: act_par[k] for k in ("launches", "ties", "max_abs_err")},
             "codebook_grad": train_codebook_checks(cm_cases),
             "full": train_full_checks(full, smi),
             "mlp": train_paper_mlp_checks(mlp, smi),
             "alexnet": train_alexnet_checks(alex, smi),
             "reduced_s": t_red, "full_s": t_full, "path_s": t_path}
    del full, mlp, alex, cm_cases
    torch.cuda.empty_cache()
    stats["phase_s"] = time.time() - t0
    log(f"[train] {smi}: phase {stats['phase_s']:.1f}s (reduced "
        f"{t_red:.1f}s, driven path {t_path:.1f}s of which full width "
        f"{t_full:.1f}s); launches {launches}")
    return stats, launches


TF_ARCHS = ("qwen3-moe-30b-a3b", "grok-1-314b", "rwkv6-7b", "zamba2-2.7b",
            "whisper-small", "qwen2-vl-7b")
TF_REDUCED = dict(B=2, S=16, steps=6)
TF_REDUCED_EVENT = 3      # laplacian_l1 |W| 1000, global, at step 3
# full width: layers, rows, tokens a row, the event's method.  qwen3-moe
# runs 2 of its 48 layers (1.87e9 params, 1.21e9 of them experts) with
# the donated step; without donation its adamw update ran out of an H100
# 80GB HBM3's memory there (65.6 GiB allocated and 11.7 reserved: the new
# params and f32 moments built beside the old ones, which the trainer's
# frame also held), so 1 layer ran until the trainer donated
TF_FULL = {"qwen3-moe-30b-a3b": (2, 4, 128, "laplacian_l1"),
           "rwkv6-7b": (4, 2, 128, "kmeans"),
           "zamba2-2.7b": (6, 4, 128, "laplacian_l1"),
           "whisper-small": (12, 2, 64, "laplacian_l1"),
           "qwen2-vl-7b": (4, 2, 128, "laplacian_l1")}
TF_FULL_STEPS, TF_FULL_EVENT = 4, 2
TF_VLM_MICROBATCHES = 2   # one more qwen2-vl step, positions split
TF_ACT_RECORDS = 64       # act_quant launches a model held to the plain
# locked sites and streams, card vs CPU, of the largest |x|: the two runs'
# params part a little more each step where adam's normalized step turns
# a noise-level gradient difference into a step of up to ±lr (qwen2-vl's
# reduced model on an H100 80GB HBM3: 9.3e-5 by step 2, past [train]'s
# 1e-5 of 4.0)
TF_LOCK_REL = 1e-4
def tf_sites(cfg) -> int:
    """FFN activation sites (``ffn_act``, one act_quant launch each at
    act_levels > 0) a forward: a SwiGLU a layer (dense, vlm); the experts'
    buffer a layer and token chunk (moe); rwkv's gate and channel mix a
    layer; the hybrid's conv and gate a Mamba2 block and the shared
    block's SwiGLU a group; whisper's biased MLP an encoder and a decoder
    layer."""
    if cfg.family == "moe":
        return cfg.n_layers * max(1, cfg.moe_token_chunks)
    if cfg.family == "ssm_rwkv":
        return 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return 2 * cfg.n_layers + cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "audio":
        return cfg.n_layers + cfg.enc_layers
    return cfg.n_layers


@contextlib.contextmanager
def wkv_streams(records: dict, stats: dict | None = None):
    """The WKV scan's bf16 streams (r, k and v in, y out,
    ``rwkv._wkv_scan``) and their cotangents, bf16 too.  Without
    ``stats`` each call appends its streams, on the host, to
    ``records['fwd']``, and each cotangent, as the backward reaches it, to
    ``records[name]`` (the CPU run).  With ``stats`` each call takes the
    next record and holds its streams to it as
    ``tests/recurrent_rig.lock_streams(straight=True)`` does (each
    element within ``TF_LOCK_REL`` of the stream's largest |value|, as
    ``ffn_sites``' inputs, or one bf16 step apart: a rounding tie,
    counted), then goes on with the recorded values, straight through, so
    the gradient still flows through the card's scan; each cotangent is
    held to the CPU's in the backward's order the same way and replaced
    by it (the card run)."""
    import torch
    from repro_torch.models import rwkv as R
    route = R._wkv_scan

    def close(got, want, name):
        tol = TF_LOCK_REL * max(1.0 if len(name) == 1 else 0.0,
                                   float(want.float().abs().max()))
        far = (got.float() - want.float()).abs() > tol
        if bool(far.any()):
            if bf16_steps(got[far], want[far]) > 1:
                raise AssertionError(f"[train_families] WKV stream {name}: "
                                     "card and CPU part by more than a "
                                     "bf16 step")
            stats[name] += int(far.sum())

    def keep(t, name):
        if t.requires_grad:
            t.register_hook(lambda g: records[name].append(g.detach().cpu()))
        return t

    def record(r, k, v, u, logw, cfg, s0=None):
        r, k, v = (keep(a, n) for a, n in zip((r, k, v), "rkv"))
        y, s = route(r, k, v, u, logw, cfg, s0)
        records["fwd"].append([a.detach().cpu() for a in (r, k, v, y)])
        return keep(y, "y"), s

    def held(a, want, name):
        close(a.detach(), want, name)
        af = a.float()
        out = (af + (want.float() - af).detach()).to(torch.bfloat16)

        def hold(g):
            w = records[name].pop(0).to(g.device)
            close(g, w, "d" + name)
            return w.to(g.dtype)
        if out.requires_grad:
            out.register_hook(hold)
        return out

    def lock(r, k, v, u, logw, cfg, s0=None):
        want = [t.to(r.device) for t in records["fwd"].pop(0)]
        r, k, v = (held(a, w, n) for a, w, n in zip((r, k, v), want, "rkv"))
        y, s = route(r, k, v, u, logw, cfg, s0)
        stats["scans"] += 1
        return held(y, want[3], "y"), s

    R._wkv_scan = record if stats is None else lock
    try:
        yield
    finally:
        R._wkv_scan = route


@contextlib.contextmanager
def moe_routes(out: list):
    """Each MoE dispatch's decisions (``moe._dispatch_local``): the expert
    ids, buffer slots and kept entries, on the host, appended to
    ``out``."""
    from repro_torch.models import moe as M
    route = M._dispatch_local

    def spy(x_flat, ids, *args):
        buf, slot, keep = route(x_flat, ids, *args)
        out.append([a.detach().cpu() for a in (ids, slot, keep)])
        return buf, slot, keep

    M._dispatch_local = spy
    try:
        yield
    finally:
        M._dispatch_local = route


def tf_batch(cfg, B: int, S: int, dev) -> dict:
    """The inputs of a family whose batches carry more than tokens
    (whisper's frames, the vlm's embeddings and M-RoPE positions),
    ``fam_batch``'s, drawn on the CPU and moved: the same on both
    devices."""
    return _to(fam_batch(cfg, B, S, 29, "cpu"), dev)


def tf_loop(cfg, dev, params, batch: dict, steps: int, seed: int = 0):
    """``launch/train.py``'s loop for the families whose batches
    ``TokenPipeline`` cannot give (``train`` feeds tokens only and fails
    on them, as the reference's does): each step the clustering event
    when ``cfg.wq.due(step)`` (``train.cluster_params`` on a generator
    folded from the seed and the step), then ``make_train_step`` (adamw,
    lr 3e-3, ``warmup_cosine(20, steps)``, donated as the trainer's: the
    params given are written) on ``batch``, synchronized and timed.
    Returns (params, quantizer state, history)."""
    import torch
    from repro_torch.core.quantizer import fold_in, init_state
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train as TT
    from repro_torch.models.model_zoo import build
    from repro_torch.optim import OptConfig, init_opt_state, warmup_cosine
    dev = torch.device(dev)
    ocfg = OptConfig(name="adamw", lr=3e-3, schedule=warmup_cosine(20, steps),
                     moments_dtype=cfg.moments_dtype)
    step_fn = ST.make_train_step(build(cfg), ocfg, donate=True)
    opt, qstate, hist = init_opt_state(params, ocfg), init_state(cfg.wq), []
    for step in range(steps):
        t = time.perf_counter()
        if cfg.wq.due(step):
            gen = torch.Generator(device=dev).manual_seed(seed)
            params, qstate = TT.cluster_params(params, cfg.wq, qstate, step,
                                               fold_in(gen, step))
        params, opt, m = step_fn(params, opt, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        hist.append({"step": step, "loss": float(m["loss"]),
                     "sec": time.perf_counter() - t})
    return params, qstate, hist


def tf_train(cfg, dev, box: list, B: int, S: int, steps: int):
    """Train ``cfg`` from the params in the one-element list ``box`` (on
    ``dev``): the token families through ``launch.train.train``
    (``Model.init`` answering them), whisper and the vlm through
    ``tf_loop`` on ``tf_batch``.  Both donate, so the tree is trained in
    place; it is taken out of ``box``, so that no frame but the loop's
    holds it and a clustering event's input is freed, as in the trainer.
    Returns (params, quantizer state, history)."""
    from repro_torch.launch import train as TT
    from repro_torch.models.model_zoo import Model
    if cfg.family in ("audio", "vlm"):
        return tf_loop(cfg, dev, box.pop(), tf_batch(cfg, B, S, dev), steps)
    route = Model.init
    Model.init = lambda self, gen, device=None: box.pop()
    try:
        return TT.train(cfg, TT.TrainLoopConfig(
            steps=steps, batch=B, seq=S, log_every=1, device=str(dev)),
            log=lambda *a: None)
    finally:
        Model.init = route


@contextlib.contextmanager
def tf_event_lock(records: list, stats: dict | None = None):
    """The clustering event (``train.cluster_params``): without ``stats``
    each event appends its snapped params and codebook, on the host, to
    ``records`` (the CPU run); with ``stats`` the card's own event is held
    to the next record (its codebook within ``KM_RTOL`` of the CPU's
    largest |center|; a weight on another center than the CPU's only one
    center apart: the centers' last bits move a weight lying near a
    midpoint, counted) and the run goes on with the CPU's params and
    codebook, moved (the card run), as ``ffn_sites`` goes on with the
    CPU's activations."""
    import torch
    from repro_torch.core.quantizer import QuantizerState
    from repro_torch.launch import train as TT
    route = TT.cluster_params

    def record(params, wq, qstate, step, gen):
        out = route(params, wq, qstate, step, gen)
        # a copy (the CPU run's tree): the donated steps after the event
        # write ``out[0]``
        records.append((_clone(out[0]), out[1].codebooks[""].cpu()))
        return out

    def lock(params, wq, qstate, step, gen):
        got, gq = route(params, wq, qstate, step, gen)
        want, book = records.pop(0)
        mine = gq.codebooks[""].cpu()
        gap = float((mine - book).abs().max() / book.abs().max())
        if mine.shape != book.shape or gap > KM_RTOL:
            raise AssertionError(f"[train_families] the card's codebook is "
                                 f"{gap:.3e} of the largest |center| from "
                                 "the CPU's")
        for g, w in zip(_leaves(got), _leaves(want)):
            g = g.cpu()
            far = g != w
            if bool(far.any()):
                ids = [torch.searchsorted(b, v.float().contiguous())
                       for b, v in ((mine, g[far]), (book, w[far]))]
                if bool(((ids[0] - ids[1]).abs() > 1).any()):
                    raise AssertionError("[train_families] a weight the "
                                         "card snaps two centers from the "
                                         "CPU's")
                stats["moved"] += int(far.sum())
            stats["values"] += g.numel()
        dev = next(_leaves(got)).device
        return _to(want, dev), QuantizerState(
            codebooks={"": book.to(dev)}, last_step=gq.last_step)

    TT.cluster_params = record if stats is None else lock
    try:
        yield
    finally:
        TT.cluster_params = route


def train_families_reduced(dev) -> dict:
    """(a) Each family's reduced model (grok-1-314b with 2 token chunks,
    as ``[moe]`` runs it) at ``quant_cfg`` (act_levels 32, laplacian_l1
    |W| 1000, the event at step 3), 6 steps on the CPU, then on the card
    from the same initial params (the CPU's, moved: a CUDA generator
    draws other numbers), every FFN site locked to the CPU run's
    (``ffn_sites``, inputs within ``TF_LOCK_REL``), rwkv's WKV streams (``wkv_streams``) and the event
    (``tf_event_lock``) too: each logged loss within ``TRAIN_LOSS_TOL``,
    flips, ties and weights snapped a center apart counted, every MoE
    dispatch's decisions equal, the event run on both."""
    import torch
    from repro_torch import configs
    from repro_torch.models.model_zoo import build
    out = {}
    for name in TF_ARCHS:
        t0 = time.time()
        cfg = quant_cfg(configs.get(name).reduced(), TF_REDUCED_EVENT)
        if name == "grok-1-314b":
            cfg = cfg.replace(moe_token_chunks=2)
        init = build(cfg).init(torch.Generator().manual_seed(0), "cpu")
        recs, routes = [], {"cpu": [], "card": []}
        streams = {n: [] for n in ("fwd", "r", "k", "v", "y")}
        evs, snap = [], {"moved": 0, "values": 0}
        with ffn_sites(recs), wkv_streams(streams), tf_event_lock(evs), \
                moe_routes(routes["cpu"]):
            # a copy: the donated CPU run writes it, and the card starts
            # from ``init``
            _, cq, cpu = tf_train(cfg, "cpu", [_clone(init)], **TF_REDUCED)
        lock = {"sites": 0, "acts": 0, "flips": 0, "max_input_gap": 0.0}
        ties = {n: 0 for n in ("r", "k", "v", "y", "dr", "dk", "dv", "dy",
                               "scans")}
        with ffn_sites(recs, lock, TF_LOCK_REL), \
                wkv_streams(streams, ties), \
                tf_event_lock(evs, snap), moe_routes(routes["card"]):
            _, gq, card = tf_train(cfg, dev, [_to(init, dev)], **TF_REDUCED)
        if recs or evs or any(streams.values()):
            raise AssertionError(f"[train_families] {name}: the card ran "
                                 "fewer FFN sites or scans than the CPU")
        gap = max(abs(a["loss"] - b["loss"]) for a, b in zip(card, cpu))
        if [h["step"] for h in card] != [h["step"] for h in cpu] or \
                gap > TRAIN_LOSS_TOL:
            raise AssertionError(f"[train_families] reduced {name} losses "
                                 f"card vs CPU: {gap}")
        if (gq.last_step, cq.last_step) != (TF_REDUCED_EVENT,) * 2:
            raise AssertionError(f"[train_families] {name}: the clustering "
                                 "event did not run")
        if len(routes["card"]) != len(routes["cpu"]) or not all(
                torch.equal(a, b) for ra, rb in zip(routes["card"],
                                                    routes["cpu"])
                for a, b in zip(ra, rb)):
            raise AssertionError(f"[train_families] {name}: the card's MoE "
                                 "routing differs from the CPU's")
        dropped = sum(int((~r[2]).sum()) for r in routes["cpu"])
        out[name] = {"loss_gap": gap, "lock": lock, "event": snap,
                     "losses": [h["loss"] for h in card],
                     "dispatches": len(routes["cpu"]), "dropped": dropped,
                     "wkv_ties": ties if ties["scans"] else None,
                     "s": time.time() - t0}
        log(f"[train_families] (a) reduced {name} at --quant, "
            f"{TF_REDUCED['steps']} steps, event at {TF_REDUCED_EVENT}: card "
            f"vs CPU max |Δloss| {gap:.3e} (gate {TRAIN_LOSS_TOL}); "
            f"{lock['sites']} FFN sites locked, {lock['flips']} flips at "
            f"boundary ties in {lock['acts']} activations, inputs within "
            f"{lock['max_input_gap']:.3e}; the event held to the CPU's, "
            f"{snap['moved']} of {snap['values']} weights one center apart"
            + (f"; {len(routes['cpu'])} MoE dispatches equal ({dropped} "
               "entries dropped at capacity)" if routes["cpu"] else "")
            + (f"; WKV streams {ties}" if ties["scans"] else "")
            + f"; {out[name]['s']:.1f}s")
    return out


@contextlib.contextmanager
def tf_events(events: list):
    """Each clustering event through ``train.cluster_params``, timed and
    checked as it returns: every weight against the codebook's centers in
    the weight's own dtype (the f32 MoE router's in f32), the ones off
    every center counted."""
    import torch
    from repro_torch.launch import train as TT
    route = TT.cluster_params

    def event(params, wq, qstate, step, gen):
        out, secs = timed(lambda: route(params, wq, qstate, step, gen))
        books, off, n = {}, 0, 0
        for leaf in _leaves(out[0]):
            if leaf.dtype not in books:
                books[leaf.dtype] = torch.unique(
                    out[1].codebooks[""].to(leaf.dtype)).float()
            book = books[leaf.dtype]
            v = leaf.reshape(-1).float()
            i = torch.searchsorted(book, v).clamp(max=book.numel() - 1)
            off += int((book[i] != v).sum())
            n += v.numel()
        events.append({"step": step, "s": secs, "values": n,
                       "off_center": off, "method": wq.method,
                       "book": int(out[1].codebooks[""].numel())})
        return out

    TT.cluster_params = event
    try:
        yield
    finally:
        TT.cluster_params = route


@contextlib.contextmanager
def tf_records(acts: list, kms: list, cap: int):
    """The first ``cap`` act_quant launches of the run, as
    ``record_act_quant`` records them, and its first kmeans_stats call
    (the values and centers), to hold against the plain versions
    afterwards.  The wrappers and their launch counts stay the kernels'
    own."""
    from repro_torch.kernels import ops
    aq, km = ops._act_quant, ops.kmeans_stats

    def act(x, kind, levels, form, with_index, mul=None):
        got = aq(x, kind, levels, form, with_index, mul)
        if len(acts) < cap and ops._route(x) == "cuda":
            acts.append((x, kind, levels, form, mul, _detached(got)))
        return got

    def stats(values, centers, extremes=None):
        if not kms:
            kms.append((values.reshape(-1).float(), centers.float().clone()))
        return km(values, centers, extremes)

    ops._act_quant, ops.kmeans_stats = act, stats
    try:
        yield
    finally:
        ops._act_quant, ops.kmeans_stats = aq, km


def tf_full(dev, name: str) -> dict:
    """(b) ``name`` at full width, ``TF_FULL``'s layers, bf16, remat on,
    act_levels 32, its own ``microbatches``, random weights from a seeded
    CUDA generator: ``TF_FULL_STEPS`` steps (``launch.train.train`` for
    the token families, ``tf_loop`` for whisper and the vlm) with the
    |W| 1000 event of ``TF_FULL``'s method at step ``TF_FULL_EVENT``;
    the vlm then one step at ``TF_VLM_MICROBATCHES``.  Launch counts set
    to 0 before the run and read after it, held to the layer structure:
    act_quant 2 × ``tf_sites`` (a forward and its remat recompute) × the
    microbatches × the steps, kmeans_assign 2 × ``kmeans_iters`` for the
    k-means event; the first act_quant launches and the k-means values
    held to the plain versions; then one more step split into its
    gradient and its update (``train_step_split``)."""
    import dataclasses
    import statistics
    import torch
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as ST
    from repro_torch.models.model_zoo import Model, build
    from repro_torch.optim import OptConfig, init_opt_state
    n_layers, B, S, method = TF_FULL[name]
    base = configs.get(name)
    cfg = quant_cfg(base.replace(n_layers=n_layers), TF_FULL_EVENT)
    cfg = cfg.replace(wq=dataclasses.replace(cfg.wq, method=method))
    nmb = max(1, cfg.microbatches)
    events, acts, kms, fp = [], [], [], {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    box = [build(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)]
    n_params = sum(t.numel() for t in _leaves(box[0]))
    fp = [float(t.float().sum()) for t in _leaves(box[0])]
    t_init = time.time() - t0
    ops.reset_launch_counts()
    with tf_events(events), tf_records(acts, kms, TF_ACT_RECORDS):
        params, qstate, hist = tf_train(cfg, dev, box, B, S, TF_FULL_STEPS)
        want = {"act_quant": 2 * tf_sites(cfg) * nmb * TF_FULL_STEPS}
        batch = tf_batch(cfg, B, S, dev) if cfg.family in (
            "audio", "vlm") else None
        mb_loss = None
        if cfg.family == "vlm":
            mcfg = cfg.replace(microbatches=TF_VLM_MICROBATCHES)
            ocfg = OptConfig(name="adamw", lr=3e-3)
            step_fn = ST.make_train_step(build(mcfg), ocfg, donate=True)
            params, _, m = step_fn(params, init_opt_state(params, ocfg),
                                   batch)
            mb_loss = float(m["loss"])
            want["act_quant"] += 2 * tf_sites(cfg) * TF_VLM_MICROBATCHES
        torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    if method == "kmeans":
        want["kmeans_assign"] = 2 * cfg.wq.kmeans_iters
    rec_check(f"[train_families] (b) {name}", launches, want)
    peak = torch.cuda.max_memory_allocated()
    leaves = list(_leaves(params))
    finite = all(bool(torch.isfinite(t).all()) for t in leaves)
    moved = sum(float(t.float().sum()) != f for t, f in zip(leaves, fp))
    losses = [h["loss"] for h in hist] + ([mb_loss] if mb_loss is not None
                                          else [])
    ev = events
    if not finite or not all(math_finite(x) for x in losses) or not moved:
        raise AssertionError(f"[train_families] {name}: losses {losses}, "
                             f"params finite {finite}, {moved} leaves moved")
    if len(ev) != 1 or ev[0]["step"] != TF_FULL_EVENT or \
            ev[0]["off_center"] or ev[0]["values"] != n_params or \
            ev[0]["book"] != cfg.wq.num_weights:
        raise AssertionError(f"[train_families] {name} event: {ev}")
    act_par = paper_act_parity(acts)
    del acts
    km = kmeans_case(*kms[0]) if kms else None
    del kms
    step_ms = statistics.median(h["sec"] for h in hist[1:]) * 1e3
    split = train_step_split(cfg, params, batch)
    del params
    out = {"layers": n_layers, "of": base.n_layers, "params": n_params,
           "batch": [B, S], "microbatches": nmb, "losses": losses,
           "step_ms": step_ms, "first_step_ms": hist[0]["sec"] * 1e3,
           "event_step_ms": hist[TF_FULL_EVENT]["sec"] * 1e3,
           "tokens_per_s": B * S / step_ms * 1e3, "peak_gib": peak / 2 ** 30,
           "event": ev[0], "launches": launches, "init_s": t_init,
           "act_quant_vs_plain": {k: act_par[k] for k in
                                  ("launches", "ties", "max_abs_err")},
           "kmeans_vs_plain": km, "split": split,
           "moved_leaves": moved, "leaves": len(fp),
           "s": time.time() - t0}
    log(f"[train_families] (b) {name}: {n_layers} of {base.n_layers} layers "
        f"at full width, {n_params} params, {cfg.dtype}, remat {cfg.remat}, "
        f"act_levels {cfg.act_levels}, {B} × {S} tokens, microbatches {nmb}"
        f", {TF_FULL_STEPS} steps: losses {[round(x, 4) for x in losses]}; "
        f"step {step_ms:.1f} ms (median after the first; first "
        f"{out['first_step_ms']:.1f}, the event's {out['event_step_ms']:.1f})"
        f"; a step apart: forward and backward {split['grad_ms']:.1f} ms "
        f"wall, {split['grad']['busy_ms']:.1f} busy, idle "
        f"{split['grad']['idle_share']:.3f}, {split['grad']['kernels']} "
        f"kernels; update {split['update_ms']:.1f} ms wall, "
        f"{split['update']['busy_ms']:.1f} busy, idle "
        f"{split['update']['idle_share']:.3f}; peak {out['peak_gib']:.2f} "
        f"GiB; event ({ev[0]['method']}) at step {ev[0]['step']} "
        f"{ev[0]['s']:.2f}s, every one of {ev[0]['values']} weights on one "
        f"of the {ev[0]['book']} centers; launches {launches} (held); "
        f"act_quant against the plain version on {act_par['launches']} of "
        f"the path's launches: {act_par['ties']} ties, max abs err "
        f"{act_par['max_abs_err']:.3e}"
        + (f"; kmeans_assign at the event's n against the plain version "
           f"{json.dumps(km)}" if km else "")
        + f"; {out['s']:.1f}s")
    torch.cuda.empty_cache()
    return out


def train_families_path(dev, smi: str) -> tuple[dict, dict]:
    """The [train_families] phase: (a) the reduced families card against
    CPU, uncounted; then (b) each family at full width (``tf_full``, its
    launch counts set to 0 before it and read after it); grok-1-314b at
    full width left out, the reason logged.  Returns (stats, the driven
    path's launches)."""
    from repro_torch import configs
    t0 = time.time()
    red = train_families_reduced(dev)
    t_red = time.time() - t0
    full, launches = {}, {}
    for name in TF_FULL:
        full[name] = tf_full(dev, name)
        for k, v in full[name]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    g = configs.get("grok-1-314b")
    mat = g.n_experts * g.d_model * g.d_ff       # one layer's w1, w3 or w2
    log(f"[train_families] grok-1-314b left out at full width: one layer "
        f"holds {3 * mat:.3e} expert weights; bf16 params, gradients and "
        f"{g.moments_dtype} adam moments, the update's new moments beside "
        f"the old (10 bytes a weight), come to {30 * mat / 1e9:.1f} GB, "
        f"and the update's f32 temporaries of one expert matrix "
        f"({mat:.3e} values) {4 * mat / 1e9:.1f} GB each, before any "
        f"activation; its reduced model runs in (a)")
    stats = {"reduced": red, "full": full, "reduced_s": t_red,
             "phase_s": time.time() - t0}
    log(f"[train_families] {smi}: phase {stats['phase_s']:.1f}s (reduced "
        f"{t_red:.1f}s); launches {launches}")
    return stats, launches


# --- [examples] --------------------------------------------------------------

# the port's examples, each run through its main(argv) at the reference's
# defaults; the 100m example then once more on the same checkpoint
# directory, EX_LM_RESUME steps in all: its last EX_LM_RESUME - 200 steps
# after the resume
EX_SERVE, EX_QUICK = "serve_quantized_lm_torch", "quickstart_torch"
EX_MNIST, EX_LM = "train_mnist_quantized_torch", "train_lm_100m_torch"
EX_LM_STEPS, EX_LM_RESUME = 200, 210
EX_MNIST_STEPS = 5 * 300        # five variants of 300 steps
EX_MNIST_FLOOR, EX_MNIST_GAP = 0.85, 0.05   # tests/test_torch_papernets_train


def example_module(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(name: str, argv: list) -> dict:
    """``main(argv)`` of the example in this process, stdout captured (and
    echoed to the log): its result, lines, wall seconds, peak memory
    allocated and the kernel launches it made."""
    import io
    import torch
    mod = example_module(name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()

    def call():
        with contextlib.redirect_stdout(buf):
            return mod.main(argv)
    (res, wall), launches = rec_counted(lambda: timed(call))
    lines = buf.getvalue().splitlines()
    for ln in lines:
        log(f"[examples] {name} | {ln}")
    return {"result": res, "lines": lines, "s": wall,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches}


def _finite_numerics(num: dict) -> bool:
    vals = [v for v in num.values() if isinstance(v, (int, float))]
    vals += [x for v in num.values() if isinstance(v, list) for x in v]
    return bool(vals) and all(math_finite(float(x)) for x in vals)


def examples_serving(r: dict) -> dict:
    """The spec line says identical tokens; every probe figure finite; the
    paged pool clean; each backend launched its own kernel and no other
    backend's (dense none), page_gather on the paged run, both matmul
    kernels in the spec serve (codebook target, lut draft)."""
    res, launches = r["result"], r["result"]["launches"]
    spec = next(ln for ln in r["lines"] if ln.startswith("[    spec]"))
    mm = {"dense": set(), "codebook": {"codebook_matmul"},
          "lut": {"lut_matmul"}, "paged": set(),
          "spec": {"codebook_matmul", "lut_matmul"}}
    bad = [k for k, want in mm.items()
           if {n for n in launches.get(k, {}) if n.endswith("_matmul")}
           != want]
    if "identical tokens" not in spec or not res["spec_identical"] or bad \
            or not launches["paged"].get("page_gather") \
            or not all(_finite_numerics(n) for n in res["numerics"].values()) \
            or not _pool_clean(res["paged"].pool):
        raise AssertionError(f"[examples] {EX_SERVE}: {spec}; launches "
                             f"{launches}; pool clean "
                             f"{_pool_clean(res['paged'].pool)}")
    return {"launches_by_run": launches,
            "headroom_bits_min": {k: min(n["headroom_bits"] or [31.0])
                                  for k, n in res["numerics"].items()},
            "kv_err_max": {k: max(n["kv_err_max"] or [0.0])
                           for k, n in res["numerics"].items()}}


def examples_quickstart(r: dict) -> dict:
    hist, toks = r["result"]["history"], r["result"]["tokens"]
    if not hist[-1]["loss"] < hist[0]["loss"] or len(toks) != 12:
        raise AssertionError(f"[examples] {EX_QUICK}: losses "
                             f"{hist[0]['loss']} -> {hist[-1]['loss']}, "
                             f"{len(toks)} tokens")
    return {"losses": [hist[0]["loss"], hist[-1]["loss"]],
            "step_ms": step_median_ms(hist), "tokens": toks}


def examples_mnist(r: dict) -> dict:
    acc = r["result"]
    base, both = acc["continuous tanh"], acc["tanhD(32) + |W|=1000"]
    if not base > EX_MNIST_FLOOR or abs(both - base) > EX_MNIST_GAP:
        raise AssertionError(f"[examples] {EX_MNIST}: accuracies {acc}")
    return {"accuracy": acc}


def examples_lm(r: dict, again: dict, ckpt: str) -> dict:
    """The count printed from ``abstract_params`` is the trained tree's;
    the losses finite; a checkpoint at the last step; the resumed run
    starts there."""
    from repro_torch import checkpoint as CKPT
    res, hist = r["result"], r["result"]["history"]
    n = sum(t.numel() for t in _leaves(res["params"]))
    first = again["result"]["history"][0]["step"]
    if res["n_params"] != n or not all(math_finite(h["loss"]) for h in
                                       hist + again["result"]["history"]) \
            or again["lines"][1] != f"[resume] from step {EX_LM_STEPS}" \
            or first != EX_LM_STEPS or CKPT.latest_step(ckpt) != EX_LM_RESUME:
        raise AssertionError(f"[examples] {EX_LM}: {res['n_params']} params "
                             f"counted, {n} trained; resume "
                             f"{again['lines'][:2]}, first step {first}")
    return {"params": n, "losses": [h["loss"] for h in hist],
            "step_ms": step_median_ms(hist),
            "resume_step_ms": step_median_ms(again["result"]["history"]),
            "resumed_from": first}


def step_median_ms(hist: list) -> float:
    """The median of the logged steps' seconds after the first, in ms."""
    import statistics
    return statistics.median(h["sec"] for h in hist[1:]) * 1e3


def examples_path(dev, smi: str) -> tuple[dict, dict]:
    """The [examples] phase: with every launch count set to 0, the four
    examples through their ``main`` on the card at the reference's
    defaults (the 100m one twice on one checkpoint directory, the second
    run resuming), their launches read after; then each held to its
    checks.  Returns (stats, launches)."""
    import tempfile
    import torch
    from repro_torch.kernels import ops
    t0 = time.time()
    ops.reset_launch_counts()
    runs = {EX_SERVE: run_example(EX_SERVE, []),
            EX_QUICK: run_example(EX_QUICK, []),
            EX_MNIST: run_example(EX_MNIST, [])}
    with tempfile.TemporaryDirectory(prefix="lm100m_") as ckpt:
        runs[EX_LM] = run_example(EX_LM, ["--ckpt-dir", ckpt])
        again = run_example(EX_LM, ["--ckpt-dir", ckpt, "--steps",
                                    str(EX_LM_RESUME)])
        lm = examples_lm(runs[EX_LM], again, ckpt)
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    checks = {EX_SERVE: examples_serving(runs[EX_SERVE]),
              EX_QUICK: examples_quickstart(runs[EX_QUICK]),
              EX_MNIST: examples_mnist(runs[EX_MNIST]), EX_LM: lm}
    stats = {}
    for name, r in runs.items():
        st = {"s": r["s"], "peak_gib": r["peak_gib"],
              "launches": r["launches"], **checks[name]}
        if name == EX_MNIST:    # no per-step clock: the wall over the steps
            st["wall_ms_a_step"] = r["s"] * 1e3 / EX_MNIST_STEPS
        stats[name] = st
        log(f"[examples] {smi}: {name}: {r['s']:.1f}s wall, peak "
            f"{r['peak_gib']:.2f} GiB allocated, launches {r['launches']}; "
            + json.dumps({k: v for k, v in st.items()
                          if k not in ("s", "peak_gib", "launches")}))
    stats[EX_LM]["resume"] = {"s": again["s"], "peak_gib": again["peak_gib"],
                              "launches": again["launches"]}
    stats["phase_s"] = time.time() - t0
    log(f"[examples] {smi}: phase {stats['phase_s']:.1f}s; launches "
        f"{launches}")
    return stats, launches


# --- [tp]: tensor-parallel serving ---------------------------------------------

TP_WORLD = 2                 # ranks, both on cuda:0, over gloo
TP_LAYERS = 2                # the main path's depth (ROADMAP), at full width
TP_BOOK = 256                # |W|: int8 ids
TP_REQS = 4                  # requests a run, all in flight (max_batch 4)
TP_NEW = 8                   # tokens a request
TP_K = 4                     # n-gram draft tokens a round
TP_MAX_LEN = 64              # a multiple of TP_WORLD
TP_STEPS = 6                 # decode steps a step timing
TP_SUMS = 4                  # sums a layer tp=2 rounds apart (tp_bound)
TP_PAGE = 16                 # the paged runs' page: 8 rows a rank
TP_USERS = (5, 21, 11)       # the paged runs' user parts after the system page
TP_MOE_LAYERS = 2            # qwen3-moe-30b-a3b's depth, as [moe] serves it
TP3_WORLD = 3                # the TP-within-expert spawn: 128 experts % 3 > 0
TP3_TOKENS = (4, 32)         # its moe_apply input
TP3_TOL = 1e-5               # of the mesh-less call's largest |y|
TP3_LOCK_REL = 1e-4          # a rank's activation input vs one device's
TP_TRACE_SEED = 23           # tp_trace: 4 requests, 2 priorities, preempting
TP_SCHED_PAGES = 5           # the server runs' pool: 4 usable pages of TP_PAGE
TP_SCHED_LEN = 32            # the contiguous server run's cache: 16 rows a
#                              rank, which a request swapped at 20 overflows
TP_DRAIN = 0.02              # the fleet's migrating drain of r0 (virtual s)
TP_TIER_PAGES = 1            # the fleet's shared tier: whole pages it holds
TP_DRAFT_LEVELS = 512        # the model draft's lut grid


class TpRun(collections.namedtuple(
        "TpRun", "be levels spec int8 f32 paged moe probes draft server",
        defaults=(0, False, False, False, False, False, False, False, ""))):
    """One [tp] run: the backend, act_levels, n-gram spec, the int8 cache
    (``kv_quant``, or int8 pages when ``paged``), an f32 model, the page
    pool (page TP_PAGE, 2 slots, ``tp_chats``), qwen3-moe-30b-a3b
    (``tp_moe_model``) in place of qwen3-1.7b, the numerics probes, the
    model draft (the same tree on lut at TP_DRAFT_LEVELS, k TP_K), and
    ``server``: the step-level API under a scheduler (``tp_server``:
    'sched' a ``Server`` replay, 'fleet' a 2-replica ``Fleet``) on
    ``tp_trace`` instead of a ``serve``."""


# bf16 but the f32 runs; each held to tp=1 as ``tp_checks`` says
TP_RUNS = (TpRun("dense"), TpRun("codebook"), TpRun("lut"),
           TpRun("dense", spec=True), TpRun("codebook", spec=True),
           TpRun("lut", spec=True), TpRun("codebook", 32), TpRun("lut", 32),
           TpRun("codebook", int8=True), TpRun("lut", f32=True),
           TpRun("lut", spec=True, f32=True),
           TpRun("dense", paged=True), TpRun("codebook", paged=True),
           TpRun("lut", paged=True), TpRun("codebook", spec=True, paged=True),
           TpRun("codebook", int8=True, paged=True),
           TpRun("lut", f32=True, paged=True),
           TpRun("codebook", paged=True, server="sched"),
           TpRun("codebook", server="sched"),
           TpRun("codebook", paged=True, server="fleet"),
           TpRun("codebook", f32=True, probes=True),
           TpRun("lut", f32=True, probes=True),
           TpRun("codebook", int8=True, f32=True, paged=True, probes=True),
           TpRun("lut", int8=True, f32=True, paged=True, probes=True),
           TpRun("codebook", f32=True, draft=True),
           TpRun("codebook", f32=True, moe=True),
           TpRun("codebook", f32=True, paged=True, moe=True))
# the runs whose decode step is timed (the others' serves are checked only)
TP_TIMED = TP_RUNS[:11] + (TpRun("codebook", paged=True),) + tuple(
    r for r in TP_RUNS if r.server or r.probes or r.draft) + (
    TpRun("codebook", f32=True, moe=True),)
TP_LUT = TpRun("lut")              # the w2 accumulator's run
TP_CODEBOOK = TpRun("codebook")    # the parity's run
# the block matmuls of one rank at TP_WORLD = 2, as (site, K, N)
TP_SITES = (("wq", 2048, 1024), ("wk", 2048, 512), ("wv", 2048, 512),
            ("w1", 2048, 3072), ("w3", 2048, 3072), ("wo", 1024, 2048),
            ("w2", 3072, 2048))
TP_ROWS = (TP_REQS, TP_REQS * (TP_K + 1))    # decode, verify


def tp_name(run) -> str:
    return (f"{'moe/' if run.moe else ''}"
            f"{run.server + '/' if run.server else ''}{run.be}"
            f"{'/a32' if run.levels else ''}{'/ngram' if run.spec else ''}"
            f"{'/draft' if run.draft else ''}"
            f"{'/int8' if run.int8 else ''}{'/f32' if run.f32 else ''}"
            f"{'/paged' if run.paged else ''}"
            f"{'/probes' if run.probes else ''}")


def tp_model(dev):
    """qwen3-1.7b at full width, TP_LAYERS layers, seeded random weights
    compressed once to |W| = TP_BOOK (laplacian_l1, global, int8 ids):
    (cfg, index-form params)."""
    import torch
    from repro_torch import configs
    from repro_torch.core.quantizer import cluster_params, init_state
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import to_codebook_params

    cfg = configs.get("qwen3-1.7b").replace(n_layers=TP_LAYERS)
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    wq = cfg.quantized(n_weights=TP_BOOK).wq
    pq, state = cluster_params(params, wq, init_state(wq), wq.interval)
    del params
    cp = to_codebook_params(pq, wq, state)
    assert cp["blocks"]["mlp"]["w1"]["w_idx"].dtype == torch.int8
    return cfg, cp


def tp_moe_model(dev):
    """qwen3-moe-30b-a3b at full width, TP_MOE_LAYERS layers, f32, seeded
    random weights compressed as [moe] compresses them (``moe_compressed``:
    |W| = N_BOOK, the router excluded): (cfg, index-form params).  Every
    rank builds its own from the seed (``tp_fingerprint`` holds them
    equal), so 2 × 7 GB of f32 experts never go through a file."""
    import torch
    from repro_torch import configs
    from repro_torch.models.model_zoo import build
    cfg = configs.get("qwen3-moe-30b-a3b").replace(n_layers=TP_MOE_LAYERS,
                                                   dtype="float32")
    params = build(cfg).init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)
    _, cp, _, _ = moe_compressed(cfg, params)
    return cfg, cp


def tp_fingerprint(tree) -> list:
    """(path, f64 sum) of every leaf of ``tree``: equal trees, equal
    fingerprints (the sums run on one device in one order)."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        else:
            out.append((path, float(node.double().sum())))
    walk(tree, "")
    return out


def tp_chats(vocab: int) -> list:
    """The paged runs' 4 requests on 2 slots: one system prompt of
    TP_SYSTEM = TP_PAGE tokens (a full page every request shares), then
    TP_USERS tokens; the third repeats the first, so it is admitted after
    the first retired and registered its partial tail page: a prefix hit
    on that page and a copy-on-write."""
    import numpy as np
    rng = np.random.default_rng(3)
    system = rng.integers(0, vocab, TP_PAGE).tolist()
    c = [system + rng.integers(0, vocab, n).tolist() for n in TP_USERS]
    return [c[0], c[1], c[0], c[2]]


def tp_engine(cfg, cp, run, dev, mesh=None):
    """The engine of one [tp] run, on the eager route (as a mesh runs); a
    server run's has 2 slots, and a pool of TP_SCHED_PAGES or a cache of
    TP_SCHED_LEN."""
    from repro_torch.models.model_zoo import build
    from repro_torch.serving import ServeEngine, SpecConfig

    if run.f32:
        cfg = cfg.replace(dtype="float32")
    kw = (dict(paged=True, page_size=TP_PAGE, max_batch=TP_REQS // 2,
               kv_dtype="int8" if run.int8 else "bf16") if run.paged
          else dict(max_batch=TP_REQS // 2 if run.server else TP_REQS))
    if run.server and run.paged:
        kw["n_pages"] = TP_SCHED_PAGES
    max_len = TP_SCHED_LEN if run.server and not run.paged else TP_MAX_LEN
    spec = None
    if run.spec:
        spec = SpecConfig(draft="ngram", k=TP_K)
    elif run.draft:
        spec = SpecConfig(draft="model", k=TP_K, draft_params=cp,
                          draft_backend="lut", lut_levels=TP_DRAFT_LEVELS)
    e = ServeEngine(build(cfg.replace(act_levels=run.levels,
                                      kv_quant=run.int8 and not run.paged)),
                    cp, max_len=max_len, backend=run.be, device=dev,
                    mesh=mesh, probes=run.probes, spec=spec, **kw)
    e._graphs = False
    return e


def tp_trace(vocab: int, shared: bool = False) -> list:
    """The server runs' trace: TP_REQS Poisson requests of 4–24 prompt
    tokens and 4–TP_NEW new ones in 2 priorities (seed TP_TRACE_SEED:
    on 2 slots, or 4 usable pages, it preempts twice, once a request at
    position 20); ``shared`` puts one full page of system prompt before
    each (the fleet's tier pages)."""
    from repro_torch.serving.server import poisson_trace
    return poisson_trace(TP_TRACE_SEED, TP_REQS, rate=40.0, vocab=vocab,
                         plen=(4, 24), max_new=(4, TP_NEW),
                         priorities=(0, 1),
                         shared_prefix=list(range(100, 100 + TP_PAGE))
                         if shared else ())


def tp_server(mk, run, vocab: int) -> tuple:
    """A server run on engines from ``mk()`` (each counting its
    swap-outs): 'sched' one ``Server`` replaying ``tp_trace``, 'fleet' two
    replicas behind a ``Fleet`` with r0 drained at TP_DRAIN (its requests
    migrated) and a shared tier of TP_TIER_PAGES whole pages.  Returns
    (the host decisions and streams, the engines, their swap-outs)."""
    from repro_torch.serving import Fleet, SharedPrefixTier
    from repro_torch.serving.server import Server
    engines, swaps = [], [0]

    def counted():
        e = mk()
        out = e.sched_swap_out

        def swap_out(st, slot):
            swaps[0] += 1
            return out(st, slot)
        e.sched_swap_out = swap_out
        engines.append(e)
        return e

    if run.server == "sched":
        srv = Server(counted())
        rep = srv.replay(tp_trace(vocab))
        sched = srv.sched
        rec = {"events": [list(ev) for ev in sched.events],
               "streams": {str(h.rid): list(h.tokens)
                           for h in sched.handles.values()}}
    else:
        e0 = counted()
        cfg = e0.model.cfg
        page_b = 2 * cfg.n_layers * TP_PAGE * cfg.n_kv * cfg.hd * (
            4 if cfg.dtype == "float32" else 2)
        tier = SharedPrefixTier(capacity_bytes=TP_TIER_PAGES * page_b)
        fleet = Fleet({"r0": e0, "r1": counted()}, migrate_on_drain=True,
                      shared_prefix_tier=tier)
        rep = fleet.replay(tp_trace(vocab, shared=True),
                           drain_at=[(TP_DRAIN, "r0")])
        rec = {"digest": fleet.event_digest(),
               "replicas": fleet.replica_stats(),
               "tier": fleet.shared_tier_stats(),
               "migrated": [fleet.n_migrated, fleet.n_migrated_pages],
               "streams": {str(k): list(h.tokens)
                           for k, h in sorted(fleet.handles.items())}}
    rec.update(preemptions=rep.preemptions,
               pages_swapped_out=rep.pages_swapped_out,
               admission_order=rep.admission_order)
    return rec, engines, swaps[0]


def tp_serve(e, run, reqs, mk=None, vocab: int = 0) -> dict:
    """One [tp] run's work: a server run (``tp_server`` on engines from
    ``mk``), or ``e.serve`` of ``reqs``, with the probes' ``numerics()``
    and the draft's spec counters where the run has them.  Returns
    {"tokens" (a server run's streams), "rec" (its decisions), "forwards",
    "draft_forwards", "swaps", "engine" (the first engine)}."""
    if run.server:
        rec, engines, swaps = tp_server(mk, run, vocab)
        return {"tokens": rec.pop("streams"), "decisions": rec,
                "forwards": sum(x.n_forwards for x in engines),
                "draft_forwards": 0, "swaps": swaps, "engine": engines[0]}
    out = {"tokens": e.serve(reqs, max_new=TP_NEW), "forwards": e.n_forwards,
           "draft_forwards": e.n_draft_forwards, "swaps": 0, "engine": e}
    if run.probes:
        out["numerics"] = e.numerics()
    if run.draft:
        ss = e.spec_stats
        out["spec_stats"] = [ss.rounds, ss.proposed, ss.accepted, ss.emitted]
    return out


def tp_want(run, L: int, done: dict) -> dict:
    """The launches a [tp] run makes on each rank (and on one device):
    ``tp_per_forward`` a target forward, 7 lut_matmul a layer a draft
    forward (the draft's tree is whole: its grid, its products), and one
    page_gather a paged swap-out (the request's pages, all layers, one
    launch)."""
    want = {k: v * done["forwards"]
            for k, v in tp_per_forward(run, L).items()}
    if done["draft_forwards"]:
        want["lut_matmul"] = want.get("lut_matmul", 0) \
            + 7 * L * done["draft_forwards"]
    if run.paged and done["swaps"]:
        want["page_gather"] = want.get("page_gather", 0) + done["swaps"]
    return {k: v for k, v in want.items() if v}


def tp_pool_stats(e) -> dict:
    """A paged run's prefix-hit pages and copy-on-write copies, and the
    (rank's) pool."""
    st = e.pool.stats
    return {"hit_pages": st.hit_pages, "cow_copies": st.cow_copies,
            "pool_bytes": e.pool.bytes_total(),
            "pool_shape": list(e.pool.cache["k"].shape)}


def tp_record(e, out: list) -> None:
    """Record each decision of engine ``e``: every ``_sample`` call's f32
    logits (B, V) and every verify forward's (B, K + 1, V), each beside
    the active flags of its slots (all rows of an admission's prefill)."""
    import torch
    V = e.model.cfg.vocab
    fwd, sample, verify = e._forward, e._sample, e._verify_forward
    box = {}

    def forward(st):
        box["act"] = st.active.clone()
        try:
            return fwd(st)
        finally:
            box.pop("act")

    def samp(logits):
        lg = logits[:, -1, :V].float()
        act = box.get("act", torch.ones(lg.shape[0], dtype=torch.bool,
                                        device=lg.device))
        out.append((lg.cpu(), act.cpu()))
        return sample(logits)

    def ver(st):
        act = st.active.clone()
        lg = verify(st)
        out.append((lg[..., :V].float().cpu(), act.cpu()[:, None].expand(
            -1, lg.shape[1])))
        return lg

    e._forward, e._sample, e._verify_forward = forward, samp, ver


def tp_step_ms(e, mesh=None) -> dict:
    """Wall ms of an eager decode step of ``e`` (4 slots at position 32,
    31 in a cache of 32,
    synchronized; on the engine's pool when it is paged, whose pages it
    overwrites; with its probes when they are on), and under a mesh the same with each collective timed
    (``CollectiveStats.clock``; each then bracketed by synchronizations):
    its ms and the collectives' share of it."""
    import torch
    if e.paged:     # slot b on pages 1 + (b·P .. (b + 1)·P) mod the pool's
        cache = e._paged_slot_cache(TP_REQS)
        pt = cache["page_table"]
        pt.copy_(torch.arange(pt.numel(), device=e.device).reshape(pt.shape)
                 % (e.pool.n_pages - 1) + 1)
    else:
        cache = e._contiguous_cache(TP_REQS)
    cache["pos"].fill_(min(32, e.max_len - 1))
    toks = torch.zeros((TP_REQS, 1), dtype=torch.int64, device=e.device)

    def steps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TP_STEPS):
            e.model.decode(e.params, toks, e._with_probes(cache), e.bk)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / TP_STEPS * 1e3

    steps()
    out = {"step_ms": steps()}
    if mesh is not None:
        mesh.stats.clock = time.perf_counter
        mesh.stats.reset()
        out["timed_step_ms"] = steps()
        out["collective_ms"] = sum(mesh.stats.seconds.values()) * 1e3 \
            / TP_STEPS
        out["collective_share"] = out["collective_ms"] / out["timed_step_ms"]
        out["calls"] = {k: v // TP_STEPS for k, v in mesh.stats.calls.items()}
        out["step_largest"] = mesh.stats.largest()
        mesh.stats.clock = None
    return out


def tp_per_forward(run, L: int) -> dict:
    """Launches a forward of a [tp] run on each rank, as on one device: one
    page_gather a layer on the pool; the MoE's attention's four products
    and its untied head (its experts are plain)."""
    be, levels = run.be, run.levels
    out = {"page_gather": L} if run.paged else {}
    if run.moe:
        return {**out, **({"codebook_matmul": 4 * L + 1}
                          if be == "codebook" else {})}
    if be == "codebook":
        if levels:
            return {**out, "codebook_matmul": 5 * L, "codebook_swiglu": L}
        return {**out, "codebook_matmul": 7 * L}
    if be == "lut":
        return {**out, "lut_matmul": 7 * L,
                **({"act_quant": L} if levels else {})}
    return out


def tp_lut_case(dev, e, w_idx, x2, mesh=None):
    """The w2 site's int32 accumulator on ``e``'s full-fan-in spec and
    layer 0's table: on this rank's K-slice psummed under a mesh."""
    from repro_torch.distributed import collectives
    from repro_torch.kernels import dispatch
    site = e.params["blocks"]["mlp"]["w2"]
    book, table = site["codebook"][0], site["lut_table"][0]
    if mesh is None:
        return dispatch.lut_acc(x2, w_idx, book, e.lut_spec, table)
    m, k_loc = mesh.coords["model"], w_idx.shape[0]
    xl = x2[:, m * k_loc:(m + 1) * k_loc].contiguous()
    return collectives.psum(dispatch.lut_acc(xl, w_idx, book, e.lut_spec,
                                             table), mesh)


def tp_parity(e, dev) -> dict:
    """This rank's kernels at its sharded shapes against their plain
    versions: codebook_matmul (within its parity limit) and lut_matmul
    (bit-exact) on layer 0's own shards of every site at the decode and
    verify row counts, codebook_swiglu on the w1/w3 shards (bit-equal to
    the unfused chain and to the plain epilogue of its accumulators) and
    act_quant with its multiplier at the hidden shard (bit-equal but for
    counted ties).  Returns each kernel's largest |difference|."""
    import torch
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm
    from repro_torch.kernels import dispatch
    blocks = e.params["blocks"]
    g = torch.Generator(device=dev).manual_seed(5)
    worst = {"codebook_matmul": 0.0, "lut_matmul": 0.0,
             "codebook_swiglu": 0.0, "act_quant": 0.0}
    shards = {}
    for site, K, N in TP_SITES:
        p = blocks["attn" if site in ("wq", "wk", "wv", "wo") else "mlp"][site]
        wi, book = p["w_idx"][0], p["codebook"][0]
        if tuple(wi.shape) != (K, N):
            raise AssertionError(f"[tp] {site} shard {tuple(wi.shape)}, "
                                 f"want {(K, N)}")
        shards[site] = (wi, book)
        table = dispatch.build_lut_table(book, dispatch.make_lut_spec(
            book.cpu().numpy(), fan_in=K))
        for M in TP_ROWS:
            x = torch.randn((M, K), generator=g, device=dev).to(
                torch.bfloat16)
            got = cm.codebook_matmul_cuda(x, wi, book)
            want = cm.codebook_matmul_plain(x, wi, book)
            if not bool(((got - want).abs()
                         <= cm.parity_tolerance(x, wi, book)).all()):
                raise AssertionError(f"[tp] codebook_matmul {site} M={M} "
                                     "beyond its parity limit")
            worst["codebook_matmul"] = max(worst["codebook_matmul"],
                                           (got - want).abs().max().item())
            a = torch.randint(0, LEVELS, (M, K), generator=g, device=dev,
                              dtype=torch.int32)
            if not torch.equal(lm.lut_matmul_cuda(a, wi, table),
                               lm.lut_matmul_plain(a, wi, table)):
                raise AssertionError(f"[tp] lut_matmul {site} M={M} not "
                                     "bit-exact")
    (w1, b1), (w3, b3) = shards["w1"], shards["w3"]
    for M in TP_ROWS:
        x = torch.randn((M, 2048), generator=g, device=dev).to(torch.bfloat16)
        got = cm.codebook_swiglu_cuda(x, w1, b1, w3, b3, "relu6", ACT_LEVELS)
        gate, up = cm.codebook_matmul_cuda(x, w1, b1), \
            cm.codebook_matmul_cuda(x, w3, b3)
        chain = aq.act_quant_cuda(gate.to(x.dtype), "relu6", ACT_LEVELS,
                                  form="act_apply", with_index=False,
                                  mul=up.to(x.dtype))[0]
        plain = cm.swiglu_epilogue_plain(gate, up, x.dtype, "relu6",
                                         ACT_LEVELS)
        for want in (chain, plain):
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"[tp] codebook_swiglu M={M} not "
                                     "bit-equal")
        h = (gate * 0.25).to(x.dtype)
        kq = aq.act_quant_cuda(h, "relu6", ACT_LEVELS, form="act_apply",
                               mul=up.to(x.dtype))
        kp = aq.act_quant_plain(h, "relu6", ACT_LEVELS, form="act_apply",
                                mul=up.to(x.dtype))
        aq.parity_ties(*kq, *kp, "relu6", ACT_LEVELS, mul=up.to(x.dtype))
        worst["act_quant"] = max(worst["act_quant"], (
            kq[0].float() - kp[0].float()).abs().max().item())
    torch.cuda.synchronize()
    return worst


def tp_gather_parity(e) -> dict:
    """``gather_pages_many`` on this rank's own pools of layer 0 (its
    in-page slice of every page: K and V, and their scales for int8
    pages), one launch, bit-exact against the plain version on a table of
    every page and two ids out of range (clamped)."""
    import torch
    from repro_torch.kernels import page_gather as pg
    c, n = e.pool.cache, e.pool.n_pages
    pools = [c[k][0] for k in ("k", "v", "k_scale", "v_scale") if k in c]
    ids = list(range(-1, n + 1))
    ids += [1] * (-len(ids) % 4)
    pt = torch.tensor(ids, dtype=torch.int32, device=e.device).reshape(4, -1)
    got = pg.page_gather_many_cuda(pools, pt)
    want = pg.page_gather_many_plain(pools, pt)
    for a, b in zip(got, want):
        if not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            raise AssertionError(f"[tp] gather_pages_many on a rank's pool "
                                 f"{tuple(pools[0].shape)} not bit-exact")
    return {"pools": [[list(p.shape), str(p.dtype)] for p in pools],
            "table": list(pt.shape), "max_abs_err": 0.0}


def tp_rank(rank: int, path: str, cfg, prompts, chats, x2) -> dict:
    """One rank of [tp] (spawned by ``run_ranks``): every run of TP_RUNS
    on a tensor-parallel engine on cuda:0 (the MoE runs on qwen3-moe,
    which the rank builds from the seed), launches counted from 0 around
    each serve; rank 0 records the decisions.  Then the step times, the
    pools' stats, the w2 accumulator case, the gather on the rank's own
    pools and the kernels at this rank's shapes; last ``moe_apply`` at
    qwen3-moe's layer shapes over the mesh, EP (``tp_layer_rank``)."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = make_local_mesh(1, TP_WORLD)
    models = {False: (cfg, torch.load(path, map_location=dev,
                                      weights_only=True))}
    out = {"runs": {}, "rec": {}, "gather": {}}
    for run in TP_RUNS:
        if run.moe and run.moe not in models:
            models.pop(False)
            rcp = None
            gc.collect()
            torch.cuda.empty_cache()
            # one rank at a time: the clustering holds f32 copies of 1.9e9
            # values, too many for two ranks and this card at once
            for r in range(TP_WORLD):
                if r == rank:
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    models[True] = tp_moe_model(dev)
                    torch.cuda.synchronize()
                    out["moe_build_s"] = time.perf_counter() - t0
                    out["moe_build_peak_gib"] = \
                        torch.cuda.max_memory_allocated() / 2 ** 30
                    gc.collect()
                    torch.cuda.empty_cache()
                dist.barrier()
            out["moe_fingerprint"] = tp_fingerprint(models[True][1])
        rcfg, rcp = models[run.moe]
        name = tp_name(run)
        e = None if run.server else tp_engine(rcfg, rcp, run, dev, mesh)
        rec = []
        if rank == 0 and e is not None:
            tp_record(e, rec)
        mesh.stats.reset()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = tp_serve(e, run, chats if run.paged else prompts,
                        lambda: tp_engine(rcfg, rcp, run, dev, mesh),
                        rcfg.vocab)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        e = done.pop("engine")
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        want = tp_want(run, rcfg.n_layers, done)
        if launches != want:
            raise AssertionError(f"[tp] rank {rank} {name}: launches "
                                 f"{launches} over {done['forwards']} "
                                 f"forwards, want {want}")
        r = {**done, "launches": launches, "serve_s": serve_s,
             "largest": mesh.stats.largest()}
        if run.paged and not run.server:
            r["pool"] = tp_pool_stats(e)
            if run.be == "codebook" and not (run.spec or run.moe
                                             or run.probes):
                out["gather"][name] = tp_gather_parity(e)
        if run in TP_TIMED:
            r.update(tp_step_ms(e, mesh))
        if run == TP_LUT:
            w = e.params["blocks"]["mlp"]["w2"]["w_idx"][0]
            r["acc"] = tp_lut_case(dev, e, w, x2.to(dev), mesh).cpu()
        if run == TP_CODEBOOK:
            out["parity"] = tp_parity(e, dev)
        out["runs"][name] = r
        if rank == 0:
            out["rec"][name] = rec
        del e                   # tp_record's closures hold it in a cycle
        gc.collect()
        torch.cuda.empty_cache()
    out["ep"] = tp_layer_rank(mesh, dev)
    return out


def tp3_layer(dev):
    """qwen3-moe-30b-a3b's MoE layer (d 2048, 128 experts of f 768, top
    8), seeded random f32 weights and a TP3_TOKENS input on the card:
    (MoEConfig, params, x)."""
    import torch
    from repro_torch import configs
    from repro_torch.models.moe import moe_init
    from repro_torch.models.transformer import moe_cfg
    cfg = moe_cfg(configs.get("qwen3-moe-30b-a3b"))
    g = torch.Generator(device=dev).manual_seed(11)
    p = moe_init(g, cfg, torch.float32, dev)
    x = torch.randn(TP3_TOKENS + (cfg.d_model,), generator=g, device=dev)
    return cfg, p, x


def tp_layer_rank(mesh, dev) -> dict:
    """``moe_apply`` over ``mesh`` on this rank's slices of ``tp3_layer``
    (EP where its 128 experts divide over the ranks, TP within expert
    otherwise) at act_levels 0 and ACT_LEVELS: each call's y, its
    ``ffn_act`` input and output on the host, and its launches."""
    import dataclasses
    import torch
    from repro_torch.distributed.sharding import local_slice
    from repro_torch.kernels import ops
    from repro_torch.models import moe as M
    cfg, p, x = tp3_layer(dev)
    specs = M.moe_param_specs(cfg, mesh.tp)
    loc = {k: local_slice(p[k], specs[k], mesh) for k in ("w1", "w3", "w2")}
    loc["router"] = p["router"]
    del p
    out = {"w1": list(loc["w1"].shape)}
    act, acts = M.ffn_act, []

    def site(v, kind, levels, mul=None):
        y = act(v, kind, levels, mul)
        acts.append((v.cpu(), y.cpu()))
        return y

    M.ffn_act = site
    try:
        for levels in (0, ACT_LEVELS):
            ops.reset_launch_counts()
            acts.clear()
            y = M.moe_apply(loc, x, dataclasses.replace(cfg, act_levels=levels),
                            mesh)
            torch.cuda.synchronize()
            out[levels] = {"y": y.cpu(), "acts": list(acts), "launches": {
                k: v for k, v in ops.launch_counts().items() if v}}
    finally:
        M.ffn_act = act
    return out


def tp3_rank(rank: int) -> dict:
    """One rank of the TP-within-expert spawn: ``tp_layer_rank`` over a
    (1, TP3_WORLD) mesh (f cut in three: 128 experts do not divide over 3
    ranks)."""
    import torch
    from repro_torch.launch.mesh import make_local_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return tp_layer_rank(make_local_mesh(1, TP3_WORLD), dev)


def tp_layer_check(cfg, p, x, levels: int, ranks: list, dim: int) -> dict:
    """The ranks' ``moe_apply`` y (``tp_layer_rank``) against the call
    without a mesh on the same card.  Each rank's hidden buffer is the
    slice of one device's along ``dim``: its experts (0, EP) or its part of
    f (-1, TP within expert).  At act_levels > 0 the activation site is
    locked, as ``paper_locked`` locks AlexNet's: each rank's input to
    ``ffn_act`` within TP3_LOCK_REL of the site's largest |x| of one
    device's, its levels equal but for flips at a boundary tie
    (``tie_flips``), counted; one device's call then goes on with the
    ranks' activations.  The ranks' y within TP3_TOL of the largest |y|,
    and equal.  Returns the figures."""
    import dataclasses
    import torch
    from repro_torch.core.activations import ActQuantConfig
    from repro_torch.models import moe as M
    from repro_torch.models.layers import _bounded
    mcfg = dataclasses.replace(cfg, act_levels=levels)
    regime = "EP" if dim == 0 else "TP within expert"
    act, full = M.ffn_act, []

    def record(v, kind, lv, mul=None):
        full.append(act(v, kind, lv, mul))
        full.append(v)
        return full[-2]

    res = {"flips": 0, "acts": 0, "input_share_of_bound": 0.0}
    M.ffn_act = record
    try:
        want = M.moe_apply(p, x, mcfg)
        if levels:
            yw, hw = full
            acfg = ActQuantConfig(_bounded(cfg.act_kind), levels)
            tol = TP3_LOCK_REL * max(1.0, hw.abs().max().item())
            n = hw.shape[dim] // len(ranks)
            got = []
            for r, rk in enumerate(ranks):
                (hp, yp), = rk[levels]["acts"]
                hp, yp = hp.to(x.device), yp.to(x.device)
                hs, ys = hw.narrow(dim, r * n, n), yw.narrow(dim, r * n, n)
                d = (hp - hs).abs().max().item()
                if not d <= tol:
                    raise AssertionError(f"[tp] moe_apply {regime}: rank {r}'s"
                                         f" activation input {d:.4g} off one "
                                         f"device's")
                res["input_share_of_bound"] = max(res["input_share_of_bound"],
                                                  d / tol)
                res["flips"] += tie_flips(hp, hs, yp, ys, acfg, tol,
                                          f"[tp] moe_apply {regime}")
                got.append(yp)
            res["acts"] = yw.numel()
            locked = torch.cat(got, dim=dim)
            M.ffn_act = lambda v, kind, lv, mul=None: locked
            want = M.moe_apply(p, x, mcfg)
    finally:
        M.ffn_act = act
    scale = float(want.abs().max())
    err = max(float((r[levels]["y"].to(x.device) - want).abs().max())
              for r in ranks)
    if err > TP3_TOL * scale:
        raise AssertionError(f"[tp] moe_apply {regime} at act_levels "
                             f"{levels}: {err:.4g} from the mesh-less call > "
                             f"{TP3_TOL} × {scale:.4g}")
    if any(not torch.equal(r[levels]["y"], ranks[0][levels]["y"])
           for r in ranks):
        raise AssertionError(f"[tp] the {regime} ranks differ")
    return {**res, "max_abs_err": err, "max_abs_y": scale}


def tp_bound(rec1: list, n_layers: int, bits: int = 7,
             sums: int = TP_SUMS) -> tuple[float, float]:
    """The tie bound of a run, fixed by tp=1's records alone: (bound,
    scale).  Against tp=1, tp=2 rounds ``sums`` sums a layer apart
    (``tp_sums``); each is taken to move a decision logit by at most one
    step at the logits' scale, 2^(⌊log2 max |logit|⌋ − bits) (bf16 keeps
    7 bits past the point, f32 23), so the runs' decision logits may
    differ by bound = sums · layers such steps, and a decision may flip
    only at a top-2 gap within 2 · bound."""
    import math
    scale = max(float(a.abs().amax(-1)[act].max()) for a, act in rec1
                if act.any())
    return sums * n_layers * 2.0 ** (math.floor(math.log2(scale))
                                     - bits), scale


def tp_sums(run) -> int:
    """The roundings a layer in which tp=2 may differ from tp=1
    (``tp_bound``).  TP_SUMS: the wo row psum, the w2 one, the join's
    denominator and partial output (the last in bf16 after q is rounded to
    the cache's dtype in a bf16 model).  The MoE runs' EP combine takes the
    place of the w2 psum: each token's top_k contributions are summed in
    one chain of top_k − 1 roundings at tp=1 and in another at tp=2 (each
    rank's own, then the psum), so 2 (top_k − 1) roundings may differ."""
    if not run.moe:
        return TP_SUMS
    from repro_torch import configs
    return TP_SUMS - 1 + 2 * (configs.get("qwen3-moe-30b-a3b").top_k - 1)


def tp_parting(rec1: list, rec2: list):
    """(δ, row): δ the largest |difference| of two runs' decision logits
    over the active rows of the records before the first record where a
    decision parts (all of them when none does), and that parting row of
    ``rec1`` (None: no decision parts)."""
    delta = 0.0
    for (a, act), (b, _) in zip(rec1, rec2):
        if a.shape != b.shape:
            break
        part = (a.argmax(-1) != b.argmax(-1)) & act
        if part.any():
            return delta, a[tuple(part.nonzero()[0].tolist())]
        if act.any():
            delta = max(delta, float((a - b).abs().amax(-1)[act].max()))
    return delta, None


def tp_agreement(name: str, one: dict, two: dict, checks: tuple,
                 n_layers: int, sums: int = TP_SUMS) -> dict:
    """tp=2's tokens and decision records (``two``) against tp=1's
    (``one``), by ``checks`` (``tp_checks``):

    'equal'   tokens equal tp=1's (lut in f32: integer products, and the
              join's f32 reorder far below the activation grid's step).
    'witness' tokens equal, and no decision parts from, ``one``'s witness:
              the mesh-less engine computing as the two ranks do, in one
              process (``tp_one_process``), so that where tp=2 parts from
              tp=1 the parting is the sums' order and rounding alone.
    'bound'   (dense and codebook at act_levels 0) δ, the largest
              difference of the decision logits before the first parting,
              within ``tp_bound``'s bound of ``sums`` roundings a layer
              (fixed from tp=1's logits before tp=2's are read), every
              parting's tp=1 top-2 gap within twice the bound, and tokens
              part only where a decision does.
    'f32bound' (the f32 MoE runs) the same with an f32 step.

    Without 'bound' a bf16 run may part from tp=1 at any gap: an
    activation snapped to a grid (lut's, act_levels 32's) moves by a grid
    step when a sum's rounding moves it across a boundary."""
    import torch
    f32 = "f32bound" in checks
    bound, scale = tp_bound(one["rec"], n_layers, 23 if f32 else 7, sums)
    delta, first = tp_parting(one["rec"], two["rec"])
    res = {"checks": checks, "equal": two["tokens"] == one["tokens"],
           "delta": delta, "bound": bound, "logit_scale": scale}
    if first is not None:
        top = torch.topk(first, 2).values
        res["gap"] = float(top[0] - top[1])
    if "equal" in checks and not res["equal"]:
        raise AssertionError(f"[tp] {name}: tp=2 tokens part from tp=1's "
                             f"(top-2 gap {res.get('gap')}, δ {delta:.4g})")
    if "witness" in checks:
        res["witness_delta"], wrow = tp_parting(one["split_rec"], two["rec"])
        res["witness_bitequal"] = len(one["split_rec"]) == len(two["rec"]) \
            and all(torch.equal(a, b) for (a, _), (b, _)
                    in zip(one["split_rec"], two["rec"]))
        if two["tokens"] != one["split_tokens"] or wrow is not None:
            raise AssertionError(f"[tp] {name}: tp=2 parts from the ranks' "
                                 f"sums computed in one process (δ "
                                 f"{res['witness_delta']:.4g} before)")
    if "bound" in checks or f32:
        if delta > bound:
            raise AssertionError(f"[tp] {name}: decision logits {delta:.4g} "
                                 f"from tp=1's before any parting > the "
                                 f"bound {bound:.4g}")
        if first is None and not res["equal"]:
            raise AssertionError(f"[tp] {name}: tokens part, no decision does")
        if first is not None and res["gap"] > 2 * bound:
            raise AssertionError(f"[tp] {name}: parted at a top-2 gap of "
                                 f"{res['gap']:.4g} > 2 · bound = "
                                 f"{2 * bound:.4g}")
    return res


@contextlib.contextmanager
def tp_one_process(dtype):
    """Within: the mesh-less engine of a ``dtype`` model computes as
    TP_WORLD = 2 ranks do, in this process (the witness of
    ``tp_agreement``).  Each block product
    runs on the two ranks' shards of its weights: 'col' the two column
    blocks side by side, 'row' the two K-blocks' products summed once
    (f32 on codebook, the int32 accumulators on lut, decoded after, x's
    dtype for the dense backend's plain matmul); the gated codebook launch
    on the two column blocks; the decode and verify attention over the
    cache cut into two S-slices (an int8 cache dequantized to ``dtype``,
    as a rank does), and the paged decode, verify and prefill chunk over
    the pages' two in-page halves (the gathered rows put rank-major, each
    half in a rank's order; int8 pages dequantized to f32, as a rank
    does), each slice's scores and partials by the
    port's ``_slice_scores`` and ``_slice_partials``, joined as gloo joins
    two ranks (the larger row max, one sum of the denominators, one of the
    partial outputs in their pay dtype), then ``_join_fresh``."""
    import torch
    from repro_torch.kernels import dispatch as D
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import layers
    assert TP_WORLD == 2          # gloo sums more ranks in a ring's order
    orig = (D.backend_matmul, layers._plain_matmul, ops.codebook_swiglu,
            A.decode_attention, A.chunk_attention, A.dequantize_kv,
            A._gather_paged_kv)
    box = {}

    def halves(t, dim):
        n = t.shape[dim] // 2
        return [t.narrow(dim, r * n, n).contiguous() for r in range(2)]

    def matmul(x, w_idx, book, backend, table=None, kind=None):
        if kind not in ("col", "row"):
            return orig[0](x, w_idx, book, backend, table=table, kind=kind)
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if kind == "col":
            y = torch.cat([D._local_matmul(x2, w, book, backend, table)
                           for w in halves(w_idx, 1)], -1)
        elif backend.name == "lut":
            a0, a1 = (D.lut_acc(xs, w, book, backend.lut_spec, table)
                      for xs, w in zip(halves(x2, 1), halves(w_idx, 0)))
            y = D._lut_decode(a0 + a1, backend.lut_spec)
        else:
            y0, y1 = (D._local_matmul(xs, w, book, backend)
                      for xs, w in zip(halves(x2, 1), halves(w_idx, 0)))
            y = y0 + y1
        return y.reshape(*x.shape[:-1], -1).to(x.dtype)

    def plain(x, w, backend, kind):
        if kind == "col":
            return torch.cat([x @ wb for wb in halves(w, 1)], -1)
        if kind == "row":
            y0, y1 = (xs @ wb for xs, wb in zip(halves(x, -1), halves(w, 0)))
            return y0 + y1
        return x @ w

    def swiglu(x, w1, b1, w3, b3, kind, levels):
        return torch.cat([orig[2](x, a, b1, c, b3, kind, levels) for a, c
                          in zip(halves(w1, 1), halves(w3, 1))], -1)

    def gather(k_pool, v_pool, page_table, layer, scales=None):
        box["paged"] = True
        try:
            k_l, v_l = orig[6](k_pool, v_pool, page_table, layer, scales)
        finally:
            box["paged"] = False
        page, S = k_pool.shape[2], k_l.shape[1]
        t = torch.arange(S, device=k_l.device).reshape(S // page, 2,
                                                       page // 2)
        box["gidx"] = t.transpose(0, 1).reshape(S)      # rank-major rows
        return k_l[:, box["gidx"]], v_l[:, box["gidx"]]

    def attend(q, k, v, vlen, excl, k_new, v_new):
        n = k.shape[1] // 2
        gidx = box.pop("gidx", None)
        if gidx is None:
            gidx = torch.arange(k.shape[1], device=q.device)
        vlen = torch.as_tensor(vlen, device=q.device).expand(q.shape[0])
        s = [A._slice_scores(q, kl, gidx[r * n:(r + 1) * n], vlen, excl)
             for r, kl in enumerate(halves(k, 1))]
        m = torch.clamp(torch.maximum(s[0].amax(-1), s[1].amax(-1)),
                        min=A.NEG_INF / 10)
        (d0, p0), (d1, p1) = (A._slice_partials(x, m, vl)
                              for x, vl in zip(s, halves(v, 1)))
        return A._join_fresh(q, k_new, v_new, (p0 + p1).to(torch.float32),
                             d0 + d1, m)

    D.backend_matmul, layers._plain_matmul, ops.codebook_swiglu = \
        matmul, plain, swiglu
    A.decode_attention = lambda q, k, v, kv_len, exclude=None, \
        extra_kv=None: attend(q, k, v, kv_len, exclude, *extra_kv)
    A.chunk_attention = lambda q, k, v, past_len, k_new, v_new: attend(
        q, k, v, past_len, None, k_new, v_new)
    # a rank dequantizes its int8 slice to the model's dtype, its int8
    # pages to f32
    A.dequantize_kv = lambda q, scale: (
        orig[5](q, scale) if box.get("paged") else orig[5](q, scale).to(dtype))
    A._gather_paged_kv = gather
    try:
        yield
    finally:
        (D.backend_matmul, layers._plain_matmul, ops.codebook_swiglu,
         A.decode_attention, A.chunk_attention, A.dequantize_kv,
         A._gather_paged_kv) = orig


def tp_server_agreement(name: str, run, one: dict, got: list) -> dict:
    """A server run's tp=2 (``got``: the ranks') against tp=1 (``one``):
    the host decisions (events, admission order, preemptions, pages
    swapped; the fleet's digest, replica and tier stats, migrations)
    equal tp=1's exactly, and preemptions happen (the fleet's drain
    migrates, its tier evicts); the streams equal the witness's (the
    ranks' sums in one process, bf16) or tp=1's (f32); a paged run's
    swap-outs each gathered the rank's slices in one page_gather
    (``tp_want``)."""
    dec, want = got[0]["decisions"], one["decisions"]
    for r in got:
        if r["decisions"] != want:
            raise AssertionError(f"[tp] {name}: host decisions "
                                 f"{r['decisions']} part from tp=1's {want}")
    if want["preemptions"] <= 0:
        raise AssertionError(f"[tp] {name}: no preemption {want}")
    if run.server == "fleet" and (want["migrated"][1] <= 0
                                  or want["tier"]["evictions"] <= 0):
        raise AssertionError(f"[tp] {name}: no migrated pages or no tier "
                             f"eviction {want}")
    if run.paged and any(r["swaps"] <= 0 for r in got):
        raise AssertionError(f"[tp] {name}: no swap-out gathered pages")
    ref = one["tokens"] if run.f32 else one["split_tokens"]
    if got[0]["tokens"] != ref:
        raise AssertionError(f"[tp] {name}: streams part from "
                             + ("tp=1's" if run.f32 else "the witness's"))
    equal = got[0]["tokens"] == one["tokens"]
    extra = ""
    if run.server == "fleet":
        extra = (f", digest {dec['digest'][:16]}, {dec['migrated'][0]} "
                 f"migrated ({dec['migrated'][1]} pages), tier {dec['tier']}")
    return {"checks": ("decisions", "f32" if run.f32 else "witness"),
            "equal": equal, "decisions": dec,
            "summary": f"host decisions equal to tp=1's ({dec['preemptions']}"
                       f" preemptions, {dec['pages_swapped_out']} pages "
                       f"swapped out, admission order "
                       f"{dec['admission_order']}{extra}); streams equal to "
                       + ("tp=1's" if run.f32 else
                          "the witness's (ranks' sums in one process), "
                          f"to tp=1's: {equal}")}


def tp_probe_draft_checks(name: str, run, one: dict, got: list) -> dict:
    """A probes run: its tokens equal the probes-off run's, its integer
    counters the tp=1 engine's, ``acc_max`` and ``headroom_bits`` within
    rel 1e-3, and its KV error 0 under the mesh (the int8 pages' > 0 at
    tp=1); a model-draft run: its spec counters equal tp=1's."""
    out = {}
    if run.probes:
        n1 = one["numerics"]
        if one["plain_tokens"] != one["tokens"]:
            raise AssertionError(f"[tp] {name}: probes changed tp=1's tokens")
        for r in got:
            n2 = r["numerics"]
            for k in ("tokens", "matmul_calls", "act_sat", "act_total",
                      "page_oob", "widx_neg", "widx_oob"):
                if n2[k] != n1[k]:
                    raise AssertionError(f"[tp] {name}: numerics {k} "
                                         f"{n2[k]} against tp=1's {n1[k]}")
            for k in ("acc_max", "headroom_bits"):
                for a, b in zip(n2[k], n1[k]):
                    if abs(a - b) > 1e-6 + 1e-3 * abs(b):
                        raise AssertionError(f"[tp] {name}: numerics {k} "
                                             f"{n2[k]} against {n1[k]}")
            if max(n2["kv_err_max"]) != 0.0:
                raise AssertionError(f"[tp] {name}: KV error under the mesh "
                                     f"{n2['kv_err_max']}")
        if run.int8 and max(n1["kv_err_max"]) <= 0.0:
            raise AssertionError(f"[tp] {name}: tp=1's int8 KV tap read 0")
        out["numerics"] = {k: got[0]["numerics"][k] for k in (
            "tokens", "matmul_calls", "act_sat", "act_total",
            "headroom_bits")}
        out["summary"] = (f"; probes: tokens equal the probes-off run's, "
                          f"counters equal tp=1's {out['numerics']}, KV "
                          f"error 0 (tp=1 {max(n1['kv_err_max']):.4g})")
    if run.draft:
        for r in got:
            if r["spec_stats"] != one["spec_stats"]:
                raise AssertionError(f"[tp] {name}: spec counters "
                                     f"{r['spec_stats']} against tp=1's "
                                     f"{one['spec_stats']}")
        out["spec_stats"] = one["spec_stats"]
        out["summary"] = (f"; model draft (lut, {TP_DRAFT_LEVELS} levels, "
                          f"whole on each rank): rounds/proposed/accepted/"
                          f"emitted {one['spec_stats']} equal to tp=1's")
    return out


def tp_checks(run) -> tuple:
    """What a [tp] run's tokens are held to (``tp_agreement``): the f32
    MoE runs the f32 bound (their EP psum adds each rank's top-k partial
    sums: ``tp_sums``); every other f32 run equal to tp=1 (lut: integer
    products; codebook: its row psum's f32 reorder moves the decision
    logits by about 6e-6 on an H100, past ``tp_bound``'s four roundings
    a layer, as the second K-half is summed in a chain of its own);
    every bf16 run the witness, and
    dense and codebook at act_levels 0 the bound as well.  A server run
    (``tp_server_agreement``): its host decisions equal tp=1's, its
    streams the witness's in bf16."""
    if run.server:
        return ("decisions",) + (() if run.f32 else ("witness",))
    if run.moe:
        return ("f32bound",)
    if run.f32:
        return ("equal",)
    return ("witness",) + (("bound",) if run.be != "lut" and not run.levels
                           else ())


def tp_ep_parity(h) -> float:
    """act_quant on the EP buffer ``h`` against its plain version, bit-equal
    but for counted ties; returns the largest |difference|."""
    from repro_torch.kernels import act_quant as aq
    kq = aq.act_quant_cuda(h, "relu6", ACT_LEVELS, form="act_apply")
    kp = aq.act_quant_plain(h, "relu6", ACT_LEVELS, form="act_apply")
    aq.parity_ties(*kq, *kp, "relu6", ACT_LEVELS)
    return (kq[0] - kp[0]).abs().max().item()


def tp_slice_times(dev, peaks: dict, h) -> list:
    """The kernels at this slice's new shapes: ``gather_pages_many`` on a
    rank's in-page slice of a qwen3-1.7b pool (TP_PAGE / TP_WORLD rows of
    8 kv heads of 128; bf16 K and V, and int8 K and V with their bf16
    scales, one launch) at the decode table (4 × 32 distinct pages), each
    call on the next of 28 layers' pools as ``gather_times`` does, against
    its bound and the library's ``pool[ids]`` a pool; and act_quant on the
    EP rank's expert buffer ``h`` (f32) against its bound and the
    library's ``fake_quantize_per_tensor_affine`` of the clipped input."""
    import torch
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import page_gather as pg
    g = torch.Generator(device=dev).manual_seed(8)
    n_l, rows, it = 28, [], [0]
    B, P = GATHER_TABLES[0]
    n_pages = 1 + B * P
    page_loc = TP_PAGE // TP_WORLD
    pt = (torch.randperm(n_pages - 1, generator=g, device=dev)[:B * P]
          + 1).reshape(B, P).to(torch.int32)
    ids = pt.long()

    def pool_of(shape, dt):
        return torch.randint(-128, 128, (n_l, n_pages) + shape, generator=g,
                             device=dev).to(getattr(torch, dt))

    def cyc(pools, f):
        def run():
            it[0] += 1
            return f(*(p[it[0] % n_l] for p in pools))
        return run

    kv = (page_loc, 8, 128)
    for what, pools in (
            ("bf16 K, V", [pool_of(kv, "bfloat16") for _ in range(2)]),
            ("int8 K, V + bf16 scales", [pool_of(kv, "int8")
                                         for _ in range(2)]
             + [pool_of(kv[:2], "bfloat16") for _ in range(2)])):
        page_bytes = sum(p[0, 0].numel() * p.element_size() for p in pools)
        nbytes = 2 * B * P * page_bytes + B * P * 4
        t = time_turns({
            "library": cyc(pools, lambda *ps: [p[ids] for p in ps]),
            "kernel": cyc(pools, lambda *ps: pg.page_gather_many_cuda(ps, pt)),
            "plain": cyc(pools, lambda *ps:
                         pg.page_gather_many_plain(ps, pt))}, reps=28)
        rows.append({"kernel": "page_gather", "site": f"rank slice {what}",
                     "shape": [B, P, page_loc, 8, 128], "ms": t["kernel"],
                     "plain_ms": t["plain"], "library_ms": t["library"],
                     "bound_ms": 1e3 * nbytes / peaks["bytes"],
                     "bound_by": "bytes"})
        del pools
    n = h.numel()
    # the path's form (no index): 4 B read and 4 B written an element; 8
    # operations an element
    b_bytes, b_ops = 8 * n / peaks["bytes"], 8 * n / peaks["f32"]
    rows.append({
        "kernel": "act_quant", "site": "EP expert buffer",
        "shape": list(h.shape),
        "ms": time_ms(lambda: aq.act_quant_cuda(h, "relu6", ACT_LEVELS,
                                                form="act_apply",
                                                with_index=False)),
        "plain_ms": time_ms(lambda: aq.act_quant_plain(
            h, "relu6", ACT_LEVELS, form="act_apply", with_index=False),
            reps=5),
        "library_ms": time_ms(lambda: torch.fake_quantize_per_tensor_affine(
            torch.clamp(h, 0, 6), 6 / (ACT_LEVELS - 1), 0, 0,
            ACT_LEVELS - 1)),
        "bound_ms": 1e3 * max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
    return rows


def tp_times(dev, peaks: dict) -> list:
    """Each kernel at one rank's shapes (M = 4, decode), beside its bound
    and its plain version's and library call's times."""
    import torch
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm
    g = torch.Generator(device=dev).manual_seed(6)
    M, rows = TP_REQS, []
    book = torch.randn(TP_BOOK, generator=g, device=dev) * 0.05
    tab = torch.randint(-(1 << 20), 1 << 20, (LEVELS, TP_BOOK), generator=g,
                        device=dev, dtype=torch.int32)

    def row(kernel, site, shape, ms, plain_ms, lib_ms, nbytes, ops_,
            peak):
        b_bytes, b_ops = nbytes / peaks["bytes"], ops_ / peaks[peak]
        rows.append({"kernel": kernel, "site": site, "shape": shape,
                     "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": 1e3 * max(b_bytes, b_ops),
                     "bound_by": "bytes" if b_bytes >= b_ops
                     else "operations"})

    for site, K, N in TP_SITES[:4] + TP_SITES[5:]:
        wi = torch.randint(-128, 128, (K, N), generator=g, device=dev,
                           dtype=torch.int8)
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        a = torch.randint(0, LEVELS, (M, K), generator=g, device=dev,
                          dtype=torch.int32)
        w_deq = book[wi.long() % TP_BOOK].to(torch.bfloat16)
        row("codebook_matmul", site, (M, K, N),
            time_ms(lambda: cm.codebook_matmul_cuda(x, wi, book)),
            time_ms(lambda: cm.codebook_matmul_plain(x, wi, book), reps=5),
            time_ms(lambda: torch.matmul(x, w_deq)),
            M * K * 2 + K * N + TP_BOOK * 4 + M * N * 4, 2 * M * K * N,
            "bf16")
        touched = torch.zeros(LEVELS * TP_BOOK, dtype=torch.bool, device=dev)
        addr = a[:, :, None] * TP_BOOK + (wi.to(torch.int32) % TP_BOOK)[None]
        touched[addr.reshape(-1).long()] = True
        row("lut_matmul", site, (M, K, N),
            time_ms(lambda: lm.lut_matmul_cuda(a, wi, tab)),
            time_ms(lambda: lm.lut_matmul_plain(a, wi, tab), reps=3),
            None, M * K * 4 + K * N + int(touched.sum()) * 4 + M * N * 4,
            2 * M * K * N, "int32")
    K, N = 2048, 3072
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w1, w3 = (torch.randint(-128, 128, (K, N), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    d1, d3 = (book[w.long() % TP_BOOK].to(torch.bfloat16) for w in (w1, w3))

    def lib_swiglu():
        h = torch.fake_quantize_per_tensor_affine(
            torch.clamp(torch.matmul(x, d1), 0, 6), 6 / (ACT_LEVELS - 1), 0,
            0, ACT_LEVELS - 1)
        return h * torch.matmul(x, d3)

    row("codebook_swiglu", "w1/w3", (M, K, N),
        time_ms(lambda: cm.codebook_swiglu_cuda(x, w1, book, w3, book,
                                                "relu6", ACT_LEVELS)),
        time_ms(lambda: cm.codebook_swiglu_plain(x, w1, book, w3, book,
                                                 "relu6", ACT_LEVELS), reps=5),
        time_ms(lib_swiglu), M * K * 2 + 2 * K * N + 2 * TP_BOOK * 4
        + M * N * 2, 4 * M * K * N, "bf16")
    h = torch.randn((M, N), generator=g, device=dev).to(torch.bfloat16)
    u = torch.randn((M, N), generator=g, device=dev).to(torch.bfloat16)
    # as act_quant_times: 2 B read and 2 B written an element, 2 B more
    # read for mul; 8 operations an element
    row("act_quant", "hidden", (M, N),
        time_ms(lambda: aq.act_quant_cuda(h, "relu6", ACT_LEVELS,
                                          form="act_apply", with_index=False,
                                          mul=u)),
        time_ms(lambda: aq.act_quant_plain(h, "relu6", ACT_LEVELS,
                                           form="act_apply", with_index=False,
                                           mul=u), reps=5),
        time_ms(lambda: torch.fake_quantize_per_tensor_affine(
            h, 6 / (ACT_LEVELS - 1), 0, 0, ACT_LEVELS - 1) * u),
        6 * M * N, 8 * M * N, "f32")
    return rows


def tp_path(dev, smi: str, peaks: dict) -> tuple[dict, dict]:
    """The [tp] phase: tensor-parallel serving on TP_WORLD ranks that share
    cuda:0 over gloo (a one-card machine: NCCL refuses two ranks on one
    card), against the mesh-less engine on the same card: qwen3-1.7b
    (full width, TP_LAYERS layers, |W| = TP_BOOK) on the contiguous cache
    and on the page pool (page TP_PAGE: 8 rows a rank; ``tp_chats``), and
    qwen3-moe-30b-a3b (TP_MOE_LAYERS layers, f32, codebook; EP, 64
    experts a rank) on both caches, then ``moe_apply`` alone at its layer
    shapes (EP); then ``moe_apply`` alone on TP3_WORLD ranks (TP within
    expert).
    Checks: (a) each run's tp=2 tokens held to tp=1's as ``tp_checks``
    and ``tp_agreement`` say (lut in f32 equal; every bf16 run equal to
    the ranks' sums computed in one process, dense and codebook at
    act_levels 0 also within ``tp_bound``; the MoE runs within the f32
    bound of ``tp_sums``); (b) the w2 row product's int32 accumulator
    summed over the ranks bit-equal to one device's; (c) the ranks'
    tokens equal; (d) each rank's kernels at its sharded shapes against
    their plain versions (``tp_parity``), ``gather_pages_many`` on its own
    pools (``tp_gather_parity``); (e) each rank's launches held exactly a
    forward and printed; (f) the paged runs' prefix-hit pages and
    copy-on-write copies equal to tp=1's, a rank's pool 1/TP_WORLD of
    tp=1's; (g) the ranks' qwen3-moe built from the seed equal to this
    process' (``tp_fingerprint``); (h) ``moe_apply`` EP on TP_WORLD
    ranks and TP within expert on TP3_WORLD within TP3_TOL of the
    mesh-less call's largest |y| at act_levels 0 and ACT_LEVELS (the
    activation site locked at ACT_LEVELS, ``tp_layer_check``), the ranks
    equal; act_quant on each EP rank's own expert buffer against plain.  Prints the eager decode step of tp=2 and tp=1 and the
    collectives' share: two ranks sharing one card over gloo, a
    correctness run's times and not the speed of a TP deployment (for
    TP_TIMED's runs); and the kernels at the new shapes against their
    bounds.  Returns (stats,
    launches summed over the ranks)."""
    import tempfile
    import torch
    from repro_torch.launch.mesh import FileFunction, run_ranks
    t_start = time.time()
    cfg, cp = tp_model(dev)
    vocab = cfg.vocab
    prompts = spec_prompts(prompts_for(TP_REQS, vocab), vocab)[:TP_REQS]
    chats = tp_chats(vocab)
    x2 = (torch.randn((TP_REQS, cfg.d_ff),
                      generator=torch.Generator().manual_seed(42)) * 2.0)
    one, stats = {}, {"runs": {}}
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory(prefix="tp_") as tmp:
        path = os.path.join(tmp, "cp.pt")
        torch.save(_to(cp, "cpu"), path)
        models, fingerprint = {False: (cfg, cp)}, None
        del cp
        for run in TP_RUNS:
            if run.moe and run.moe not in models:
                models.pop(False)
                rcp = None
                freed("[tp] qwen3-1.7b's mesh-less runs")
                models[True] = tp_moe_model(dev)
                fingerprint = tp_fingerprint(models[True][1])
            rcfg, rcp = models[run.moe]
            name = tp_name(run)
            reqs = chats if run.paged else prompts

            def mk(run=run, rcfg=rcfg, rcp=rcp):
                return tp_engine(rcfg, rcp, run, dev)

            e = None if run.server else mk()
            rec = []
            if e is not None:
                tp_record(e, rec)
            done = tp_serve(e, run, reqs, mk, vocab)
            e = done.pop("engine")
            one[name] = {**done, "rec": rec}
            if run.paged and not run.server:
                one[name]["pool"] = tp_pool_stats(e)
            if run in TP_TIMED:
                one[name].update(tp_step_ms(e))
            if run == TP_LUT:
                one["acc"] = tp_lut_case(
                    dev, e, rcp["blocks"]["mlp"]["w2"]["w_idx"][0],
                    x2.to(dev)).cpu()
            if run.probes:      # the same run with the probes off
                one[name]["plain_tokens"] = tp_engine(
                    rcfg, rcp, run._replace(probes=False), dev).serve(
                        reqs, max_new=TP_NEW)
            del e, done
            if "witness" in tp_checks(run):
                e, rec = (None, []) if run.server else (mk(), [])
                if e is not None:
                    tp_record(e, rec)
                with tp_one_process(torch.float32 if run.f32
                                    else torch.bfloat16):
                    one[name]["split_tokens"] = tp_serve(
                        e, run, reqs, mk, vocab)["tokens"]
                one[name]["split_rec"] = rec
                del e
        del models, rcp
        # the engines tp_record hooked sit in cycles with their params
        freed("[tp] the mesh-less runs, before the ranks")
        free, total = torch.cuda.mem_get_info()
        stats["device_used_before_ranks_gib"] = (total - free) / 2 ** 30
        t = time.time()
        ranks = run_ranks(FileFunction(me, "tp_rank"), TP_WORLD,
                          (path, cfg, prompts, chats, x2), tmp_dir=tmp)
        stats["ranks_s"] = time.time() - t
        t = time.time()
        ranks3 = run_ranks(FileFunction(me, "tp3_rank"), TP3_WORLD, (),
                           tmp_dir=tmp)
        stats["ranks3_s"] = time.time() - t
    for r in ranks:
        if r["moe_fingerprint"] != fingerprint:
            raise AssertionError("[tp] a rank's qwen3-moe built from the "
                                 "seed differs from this process'")
    launches: dict = {}
    for run in TP_RUNS:
        name = tp_name(run)
        got = [r["runs"][name] for r in ranks]
        if got[1]["tokens"] != got[0]["tokens"]:
            raise AssertionError(f"[tp] {name}: the ranks' tokens differ")
        if run.server:
            agree = tp_server_agreement(name, run, one[name], got)
        else:
            agree = tp_agreement(name, one[name], {
                "tokens": got[0]["tokens"], "rec": ranks[0]["rec"][name]},
                tp_checks(run), TP_MOE_LAYERS if run.moe else cfg.n_layers,
                tp_sums(run))
        agree.update(tp_probe_draft_checks(name, run, one[name], got))
        for r in got:
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        st = {"largest_payload_bytes": got[0]["largest"],
              "serve_s": got[0]["serve_s"], "forwards": got[0]["forwards"],
              "launches_by_rank": [r["launches"] for r in got], **agree}
        step = ""
        if run in TP_TIMED:
            st.update(tp1_step_ms=one[name]["step_ms"],
                      tp2_step_ms=got[0]["step_ms"],
                      tp2_timed_step_ms=got[0]["timed_step_ms"],
                      collective_ms=got[0]["collective_ms"],
                      collective_share=got[0]["collective_share"],
                      calls_a_step=got[0]["calls"],
                      step_largest_payload_bytes=got[0]["step_largest"])
            step = (f"; eager decode step tp=2 {st['tp2_step_ms']:.2f} ms, "
                    f"tp=1 {st['tp1_step_ms']:.2f} ms; collectives "
                    f"{st['collective_ms']:.2f} of "
                    f"{st['tp2_timed_step_ms']:.2f} ms timed "
                    f"({100 * st['collective_share']:.1f} %), calls a step "
                    f"{st['calls_a_step']}, largest payload a step "
                    f"{st['step_largest_payload_bytes']} B")
        pool = ""
        if run.paged and not run.server:
            p1 = one[name]["pool"]
            for r in got:
                p2 = r["pool"]
                if (p2["hit_pages"], p2["cow_copies"]) != (
                        p1["hit_pages"], p1["cow_copies"]):
                    raise AssertionError(f"[tp] {name}: prefix hits and CoW "
                                         f"{p2} against tp=1's {p1}")
                if p2["pool_bytes"] * TP_WORLD != p1["pool_bytes"] or \
                        p2["pool_shape"][2] * TP_WORLD != p1["pool_shape"][2]:
                    raise AssertionError(f"[tp] {name}: a rank's pool {p2} "
                                         f"is not 1/{TP_WORLD} of {p1}")
            if p1["hit_pages"] <= 0 or (p1["cow_copies"] <= 0
                                        and not run.spec):
                raise AssertionError(f"[tp] {name}: no prefix hit or CoW "
                                     f"{p1}")
            st["pool"], st["rank_pool"] = p1, got[0]["pool"]
            pool = (f"; prefix-hit pages {p1['hit_pages']} and CoW "
                    f"{p1['cow_copies']} equal to tp=1's, a rank's pool "
                    f"{tuple(got[0]['pool']['pool_shape'])} "
                    f"{got[0]['pool']['pool_bytes']} B of tp=1's "
                    f"{p1['pool_bytes']} B")
        stats["runs"][name] = st
        if run.server:
            log(f"[tp] {smi}: {name}: {agree['summary']}; ranks equal{step}; "
                f"launches rank 0 {st['launches_by_rank'][0]}, rank 1 "
                f"{st['launches_by_rank'][1]} over {st['forwards']} forwards "
                f"and {got[0]['swaps']} swap-outs each")
            continue
        log(f"[tp] {smi}: {name}: tokens "
            + ("equal to tp=1" if agree["equal"] else
               f"part from tp=1 at a top-2 gap of "
               f"{agree.get('gap', float('nan')):.4g}")
            + f" (decision logits within {agree['delta']:.4g} of tp=1's "
            f"before any parting; max |logit| {agree['logit_scale']:.4g}, "
            f"bound {agree['bound']:.4g}; held {'/'.join(agree['checks'])}"
            + (f"; equal to the ranks' sums in one process, decision "
               f"logits within {agree['witness_delta']:.4g} (bit-equal "
               f"{agree['witness_bitequal']})" if "witness" in agree["checks"]
               else "")
            + f"){agree.get('summary', '')}, ranks equal{pool}{step}; "
            f"largest payload of a serve "
            f"(prefills included) {st['largest_payload_bytes']} B; launches "
            f"rank 0 "
            f"{st['launches_by_rank'][0]}, rank 1 {st['launches_by_rank'][1]}"
            f" over {st['forwards']} forwards each")
    for r in ranks:
        acc = r["runs"][tp_name(TP_LUT)]["acc"]
        if not torch.equal(acc, one["acc"]):
            raise AssertionError("[tp] the w2 int32 accumulator summed over "
                                 "the ranks differs from one device's")
    stats["parity"] = [r["parity"] for r in ranks]
    stats["gather"] = [r["gather"] for r in ranks]
    log(f"[tp] w2 row psum: int32 accumulators {tuple(one['acc'].shape)} "
        f"bit-equal to one device's on both ranks; kernels at the sharded "
        f"shapes against plain, largest |difference| by rank "
        f"{stats['parity']}; gather_pages_many on each rank's own pools "
        f"bit-exact: {stats['gather'][0]}")
    log(f"[tp] qwen3-moe-30b-a3b built from the seed in each rank equal to "
        f"this process' ({len(fingerprint)} leaves' sums), one rank at a "
        f"time, in "
        + ", ".join(f"{r['moe_build_s']:.1f}" for r in ranks)
        + " s, peak allocated "
        + ", ".join(f"{r['moe_build_peak_gib']:.2f}" for r in ranks)
        + f" GiB; "
        f"device memory in use before the ranks "
        f"{stats['device_used_before_ranks_gib']:.2f} GiB")
    mcfg, p3, x3 = tp3_layer(dev)
    ranks_ep = [r["ep"] for r in ranks]
    for key, rks, dim in (("ep", ranks_ep, 0), ("tp3", ranks3, -1)):
        stats[key] = {"w1_rank": rks[0]["w1"]}
        for levels in (0, ACT_LEVELS):
            stats[key][levels] = tp_layer_check(mcfg, p3, x3, levels, rks,
                                                dim)
            want_l = {"act_quant": 1} if levels else {}
            for r in rks:
                if r[levels]["launches"] != want_l:
                    raise AssertionError(f"[tp] moe_apply ({key}) launches "
                                         f"{r[levels]['launches']}, want "
                                         f"{want_l}")
                for k, v in r[levels]["launches"].items():
                    launches[k] = launches.get(k, 0) + v
    # act_quant on each EP rank's own expert buffer, its ffn_act input
    hs = [r[ACT_LEVELS]["acts"][0][0].to(dev) for r in ranks_ep]
    stats["ep_act_quant_err"] = max(tp_ep_parity(h) for h in hs)
    h = hs[0]
    for key, world, what in (("ep", TP_WORLD, "EP"),
                             ("tp3", TP3_WORLD, "TP within expert")):
        st = stats[key]
        log(f"[tp] {smi}: moe_apply on {world} ranks, {what} (w1 "
            f"{tuple(st['w1_rank'])} a rank), {TP3_TOKENS} tokens, f32: "
            + ", ".join(f"act_levels {lv} within {st[lv]['max_abs_err']:.4g}"
                        f" of the mesh-less call (max |y| "
                        f"{st[lv]['max_abs_y']:.4g})"
                        for lv in (0, ACT_LEVELS))
            + f" with the activation site locked: {st[ACT_LEVELS]['flips']} "
            f"of {st[ACT_LEVELS]['acts']} levels flipped at a boundary tie, "
            f"inputs within {st[ACT_LEVELS]['input_share_of_bound']:.3g} of "
            f"the {TP3_LOCK_REL} bound, ranks equal")
    log(f"[tp] {smi}: {TP3_WORLD} ranks {stats['ranks3_s']:.1f}s; act_quant "
        f"on each EP rank's own expert buffer {tuple(h.shape)} (its ffn_act "
        f"input at act_levels {ACT_LEVELS}) against plain, largest "
        f"|difference| {stats['ep_act_quant_err']:.4g}")
    stats["times"] = tp_times(dev, peaks) + tp_slice_times(dev, peaks, h)
    del p3, x3, h, hs
    for r in stats["times"]:
        log(f"[tp] {smi}: {r['kernel']} {r['site']} {r['shape']}: "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} {r['bound_by']}, "
            f"plain {r['plain_ms']:.4f}"
            + (f", library {r['library_ms']:.4f}" if r["library_ms"]
               is not None else "") + ")")
    stats["phase_s"] = time.time() - t_start
    log(f"[tp] {smi}: phase {stats['phase_s']:.1f}s (ranks "
        f"{stats['ranks_s']:.1f}s, {TP3_WORLD} ranks "
        f"{stats['ranks3_s']:.1f}s); launches {launches}")
    torch.cuda.empty_cache()
    return stats, launches


def unfused_step(dev, e, L) -> dict:
    """The working-point codebook decode step (4 slots at 40) with the
    gated launch, and with the FFN as the port ran it before that launch
    (two codebook_matmul, their casts, act_quant, a separate product: the
    formula swapped into ``layers.swiglu`` for this measurement only), in
    turns (unfused, gated, gated, unfused), on the eager route (the
    forward alone, ``_decode``) and as a graph replay (one captured loop
    state a formula, captured with its formula in place): wall ms (median
    of 5 steps a turn), device busy ms and kernels of a step."""
    import numpy as np
    import torch
    gated = L.swiglu

    def unfused(p, x, kind, levels, backend):
        h = (L.ffn_act(L.dense(p["w1"], x, backend), kind, levels)
             * L.dense(p["w3"], x, backend))
        return L.dense(p["w2"], h, backend)
    cache = e.model.init_cache(4, 128, dtype=torch.bfloat16, device=dev)
    cache["pos"][:] = 40
    last = np.zeros(4, np.int64)
    states = {name: step_state(e, 40) for name in ("gated", "unfused")}
    saved = {name: {k: t.clone() for k, t in st.state().items()}
             for name, st in states.items()}
    res = {name: {"wall_ms": [], "graph_wall_ms": []}
           for name in ("gated", "unfused")}
    e._graphs = True
    try:
        for name in ("unfused", "gated", "gated", "unfused"):
            L.swiglu = unfused if name == "unfused" else gated
            st = states[name]

            def replay():
                for k, t in st.state().items():
                    t.copy_(saved[name][k])
                e._step(st)                  # the first one captures
            dec = [timed(lambda: e._decode(last, cache))[1]
                   for _ in range(6)][1:]
            res[name]["wall_ms"].append(1e3 * sorted(dec)[len(dec) // 2])
            replay()
            dec = [timed(replay)[1] for _ in range(6)][1:]
            res[name]["graph_wall_ms"].append(1e3 * sorted(dec)[len(dec) // 2])
            if "device_ms" not in res[name]:
                busy, _, _, n_k, _ = device_time(
                    lambda: e._decode(last, cache))
                g_busy, _, _, g_k, _ = device_time(replay)
                res[name].update(device_ms=busy, kernels=n_k,
                                 graph_device_ms=g_busy, graph_kernels=g_k)
    finally:
        L.swiglu = gated
    log("[point] codebook decode step, gated launch against the unfused "
        "chain, in turns (unfused, gated, gated, unfused): " + "; ".join(
            f"{k} eager wall {', '.join(f'{w:.2f}' for w in r['wall_ms'])} "
            f"ms, device busy {r['device_ms']:.3f} ms, {r['kernels']} "
            f"kernels; replayed wall "
            f"{', '.join(f'{w:.2f}' for w in r['graph_wall_ms'])} ms, device "
            f"busy {r['graph_device_ms']:.3f} ms, {r['graph_kernels']} "
            "kernels" for k, r in res.items()))
    return res


def act_quant_times(dev, peaks: dict) -> list:
    """act_quant per call at the FFN's decode (4 × 6144) and prefill
    (32 × 6144) bf16 shapes, relu6 at |A| = 32, output only (as the
    serving site calls it): both forms, and the act_apply form with its
    multiplier (``mul``: the up product, as the dense and lut FFNs launch
    it): kernel, plain, the bound, and the library call.  At relu6 with
    lo = 0 one PyTorch call computes the kernel form's arithmetic:
    ``fake_quantize_per_tensor_affine(x, step, 0, 0, L − 1)`` =
    clamp(rint(x·(1/step)), 0, L − 1)·step (clamping before or after the
    rounding is the same for relu6); times ``mul`` for the row with the
    multiplier.  The act_apply form rounds to bf16 after every operation,
    which that call does not; it stands as the yardstick of every row, and
    the elements where it differs from each are counted."""
    import torch
    from repro_torch.kernels import act_quant as aq
    g = torch.Generator(device=dev).manual_seed(6)
    step = 6.0 / (ACT_LEVELS - 1)
    res = []
    for M in (MAX_BATCH, 32):
        x = (torch.randn(M, D_FF, generator=g, device=dev) * 3).to(
            torch.bfloat16)
        u = torch.randn(M, D_FF, generator=g, device=dev).to(torch.bfloat16)
        n = x.numel()
        b_ops = 8 * n / peaks["f32"]
        for form, mul in (("kernel", None), ("act_apply", None),
                          ("act_apply", u)):
            def lib(mul=mul):
                y = torch.fake_quantize_per_tensor_affine(
                    x, step, 0, 0, ACT_LEVELS - 1)
                return y if mul is None else y * mul
            # 2 B read, 2 B written an element; 2 B more read for mul
            b_bytes = (4 if mul is None else 6) * n / peaks["bytes"]
            y = aq.act_quant_cuda(x, "relu6", ACT_LEVELS, form=form,
                                  with_index=False, mul=mul)[0]
            res.append({
                "M": M, "N": D_FF, "dtype": "bfloat16", "kind": "relu6",
                "levels": ACT_LEVELS, "form": form, "mul": mul is not None,
                "ms": time_ms(lambda: aq.act_quant_cuda(
                    x, "relu6", ACT_LEVELS, form=form, with_index=False,
                    mul=mul), reps=56),
                "plain_ms": time_ms(lambda: aq.act_quant_plain(
                    x, "relu6", ACT_LEVELS, form=form, with_index=False,
                    mul=mul), reps=20),
                "library_ms": time_ms(lib, reps=56),
                "library_call": "torch.fake_quantize_per_tensor_affine (the "
                                "kernel form's arithmetic)"
                                + ("" if mul is None else ", *"),
                "library_differs": int((lib() != y).sum()),
                "bound_ms": 1e3 * max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
    for r in res:
        log(f"[time] act_quant {r['M']}×{r['N']} bf16 relu6 |A|={r['levels']}"
            f" {r['form']} form{' with mul' if r['mul'] else ''}: "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.5f} {r['bound_by']}, "
            f"plain {r['plain_ms']:.4f}, library {r['library_call']} "
            f"{r['library_ms']:.4f}, which differs from this form in "
            f"{r['library_differs']}/{r['M'] * r['N']} elements)")
    return res


def swiglu_times(dev, peaks: dict) -> list:
    """The gated launch per call at M in TIMED_ROWS × the w1/w3 site
    (2048 × 6144, int16 ids, bf16 x, relu6 at |A| = 32), timed in turns
    (``time_turns``) beside: its two products alone (two codebook_matmul
    launches: the target), the unfused chain the codebook FFN ran before
    it (two codebook_matmul, two casts, act_quant, the product), and the
    library yardstick: two ``torch.matmul`` on weights dequantized to bf16
    beforehand, ``torch.fake_quantize_per_tensor_affine`` (the kernel
    form's arithmetic, as act_quant's yardstick) and the product.  The
    plain version (``codebook_swiglu_plain``) is timed alone.  Four operand
    sets are cycled, so the 2 × 25 MB of ids of a set do not sit in the
    50 MB L2 from the previous call.  Bound: the ids, x, the codebooks and
    h moved once, or 2 × 2MKN bf16 operations, the larger."""
    import torch
    from repro_torch.kernels import act_quant as aq
    from repro_torch.kernels import codebook_matmul as cm
    g = torch.Generator(device=dev).manual_seed(9)
    K, N = SITES["w1"]
    bf16 = torch.bfloat16
    step = 6.0 / (ACT_LEVELS - 1)
    res = []
    for M in TIMED_ROWS:
        sets = []
        for _ in range(4):
            x = torch.randn(M, K, generator=g, device=dev).to(bf16)
            w1, w3 = (torch.randint(0, N_BOOK, (K, N), generator=g,
                                    device=dev).to(torch.int16)
                      for _ in range(2))
            b1, b3 = (torch.randn(N_BOOK, generator=g, device=dev) * 0.05
                      for _ in range(2))
            sets.append((x, w1, b1, w3, b3, b1[w1.long()].to(bf16),
                         b3[w3.long()].to(bf16)))
        it = [0]

        def cyc(f):
            def run():
                t = sets[it[0] % 4]
                it[0] += 1
                return f(t)
            return run

        def unfused(t):
            gg = cm.codebook_matmul_cuda(t[0], t[1], t[2]).to(bf16)
            uu = cm.codebook_matmul_cuda(t[0], t[3], t[4]).to(bf16)
            return aq.act_quant_cuda(gg, "relu6", ACT_LEVELS,
                                     form="act_apply",
                                     with_index=False)[0] * uu

        def library(t):
            return torch.fake_quantize_per_tensor_affine(
                t[0] @ t[5], step, 0, 0, ACT_LEVELS - 1) * (t[0] @ t[6])
        t = time_turns({
            "kernel": cyc(lambda t: cm.codebook_swiglu_cuda(
                *t[:5], "relu6", ACT_LEVELS)),
            "matmuls": cyc(lambda t: (cm.codebook_matmul_cuda(*t[:3]),
                                      cm.codebook_matmul_cuda(t[0], *t[3:5]))),
            "unfused": cyc(unfused),
            "library": cyc(library)}, reps=20)
        nbytes = M * K * 2 + 2 * K * N * 2 + 2 * N_BOOK * 4 + M * N * 2
        b_bytes = nbytes / peaks["bytes"]
        b_ops = 2 * 2 * M * K * N / peaks["bf16"]
        res.append({
            "M": M, "K": K, "N": N, "site": "w1+w3", "ids": "int16",
            "x": "bfloat16", "kind": "relu6", "levels": ACT_LEVELS,
            "route": cm.plan_for(sets[0][0], sets[0][1]).route,
            "ms": t["kernel"], "two_matmuls_ms": t["matmuls"],
            "unfused_chain_ms": t["unfused"],
            "plain_ms": time_ms(cyc(lambda t: cm.codebook_swiglu_plain(
                *t[:5], "relu6", ACT_LEVELS)), reps=3, warm=1),
            "library_ms": t["library"],
            "library_call": "2 × torch.matmul on bf16 weights dequantized "
                            "beforehand, torch.fake_quantize_per_tensor_"
                            "affine, *",
            "bound_ms": 1e3 * max(b_bytes, b_ops),
            "bound_by": "bytes" if b_bytes >= b_ops else "operations"})
        del sets
    for r in res:
        log(f"[time] codebook_swiglu M={r['M']} (w1+w3 {K}×{N}, int16, bf16 "
            f"x, relu6 |A|={ACT_LEVELS}, {r['route']} route): "
            f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} {r['bound_by']}; "
            f"two codebook_matmul {r['two_matmuls_ms']:.4f}; unfused chain "
            f"{r['unfused_chain_ms']:.4f}; library {r['library_ms']:.4f}; "
            f"plain {r['plain_ms']:.3f})")
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
    rows = path_rows(prompts + spec_prompts(prompts, vocab), chats,
                     MAX_BATCH)
    worst, shares = parity(dev, sorted(set(rows) | {17}))
    worst["page_gather"] = gather_parity(dev)
    worst["act_quant"], _ = act_quant_parity(dev, rows)
    worst["codebook_swiglu"], sw_counts = swiglu_parity(
        dev, sorted(set(rows) | {17}))
    worst["kmeans_assign"] = kmeans_parity(dev)
    reduced_against_cpu(dev)
    reduced_kv_quant(dev)
    reduced_working_point(dev)
    cfg = configs.get("qwen3-1.7b")
    model, cp = compressed_model(dev, cfg, "[main]")
    stats, launches = main_path(dev, cfg, model, cp, prompts)
    p_stats, p_launches = paged_path(dev, cfg, model, cp, chats)
    s_stats, s_launches = spec_path(dev, cfg, model, cp, prompts, stats)
    ps_stats, ps_launches = paged_spec_path(dev, cfg, model, cp, chats,
                                            s_stats, p_stats)
    sc_stats, sc_launches = sched_path(dev, cfg, model, cp)
    f_stats, f_launches = fleet_path(dev, cfg, model, cp)
    pr_stats, pr_launches = probes_path(dev, cfg, model, cp, prompts)
    t = time.time()
    l_rows = launch_reference(dev, cfg, model, cp)
    t_ref = time.time() - t
    del model, cp
    torch.cuda.empty_cache()
    l_stats, l_launches = launch_path(cfg, l_rows)
    l_stats["reference_s"] = t_ref
    torch.cuda.empty_cache()
    w_stats, w_launches, km_row = working_point(dev, prompts, chats, stats,
                                                peaks)
    torch.cuda.empty_cache()
    q_stats, q_launches, qs_launches = kv_quant_path(dev)
    torch.cuda.empty_cache()
    m_stats, m_launches = moe_path(dev, smi)
    torch.cuda.empty_cache()
    r_stats, r_launches = recurrent_path(dev, smi)
    torch.cuda.empty_cache()
    fa_stats, fa_launches = families_path(dev, smi, peaks)
    torch.cuda.empty_cache()
    pa_stats, pa_launches = paper_path(dev, smi, peaks)
    torch.cuda.empty_cache()
    tr_stats, tr_launches = train_path(dev, smi)
    torch.cuda.empty_cache()
    tf_stats, tf_launches = train_families_path(dev, smi)
    torch.cuda.empty_cache()
    ex_stats, ex_launches = examples_path(dev, smi)
    torch.cuda.empty_cache()
    tp_stats, tp_launches = tp_path(dev, smi, peaks)
    s_stats["kvq_ngram"] = q_stats.pop("spec")
    for k, v in qs_launches.items():
        s_launches[k] = s_launches.get(k, 0) + v
    torch.cuda.empty_cache()
    times = kernel_times(dev, peaks, shares)
    g_times, g_many = gather_times(dev, peaks)
    a_times = act_quant_times(dev, peaks)
    s_times = swiglu_times(dev, peaks)

    by_path = {k: {"contiguous": launches.get(k, 0),
                   "paged": p_launches.get(k, 0),
                   "working_point": w_launches.get(k, 0),
                   "kv_quant": q_launches.get(k, 0),
                   "spec": s_launches.get(k, 0),
                   "paged_spec": ps_launches.get(k, 0),
                   "sched": sc_launches.get(k, 0),
                   "fleet": f_launches.get(k, 0),
                   "probes": pr_launches.get(k, 0),
                   "launch": l_launches.get(k, 0),
                   "moe": m_launches.get(k, 0),
                   "recurrent": r_launches.get(k, 0),
                   "families": fa_launches.get(k, 0),
                   "paper": pa_launches.get(k, 0),
                   "train": tr_launches.get(k, 0),
                   "train_families": tf_launches.get(k, 0),
                   "examples": ex_launches.get(k, 0),
                   "tp": tp_launches.get(k, 0)}
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
            # the form the paths launch: act_apply with its multiplier
            head = next(r for r in a_times if r["M"] == MAX_BATCH
                        and r["form"] == "act_apply" and r["mul"])
            shape = {k_: head[k_] for k_ in ("M", "N", "dtype", "kind",
                                             "levels", "form", "mul")}
            shapes = a_times
        elif kname == "codebook_swiglu":
            head = next(r for r in s_times if r["M"] == MAX_BATCH)
            shape = {k_: head[k_] for k_ in ("M", "K", "N", "ids", "x",
                                             "kind", "levels", "route")}
            shapes = s_times
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
            "source": SOURCES.get(kname, f"src/repro_torch/csrc/{kname}.cu"),
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
    log("[done] kv_quant path " + json.dumps(q_stats))
    log("[done] spec path " + json.dumps(s_stats))
    log("[done] paged spec path " + json.dumps(ps_stats))
    log("[done] sched path " + json.dumps(sc_stats))
    log("[done] fleet path " + json.dumps(f_stats))
    log("[done] probes path " + json.dumps(pr_stats))
    log("[done] launch path " + json.dumps(l_stats))
    log("[done] moe path " + json.dumps(m_stats))
    log("[done] recurrent path " + json.dumps(r_stats))
    log("[done] families path " + json.dumps(fa_stats))
    log("[done] paper path " + json.dumps(pa_stats))
    log("[done] train path " + json.dumps(tr_stats))
    log("[done] train_families path " + json.dumps(tf_stats))
    log("[done] examples path " + json.dumps(ex_stats))
    log("[done] tp path " + json.dumps(tp_stats))
    log("[done] codebook_swiglu parity " + json.dumps(sw_counts))
    print(smi)
    line = json.dumps({"kernels": kernels})
    print(line)
    if os.environ.get("CHIP_SMOKE_LOG"):   # the tail of stdout may cut it
        with open(os.environ["CHIP_SMOKE_LOG"], "a") as f:
            print(line, file=f)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
