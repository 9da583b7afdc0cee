"""Serve a codebook-compressed LM through all three matmul backends, on
the PyTorch/CUDA port (``repro_torch``): the same run as
``serve_quantized_lm.py``, with the kernels written for the H100.

The same compressed params are served three ways:
    dense     gather the codebook, then a dense matmul  (baseline numerics)
    codebook  the codebook_matmul kernel                (deployment path)
    lut       the lut_matmul integer engine             (faithful §4: no
              multiplications in the contraction)

each with the numerics probes on: a per-backend saturation / accumulator-
headroom / KV-error table prints after the three runs.  Then once more
through the paged KV cache (page_gather), the requests sharing one
system prompt, whose full pages are computed and stored once; then
speculative decoding, a lut(512)-tier draft of the same params proposing
k tokens a round for the codebook-tier target.

    PYTHONPATH=src python examples/serve_quantized_lm_torch.py [--arch NAME]
        [--page-size N] [--kv-dtype {bf16,int8}] [--no-prefix-cache]
        [--spec-k N] [--device {cuda,cpu}]

Without ``--device`` it runs on the GPU and fails without one.
"""

import argparse
import time

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.core.export import memory_report
from repro_torch.core.quantizer import (cluster_params, codebook_indices,
                                        init_state)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.model_zoo import build
from repro_torch.serving import (ServeEngine, SpecConfig, Telemetry,
                                 to_codebook_params)

BACKENDS = ("dense", "codebook", "lut")


def init_params(model, device):
    """The example's weights: ``model.init`` from a generator on
    ``device`` seeded with 0."""
    return model.init(torch.Generator(device=device).manual_seed(0), device)


def _launched(before: dict) -> dict:
    return {k: v - before[k] for k, v in ops.launch_counts().items()
            if v != before[k]}


def compressed_model(arch="llama3.2-3b", device=None):
    """The reduced ``arch`` in f32 with its int8 contiguous cache, clustered
    to the working point's |W| (laplacian_l1), its memory row printed;
    returns (cfg, model, index-form params)."""
    dev = resolve_device(device)
    cfg = configs.get(arch).reduced().replace(kv_quant=True,
                                              dtype="float32")
    model = build(cfg)
    params = init_params(model, dev)
    wq = cfg.quantized().wq
    params, qstate = cluster_params(params, wq, init_state(wq), wq.interval,
                                    torch.Generator(device=dev).manual_seed(1))
    idx_tree, _ = codebook_indices(params, wq, qstate)
    print("[weights]", memory_report(idx_tree, wq.num_weights, 32).row())
    return cfg, model, to_codebook_params(params, wq, qstate, min_size=1024)


def serve_backends(model, cparams, prompts, max_new=24, lut_max_new=8,
                   device=None) -> tuple[dict, dict]:
    """Each backend with probes on: a warm generate, then a timed one.
    Returns ({backend: numerics()}, {backend: kernel launches})."""
    probe_rows, launches = {}, {}
    for backend in BACKENDS:
        n_new = lut_max_new if backend == "lut" else max_new
        before = ops.launch_counts()
        engine = ServeEngine(model, cparams, max_len=64, backend=backend,
                             max_batch=len(prompts), probes=True,
                             device=device)
        engine.generate(prompts, max_new=n_new)
        engine.reset_probes()
        t0 = time.time()
        outs = engine.generate(prompts, max_new=n_new)
        dt = time.time() - t0
        n = len(prompts) * n_new
        print(f"[{backend:>8}] {n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s, "
              f"int8 KV cache, codebook weights)")
        print(f"           continuation: {outs[0][8:]}")
        probe_rows[backend] = engine.numerics()
        launches[backend] = _launched(before)
    return probe_rows, launches


def numerics_table(probe_rows: dict) -> None:
    """The probes of the timed runs: each backend's worst layer."""
    print("[numerics] per-backend discretization health (worst layer):")
    print(f"           {'backend':<9} {'sat rate':>9} {'acc headroom':>13} "
          f"{'kv err max':>11} {'widx oob':>9}")
    for be, num in probe_rows.items():
        sat = max(num["sat_rate"] or [0.0])
        hr = min(num["headroom_bits"] or [31.0])
        kv = max(num["kv_err_max"] or [0.0])
        print(f"           {be:<9} {100 * sat:>8.2f}% {hr:>8.1f} bits "
              f"{kv:>11.4f} {num['widx_oob']:>9}")


def serve_paged(cfg, cparams, rng, tel, requests=4, max_new=24,
                page_size=16, kv_dtype="int8", prefix_cache=True,
                device=None) -> ServeEngine:
    """``requests`` prompts sharing a 4-page system prompt through the
    paged cache (codebook weights, dense backend); returns the engine."""
    plain = build(cfg.replace(kv_quant=False))  # pages carry the quantization
    system = [int(t) for t in rng.integers(0, cfg.vocab, 4 * page_size)]
    shared = [system + [int(t) for t in rng.integers(0, cfg.vocab, 4)]
              for _ in range(requests)]
    engine = ServeEngine(plain, cparams,
                         max_len=len(shared[0]) + max_new // 2 + 8,
                         max_batch=requests, paged=True,
                         page_size=page_size, kv_dtype=kv_dtype,
                         prefix_cache=prefix_cache, device=device)
    tel.attach_engine(engine)
    outs = engine.serve(shared, max_new=max_new // 2)
    st = engine.pool.stats
    print(f"[   paged] shared system prompt ({len(system)} tokens × "
          f"{requests} requests): peak cache "
          f"{engine.pool.bytes_per_page() * st.peak_pages_in_use / 1e6:.3f}MB"
          f" vs {engine.dense_cache_bytes() / 1e6:.3f}MB dense slab "
          f"({kv_dtype} pages, {page_size} tokens/page)")
    print(f"           continuation: {outs[0][len(shared[0]):]}")
    return engine


def serve_spec(model, cparams, prompts, tel, k=3, max_new=24,
               device=None) -> bool:
    """The codebook target alone, then with the lut(512) draft: whether
    their greedy tokens are identical."""
    target = ServeEngine(model, cparams, max_len=64 + k, max_batch=4,
                         backend="codebook", device=device)
    spec_eng = ServeEngine(model, cparams, max_len=64 + k, max_batch=4,
                           backend="codebook", device=device,
                           spec=SpecConfig(draft="model", k=k,
                                           draft_params=cparams,
                                           draft_backend="lut",
                                           lut_levels=512))
    tel.attach_engine(spec_eng)
    want = target.serve(prompts, max_new=max_new // 2)
    got = spec_eng.serve(prompts, max_new=max_new // 2)
    print(f"[    spec] lut(512)-tier draft -> codebook-tier target, k={k}: "
          f"{'identical tokens' if got == want else 'DIVERGED'} over "
          f"{len(prompts) * (max_new // 2)} tokens")
    print(f"           continuation: {got[0][8:]}")
    return got == want


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--lut-max-new", type=int, default=8,
                    help="new tokens of the lut run (its plain version is "
                         "slow on the CPU)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--kv-dtype", default="int8", choices=("bf16", "int8"))
    ap.add_argument("--prefix-cache", default=True,
                    action=argparse.BooleanOptionalAction)
    ap.add_argument("--spec-k", type=int, default=3,
                    help="draft tokens per speculative verify round")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where to run; unset = the GPU (fails without one)")
    return ap


def main(argv=None) -> dict:
    """Runs the example; returns what it served: the probes and kernel
    launches of each backend, the paged engine, whether spec's tokens
    were identical, and the telemetry registry."""
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, model, cparams = compressed_model(args.arch, dev)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, 8)]
               for _ in range(args.requests)]
    # one metrics registry for the whole run: each engine below attaches
    # its subsystem stats, and the end-of-run summary reads them
    tel = Telemetry()
    tel.attach_kernel_counters()
    probe_rows, launches = serve_backends(model, cparams, prompts,
                                          args.max_new, args.lut_max_new, dev)
    numerics_table(probe_rows)
    before = ops.launch_counts()
    paged = serve_paged(cfg, cparams, rng, tel, args.requests, args.max_new,
                        args.page_size, args.kv_dtype, args.prefix_cache, dev)
    launches["paged"] = _launched(before)
    before = ops.launch_counts()
    same = serve_spec(model, cparams, prompts, tel, args.spec_k, args.max_new,
                      dev)
    launches["spec"] = _launched(before)
    print(tel.summary())
    return {"numerics": probe_rows, "launches": launches, "paged": paged,
            "spec_identical": same, "telemetry": tel}


if __name__ == "__main__":
    main()
