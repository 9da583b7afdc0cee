#!/usr/bin/env python3
"""Host microseconds per call of the port's two matmul wrappers.

    python3 tools/wrapper_host_us.py [--root DIR] [--calls 64]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its kernels, and times ``codebook_matmul_cuda`` (bf16 x, int16 ids) and
``lut_matmul_cuda`` (int32 row ids, int16 ids, a 4096 × 1000 table) at the
decode shape 4 × 2048 × 6144 on one CUDA card.  The calls are queued behind
a device-side sleep, so the host clock measures what the host spends on a
call (checks, plan, allocation, launch) and never waits on the card.
Prints one JSON line: the root, µs per call of each wrapper (median of 7
rounds) and the card's name and power limit.  Only the wrappers' public
signatures are used, so two checkouts can be compared in one run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # few enough that the launches of a round (a wrapper may issue several
    # operations a call) fit CUDA's launch queue without blocking the host
    ap.add_argument("--calls", type=int, default=64)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wrapper_host_us: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import codebook_matmul as cm
    from repro_torch.kernels import lut_matmul as lm
    build.build_all(("codebook_matmul", "lut_matmul"))

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    M, K, N = 4, 2048, 6144
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    wi = torch.randint(0, 1000, (K, N), generator=g, device=dev
                       ).to(torch.int16)
    book = torch.randn(1000, generator=g, device=dev) * 0.05
    a = torch.randint(0, 4096, (M, K), generator=g, device=dev,
                      dtype=torch.int32)
    tab = torch.randint(-(1 << 20), 1 << 20, (4096, 1000), generator=g,
                        device=dev, dtype=torch.int32)
    calls = {"codebook_matmul": lambda: cm.codebook_matmul_cuda(x, wi, book),
             "lut_matmul": lambda: lm.lut_matmul_cuda(a, wi, tab)}
    res = {}
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(7):
            torch.cuda._sleep(1 << 30)       # about 0.5 s of device time
            t = time.perf_counter()
            for _ in range(args.calls):
                fn()
            rounds.append(1e6 * (time.perf_counter() - t) / args.calls)
            torch.cuda.synchronize()
        res[name] = statistics.median(rounds)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"root": args.root, "host_us_per_call": res,
                      "card": smi[0] if smi else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
