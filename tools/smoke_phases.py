#!/usr/bin/env python3
"""Run a checkout's ``chip_smoke.py`` with each of its log lines stamped.

    python3 tools/smoke_phases.py [--root DIR]

Loads ``DIR/chip_smoke.py`` (default: this checkout's) as a module, so that
it imports ``repro_torch`` from ``DIR/src``, and runs its ``main`` with its
``log`` wrapped: every line it logs is prefixed by the seconds since the
start, the device memory the caching allocator holds reserved, the
allocator's peak reserved since its last reset (the script resets the peak
statistics around its serves), and the device memory in use as CUDA
counts it (``torch.cuda.mem_get_info``: the allocator's, the CUDA
context's, and whatever else the process holds), in GiB.  A last line
gives the largest reading of that peak over the run, and the lines that
say a profiler session was taken again.  The exit code is the script's.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(args.root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    t0, peak, retaken, orig = time.time(), [0.0], [], smoke.log

    def log(*a):
        if torch.cuda.is_available():
            now = torch.cuda.memory_reserved() / 2 ** 30
            peak[0] = max(peak[0], torch.cuda.max_memory_reserved() / 2 ** 30)
            free, total = torch.cuda.mem_get_info()
            orig(f"[+{time.time() - t0:.1f}s reserved {now:.2f} GiB, peak "
                 f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f} GiB, "
                 f"device used {(total - free) / 2 ** 30:.2f} GiB]", *a)
        else:
            orig(*a)
        text = " ".join(str(x) for x in a)
        if "taking both again" in text or "profiler session" in text:
            retaken.append(text[:80])

    smoke.log = log
    rc = smoke.main()
    print(f"[phases] {time.time() - t0:.1f}s, exit {rc}; largest peak "
          f"reserved read {peak[0]:.2f} GiB; profiler sessions retaken "
          f"{len(retaken)}: {retaken}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
