"""The serving half of the numerics probes (the port's copy of
``repro/serving/probes.py``).

The collector lives in ``repro_torch.kernels.probes`` (``models/`` imports
it without touching ``serving/``); this module is what the engine and the
telemetry read:

* ``static_index_audit``: one scan of the weight-index planes, which never
  change at run time: how many ids are stored negative (narrow signed
  dtypes, resolved by the gathers' Python-style wrap) and how many stay
  outside ``[0, |W|)`` after the wrap (the addresses the kernels' clamped
  gathers would silently pin).  The engine runs it once at set-up.
* ``summarize``: the raw counters, read back in one copy, turned into the
  ``numerics`` snapshot section: per-layer saturation rates, int32
  accumulator headroom in bits, KV round-trip max and mean error, matmul
  calls, page-table ids out of range, and the static audit.
* ``golden_entry`` / ``sentinel_check``: the drift-sentinel policy: exact
  static counts, bounded drift for measured floats, and hard floors for
  the safety margins (the accumulator's headroom must stay above 0 bits
  everywhere, the run-time check of ``make_lut_spec``'s static
  no-overflow scale).
* ``run_golden_scenarios``: the reference's golden prompts served through
  every backend and cache mode with probes on.

No clock is read here: everything is arithmetic on counters or a walk of
a params tree.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.probes import (  # noqa: F401
    MAXES, PER_LAYER, SCALARS, active, bump, init_state, layer, record,
    tap_act, tap_kv, tap_matmul,
)

INT32_MAX = float(2**31 - 1)

#: headroom reported for a layer whose accumulator never moved: the full
#: signed-int32 magnitude budget.
FULL_HEADROOM_BITS = 31.0

__all__ = ["static_index_audit", "summarize", "golden_entry",
           "sentinel_check", "run_golden_scenarios", "init_state", "layer",
           "bump", "record", "active", "tap_act", "tap_kv", "tap_matmul",
           "INT32_MAX", "FULL_HEADROOM_BITS", "PER_LAYER", "MAXES",
           "SCALARS", "GOLDEN_PROMPTS", "GOLDEN_MAX_NEW",
           "GOLDEN_SCENARIOS"]


def _id_counts(w: torch.Tensor, n_w: int) -> tuple:
    """(ids stored negative, ids outside [0, n_w) after the wrap ``id +
    n_w`` of a negative id), as int64 tensors on ``w``'s device.  After the
    wrap an id is out of range iff it is < −n_w or ≥ n_w; a bound past
    ``w``'s dtype cannot be crossed and is not compared."""
    info = torch.iinfo(w.dtype)
    neg = (w < 0).sum()
    oob = torch.zeros_like(neg)
    if -n_w > info.min:
        oob = oob + (w < -n_w).sum()
    if n_w <= info.max:
        oob = oob + (w >= n_w).sum()
    return neg, oob


def static_index_audit(params) -> dict:
    """Count the weight ids that the kernels' gathers canonicalize.

    Walks every ``{"w_idx", "codebook"}`` site of the params tree (the form
    ``to_codebook_params`` emits; the lut's ``lut_table`` leaves beside
    them are no index sites).  ``widx_neg`` counts ids stored negative,
    legitimate for narrow signed dtypes (|W| = 256 in int8 stores ids ≥
    128 as negatives) and resolved by the gathers' wrap (``id + |W|``);
    ``widx_oob`` counts ids still outside ``[0, |W|)`` after that wrap,
    the bad addresses a clamped gather would pin.  The counting runs where
    the ids live, and the totals are read back once.  Returns
    ``{"widx_neg", "widx_oob", "widx_total"}`` as plain ints.
    """
    counts, total = [], 0

    def walk(node) -> None:
        nonlocal total
        if not isinstance(node, dict):
            return
        if "w_idx" in node and "codebook" in node:
            w = node["w_idx"]
            if not (w.dtype.is_floating_point or w.dtype.is_complex
                    or w.dtype == torch.bool):
                neg, oob = _id_counts(w, int(node["codebook"].shape[-1]))
                counts.append(torch.stack([neg, oob]))
                total += w.numel()
        for v in node.values():
            walk(v)

    walk(params)
    if not counts:
        return {"widx_neg": 0, "widx_oob": 0, "widx_total": 0}
    neg, oob = torch.stack(counts).sum(0).tolist()
    return {"widx_neg": neg, "widx_oob": oob, "widx_total": total}


def summarize(state: dict, *, audit: dict | None = None,
              backend: str = "dense") -> dict:
    """Raw device counters → the canonical ``numerics`` section.

    The state is read back in one copy.  Derived series: ``sat_rate``
    (clipped elements / elements seen), ``headroom_bits`` (log2(INT32_MAX
    / acc_max), capped at the full 31-bit budget when a layer's
    accumulator never moved) and ``kv_err_mean``.  Values are plain Python
    numbers (the f32 counters' values); the telemetry ``snapshot()``
    canonicalizes them.
    """
    if not state:
        return {}
    names = list(state)
    flat = torch.cat([state[k].reshape(-1) for k in names]).to("cpu")
    host, at = {}, 0
    for k in names:
        n = state[k].numel()
        host[k] = [float(v) for v in flat[at:at + n].tolist()]
        at += n
    sat, tot, acc = host["act_sat"], host["act_total"], host["acc_max"]
    kv_sum, kv_cnt = host["kv_err_sum"], host["kv_err_cnt"]
    headroom = [min(FULL_HEADROOM_BITS, math.log2(INT32_MAX / a))
                if a > 0.0 else FULL_HEADROOM_BITS for a in acc]
    out = {
        "backend": backend,
        "tokens": host["tokens"][0],
        "page_oob": host["page_oob"][0],
        "matmul_calls": host["matmul_calls"],
        "act_sat": sat,
        "act_total": tot,
        "sat_rate": [s / t if t > 0.0 else 0.0 for s, t in zip(sat, tot)],
        "acc_max": acc,
        "headroom_bits": headroom,
        "kv_err_max": host["kv_err_max"],
        "kv_err_mean": [s / c if c > 0.0 else 0.0
                        for s, c in zip(kv_sum, kv_cnt)],
    }
    out.update(audit or {})
    return out


# --- drift sentinels ---------------------------------------------------------
#
# The bounds policy (the reference commits it as golden_numerics.json):
#   * static integer counts (widx_*, page_oob) must match exactly: the index
#     planes are deterministic artifacts of the compression;
#   * measured floats (saturation rate, KV error) may drift by the slack
#     below (reduction order differs across devices), never past 1.25× plus
#     an absolute epsilon;
#   * accumulator headroom has a hard floor at > 0 bits and may not fall
#     more than 1 bit below the golden value.

SAT_RATE_SLACK = 1.25
SAT_RATE_EPS = 2e-3
KV_ERR_SLACK = 1.25
KV_ERR_EPS = 1e-4
HEADROOM_DROP_BITS = 1.0

#: The golden scenarios: one prompt set served through every backend ×
#: cache mode (int8 pages on the paged rows, so that the KV probe sees
#: real quantization), the reference's table.
GOLDEN_PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [9, 10]]
GOLDEN_MAX_NEW = 6
GOLDEN_SCENARIOS = {
    "dense/contig": ("dense", {}),
    "dense/paged": ("dense",
                    {"paged": True, "page_size": 8, "kv_dtype": "int8"}),
    "codebook/contig": ("codebook", {}),
    "codebook/paged": ("codebook",
                       {"paged": True, "page_size": 8, "kv_dtype": "int8"}),
    "lut/contig": ("lut", {}),
    "lut/paged": ("lut",
                  {"paged": True, "page_size": 8, "kv_dtype": "int8"}),
}


def run_golden_scenarios(model, params, cparams, *, device=None,
                         probes: bool = True,
                         tokens: dict | None = None) -> dict:
    """Serve the golden prompts through every scenario on ``device`` (None
    = the GPU) with ``probes`` on; returns ``{scenario: numerics}`` (empty
    sections with probes off).  ``tokens``, when given, receives each
    scenario's served tokens.  The engine is imported here: ``engine.py``
    imports this module."""
    from repro_torch.serving.engine import ServeEngine

    out = {}
    for name, (be, kw) in GOLDEN_SCENARIOS.items():
        p = params if be == "dense" else cparams
        eng = ServeEngine(model, p, max_len=48, max_batch=2, backend=be,
                          probes=probes, device=device, **kw)
        got = eng.serve(GOLDEN_PROMPTS, max_new=GOLDEN_MAX_NEW)
        if tokens is not None:
            tokens[name] = got
        out[name] = eng.numerics()
    return out


def golden_entry(num: dict) -> dict:
    """What one golden scenario records: worst-layer summaries and the
    exact static index counts."""
    return {
        "sat_rate_max": max(num.get("sat_rate") or [0.0]),
        "headroom_bits_min": min(num.get("headroom_bits")
                                 or [FULL_HEADROOM_BITS]),
        "kv_err_max": max(num.get("kv_err_max") or [0.0]),
        "widx_neg": int(num.get("widx_neg", 0)),
        "widx_oob": int(num.get("widx_oob", 0)),
        "tokens": float(num.get("tokens", 0.0)),
    }


def sentinel_check(num: dict, golden: dict | None) -> list:
    """Compare a fresh numerics snapshot against recorded bounds.

    Returns a list of readable failures; empty means the sentinels pass.
    ``golden`` None or empty fails loudly: the scenario was never
    recorded.
    """
    if not num:
        return ["empty numerics snapshot (probes not enabled?)"]
    if not golden:
        return ["no golden entry committed for this scenario "
                "(run with GOLDEN_UPDATE=1 to bless it)"]
    fails = []
    for k in ("widx_neg", "widx_oob"):
        if int(num.get(k, 0)) != int(golden.get(k, 0)):
            fails.append(f"{k}: measured {num.get(k, 0)} != "
                         f"golden {golden.get(k, 0)} (static counts must "
                         f"match exactly)")
    if float(num.get("page_oob", 0.0)) != 0.0:
        fails.append(f"page_oob: {num['page_oob']} page-table ids outside "
                     f"[0, n_pages) (expected 0)")

    sat = max(num.get("sat_rate") or [0.0])
    sat_bound = golden.get("sat_rate_max", 0.0) * SAT_RATE_SLACK + SAT_RATE_EPS
    if sat > sat_bound:
        fails.append(f"sat_rate_max: {sat:.6f} > bound {sat_bound:.6f} "
                     f"(golden {golden.get('sat_rate_max', 0.0):.6f})")

    hr = min(num.get("headroom_bits") or [FULL_HEADROOM_BITS])
    if hr <= 0.0:
        fails.append(f"headroom_bits_min: {hr:.2f} — int32 accumulator "
                     f"margin exhausted (choose_scale guarantee violated)")
    gold_hr = golden.get("headroom_bits_min")
    if gold_hr is not None and hr < gold_hr - HEADROOM_DROP_BITS:
        fails.append(f"headroom_bits_min: {hr:.2f} fell more than "
                     f"{HEADROOM_DROP_BITS} bit below golden {gold_hr:.2f}")

    kv = max(num.get("kv_err_max") or [0.0])
    kv_bound = golden.get("kv_err_max", 0.0) * KV_ERR_SLACK + KV_ERR_EPS
    if kv > kv_bound:
        fails.append(f"kv_err_max: {kv:.6g} > bound {kv_bound:.6g} "
                     f"(golden {golden.get('kv_err_max', 0.0):.6g})")
    return fails
