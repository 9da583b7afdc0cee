"""Deployment export, the port's copy of ``repro/core/export.py``: index
packing, entropy coding and memory accounting (paper §4).

The paper's memory claim: a clustered network stores per weight only a
⌈log2|W|⌉-bit index (10 bits at |W|=1000) instead of a 32-bit float — >69%
savings — and entropy-coding the indices (near-Laplacian occupancy) gets the
average below 7 bits — >78% savings.  The A×W multiplication table
(32×1000 entries) is amortised across the whole network.

Index trees are nested dicts (or lists) of tensors on any device, or of
numpy arrays.  ``memory_report`` counts each index leaf where it lives
(``torch.bincount``) and reads back one vector of counts, never the ids:
at full width a tree holds some 10⁹ of them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "bits_per_index",
    "pack_indices",
    "unpack_indices",
    "entropy_bits",
    "kv_cache_bytes",
    "MemoryReport",
    "memory_report",
]

_BINCOUNT_DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32,
                    torch.int64)


def bits_per_index(n_values: int) -> int:
    return max(1, math.ceil(math.log2(max(n_values, 2))))


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _is_index(a) -> bool:
    """Integer leaf (numpy's sense: bool is not an integer)."""
    if isinstance(a, torch.Tensor):
        return not (a.is_floating_point() or a.is_complex()
                    or a.dtype == torch.bool)
    return np.issubdtype(np.asarray(a).dtype, np.integer)


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def _counts(t: torch.Tensor, minlength: int) -> torch.Tensor:
    """``np.bincount(t.reshape(-1), minlength=minlength)`` where ``t``
    lives: a negative id raises ``ValueError``, as numpy's does."""
    t = t.reshape(-1)
    if t.dtype not in _BINCOUNT_DTYPES:
        t = t.to(torch.int64)
    if t.numel() and int(t.min()) < 0:
        raise ValueError("'list' argument must have no negative elements")
    return torch.bincount(t, minlength=minlength)


def _add(total, counts: torch.Tensor) -> torch.Tensor:
    if total is None:
        return counts
    counts = counts.to(total.device)
    n = max(total.numel(), counts.numel())
    total = torch.nn.functional.pad(total, (0, n - total.numel()))
    return total + torch.nn.functional.pad(counts, (0, n - counts.numel()))


def _entropy(counts: np.ndarray) -> float:
    p = counts[counts > 0] / counts.sum()
    return float(-(p * np.log2(p)).sum())


def pack_indices(idx, bits: int) -> torch.Tensor:
    """Bit-pack non-negative ints (< 2^bits) into a uint8 stream
    (LSB-first), on ``idx``'s device."""
    t = _tensor(idx).reshape(-1).to(torch.int64)
    if t.numel() and (bool((t < 0).any()) or int(t.max()) >= (1 << bits)):
        raise ValueError("index exceeds bit width")
    stream = ((t[:, None] >> torch.arange(bits, device=t.device)) & 1)
    stream = torch.nn.functional.pad(stream.reshape(-1),
                                     (0, -stream.numel() % 8))
    byte_w = torch.arange(8, device=t.device, dtype=torch.int32)
    return (stream.view(-1, 8).to(torch.int32) << byte_w).sum(1).to(
        torch.uint8)


def unpack_indices(packed, bits: int, count: int) -> torch.Tensor:
    """Inverse of pack_indices: ``count`` int64 ids."""
    p = _tensor(packed).reshape(-1).to(torch.uint8)
    if count * bits > 8 * p.numel():
        raise IndexError(f"{count} ids of {bits} bits need "
                         f"{(count * bits + 7) // 8} bytes; got {p.numel()}")
    byte_s = torch.arange(8, device=p.device, dtype=torch.uint8)
    stream = ((p[:, None] >> byte_s) & 1).reshape(-1)[:count * bits]
    return (stream.view(count, bits).to(torch.int64)
            << torch.arange(bits, device=p.device)).sum(1)


def entropy_bits(idx, n_values: int) -> float:
    """Shannon entropy (bits/index) of the marginal index distribution — the
    paper's "simplest (non-adaptive, marginal-only) entropy coding" bound."""
    return _entropy(_counts(_tensor(idx), n_values).cpu().numpy())


def kv_cache_bytes(n_layers: int, n_kv: int, head_dim: int, tokens: int,
                   *, dtype_bytes: int = 2, quant: bool = False,
                   page_size: int = 0) -> int:
    """Serving-state bytes for ``tokens`` cached tokens (K + V, all layers).

    ``quant``: int8 pages + per-token-per-head bf16 scales (the paged
    cache's quantize-what-you-store representation); else plain floats of
    ``dtype_bytes``.  ``page_size > 0`` rounds tokens up to whole pages —
    the paged pool's allocation granularity (the dense slab instead
    allocates ``max_batch × max_len`` regardless of tokens in flight; pass
    that product as ``tokens`` with ``page_size=0`` to size it).
    """
    if page_size:
        tokens = math.ceil(tokens / page_size) * page_size
    per_tok_head = (2 * head_dim * (1 if quant else dtype_bytes)
                    + (4 if quant else 0))          # k+v (+ 2 bf16 scales)
    return n_layers * n_kv * per_tok_head * tokens


@dataclasses.dataclass(frozen=True)
class MemoryReport:
    n_params: int
    n_weights: int          # |W|
    n_levels: int           # |A|
    fp32_bytes: int
    bf16_bytes: int
    index_bits: int
    packed_bytes: int       # indices bit-packed + codebook + LUT tables
    entropy_bits_per_w: float
    entropy_bytes: int      # entropy-coded indices + codebook + LUT tables
    table_bytes: int        # A×W mult table + activation table
    kv_fp_bytes: int = 0      # serving state: dense float KV slab
    kv_packed_bytes: int = 0  # serving state: paged int8 cache in use
    lut_table_bytes: int = 0  # actual attached lut_table leaves (if any)

    @property
    def savings_vs_fp32(self) -> float:
        return 1.0 - self.packed_bytes / self.fp32_bytes

    @property
    def entropy_savings_vs_fp32(self) -> float:
        return 1.0 - self.entropy_bytes / self.fp32_bytes

    @property
    def savings_vs_bf16(self) -> float:
        return 1.0 - self.packed_bytes / self.bf16_bytes

    @property
    def deployed_fp_bytes(self) -> int:
        """End-to-end float deployment: fp32 weights + float KV slab."""
        return self.fp32_bytes + self.kv_fp_bytes

    @property
    def deployed_packed_bytes(self) -> int:
        """End-to-end packed deployment: indices+tables + paged int8 KV."""
        return self.packed_bytes + self.kv_packed_bytes

    @property
    def deployed_savings(self) -> float:
        """The paper's "less than one third" claim measured end-to-end —
        weights AND serving state, not weights alone."""
        if not self.deployed_fp_bytes:
            return 0.0
        return 1.0 - self.deployed_packed_bytes / self.deployed_fp_bytes

    def row(self) -> str:
        s = (f"params={self.n_params} |W|={self.n_weights} |A|={self.n_levels} "
             f"fp32={self.fp32_bytes/1e6:.2f}MB packed={self.packed_bytes/1e6:.2f}MB "
             f"({100*self.savings_vs_fp32:.1f}% saved) "
             f"entropy={self.entropy_bytes/1e6:.2f}MB "
             f"({100*self.entropy_savings_vs_fp32:.1f}% saved, "
             f"{self.entropy_bits_per_w:.2f} bits/w)")
        if self.kv_fp_bytes:
            s += (f" | deployed(w+kv)={self.deployed_fp_bytes/1e6:.2f}MB"
                  f"->{self.deployed_packed_bytes/1e6:.2f}MB "
                  f"({100*self.deployed_savings:.1f}% saved)")
        return s


def _leaves(tree, path=()):
    """[(path tuple, leaf)] of a nested dict/list/tuple tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def memory_report(index_tree, n_weights: int, n_levels: int,
                  table_entries: int = 0,
                  acc_bytes: int = 4,
                  kv_fp_bytes: int = 0,
                  kv_packed_bytes: int = 0) -> MemoryReport:
    """§4 memory accounting for a clustered network in index form.

    ``kv_fp_bytes`` / ``kv_packed_bytes`` (optional, via ``kv_cache_bytes``)
    fold serving state into the claim: a deployed LM ships its KV cache
    alongside its weights, so the "less than one third" comparison is
    (fp32 weights + float slab) vs (packed indices + paged int8 cache).

    The walk is path-aware: ``lut_table`` leaves (the precomputed §4
    A×W tables ``dispatch.attach_lut_tables`` hangs next to each routed
    index dict) are int32 but are *tables*, not per-weight indices —
    they are counted by their actual bytes into the table accounting
    instead of inflating ``n_params``/entropy.  Without attached tables
    the analytic (|A|+1)×(|W|+1) mult-table size is used as before.

    Each index leaf is counted where it lives; the one vector of counts is
    read back, and the entropy computed from it as the reference computes
    it from the concatenated ids.
    """
    n, total, lut_table_bytes = 0, None, 0
    for path, leaf in _leaves(index_tree):
        if "lut_table" in path:
            lut_table_bytes += _nbytes(leaf)
        elif _is_index(leaf):
            t = _tensor(leaf)
            n += t.numel()
            total = _add(total, _counts(t, n_weights))
    bits = bits_per_index(n_weights)
    # mult table: actual attached lut_table leaves when present, else the
    # analytic (|A|+1)×(|W|+1) ints; + activation table + f32 codebook
    mult_bytes = lut_table_bytes or (n_levels + 1) * (n_weights + 1) * acc_bytes
    t_entries = table_entries or 4 * n_levels
    table_bytes = mult_bytes + t_entries * 4 + n_weights * 4
    ent = _entropy(total.cpu().numpy()) if n else 0.0
    return MemoryReport(
        n_params=n, n_weights=n_weights, n_levels=n_levels,
        fp32_bytes=4 * n, bf16_bytes=2 * n,
        index_bits=bits,
        packed_bytes=(n * bits + 7) // 8 + table_bytes,
        entropy_bits_per_w=ent,
        entropy_bytes=int(math.ceil(n * ent / 8)) + table_bytes,
        table_bytes=table_bytes,
        kv_fp_bytes=kv_fp_bytes,
        kv_packed_bytes=kv_packed_bytes,
        lut_table_bytes=lut_table_bytes)
