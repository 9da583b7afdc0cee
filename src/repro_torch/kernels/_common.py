"""What both matmul kernels share: id canonicalization, the route and
tiling plans, and the zeroed scratch of lut's in-launch split-K reduction.

``codebook_plan``, ``swiglu_plan`` (the gated launch's) and ``lut_plan``
are pure functions of the shape, the dtypes, whether the rows may be read as
16-byte vectors, and the card's SM count, cached, so a wrapper call pays a
dictionary lookup for them: they
pick the route (a kernel of ``csrc/``), its template instance (rows per
block, threads, ring stages) and how far K is split across blocks, every
split a whole number of stages.  ``check_plan`` holds a plan passed in by a
caller to what the route takes.  Their constants mirror those of
``csrc/codebook_matmul.cu`` and ``csrc/lut_matmul.cu``.  The splits of a
tile meet in the same launch: in one thread block cluster (codebook, at most
8 splits), or through an arrival counter per tile (lut,
``csrc/common.cuh``); lut's counters and accumulator are ``scratch``:
allocated zeroed once per device, kept (never freed, for the CUDA graphs
that hold their addresses), and left zeroed by every launch, so launches
that share them run in stream order.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

__all__ = ["canonical_idx", "codebook_plan", "swiglu_plan", "codebook_smem",
           "lut_plan", "check_plan", "Plan",
           "scratch", "sm_count", "is_aligned", "lut_max_threads",
           "lut_stage_bytes", "STAGE", "SMEM_BUDGET", "MAX_CLUSTER"]

STAGE = 32                       # K granularity of a split
SMEM_BUDGET = 220 * 1024         # of the 227 KB a block may use on sm_90
MAX_CLUSTER = 8                  # blocks of a portable thread block cluster


class Plan(NamedTuple):
    route: str                   # codebook: mma | fma; lut: smem | l2
    bm: int                      # rows of x / a per block
    threads: int                 # threads per block
    stages: int                  # ring stages of the pipeline
    splits: int                  # K splits: blocks along blockIdx.z
    k_chunk: int                 # K rows per split, a multiple of stage
    tiles: int                   # output tiles, one arrival counter each
    stage: int                   # K rows of one pipeline stage


def canonical_idx(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 ids in [0, n): narrow dtypes store ids ≥ 2^(bits−1) as
    negatives (two's complement)."""
    idx = idx.to(torch.int32)
    return torch.where(idx < 0, idx + n, idx)


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def sm_count(device) -> int:
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(K: int, tiles: int, want_blocks: int, max_splits: int,
           stage: int = STAGE, max_chunk: int | None = None
           ) -> tuple[int, int]:
    """(splits, k_chunk): about ``want_blocks`` blocks over ``tiles``, each
    split a whole number of ``stage``-deep stages."""
    splits = max(1, min(_cdiv(want_blocks, tiles), _cdiv(K, stage), max_splits))
    if max_chunk is not None:
        splits = max(splits, _cdiv(K, max_chunk))
    k_chunk = _cdiv(_cdiv(K, splits), stage) * stage
    return _cdiv(K, k_chunk), k_chunk


def _vec(idx_bytes: int, bm: int) -> int:
    """Columns a thread of lut's smem route owns: one 16-byte load of ids,
    fewer where the accumulators would pass 128 registers."""
    return min(16 // idx_bytes, 128 // bm)


# codebook_matmul.cu
MMA_ROWS = (16, 64)              # mma route: rows a block, at M <= 16 and beyond
MMA_TILE_N = 64                  # mma route: columns a block
FMA_TILE = (64, 64)              # fma route


@functools.cache
def codebook_plan(M: int, K: int, N: int, *, bf16: bool, vec_ok: bool,
                  sms: int) -> Plan:
    """The route of one codebook_matmul launch: tensor cores (mma) for bf16
    x whose rows and id rows may be read as aligned 16-byte vectors
    (``vec_ok``), the FMA tile for the rest.  The splits of a tile meet in
    one cluster, so there are at most MAX_CLUSTER."""
    if bf16 and vec_ok and K % 8 == 0:
        bm = MMA_ROWS[0] if M <= MMA_ROWS[0] else MMA_ROWS[1]
        tiles = _cdiv(M, bm) * _cdiv(N, MMA_TILE_N)
        # one wave: two blocks an SM fit at 16 rows, one at 64 (registers)
        per_sm = 2 if bm == MMA_ROWS[0] else 1
        splits, k_chunk = _split(K, 1, max(1, per_sm * sms // tiles),
                                 MAX_CLUSTER)
        return Plan("mma", bm, 256, 2, splits, k_chunk, tiles, STAGE)
    tiles = _cdiv(M, FMA_TILE[0]) * _cdiv(N, FMA_TILE[1])
    splits, k_chunk = _split(K, tiles, 2 * sms, MAX_CLUSTER)
    return Plan("fma", FMA_TILE[0], 256, 0, splits, k_chunk, tiles, STAGE)


MMA_STAGE = 128                  # mma route: K rows a stage (kMSK)
MMA_STRIDES = (MMA_STAGE + 8, MMA_TILE_N + 8)   # padded bf16 rows of x, ids
FMA_STATIC_SMEM = 2 * 32 * FMA_TILE[0] * 4      # fma route: its stage tiles


def codebook_smem(route: str, bm: int, n_books: int) -> int:
    """Shared memory of one codebook_matmul.cu launch holding ``n_books``
    codebook entries (both books of a gated launch): the mma route's two
    stages of bf16 tiles, its f32 sums and the books in bf16; the fma
    route's stage tiles and the books as f32."""
    if route == "fma":
        return FMA_STATIC_SMEM + 4 * n_books
    a, b = MMA_STRIDES
    tiles = 2 * (bm * a * 2 + MMA_STAGE * b * 2)
    return tiles + bm * b * 4 + _cdiv(2 * n_books, 16) * 16


@functools.cache
def swiglu_plan(M: int, K: int, N: int, *, bf16: bool, vec_ok: bool,
                sms: int, n_books: int) -> Plan:
    """The plan of one gated launch (``codebook_swiglu``): ``codebook_plan``
    for ONE (M, K, N) product, which both of its products take, so that
    each sum runs the adds of a codebook_matmul launch in their order and
    the result equals the unfused chain bit for bit.  Raises ValueError
    when the two codebooks (``n_books`` entries together) do not fit in
    shared memory beside the route's tiles."""
    plan = codebook_plan(M, K, N, bf16=bf16, vec_ok=vec_ok, sms=sms)
    need = codebook_smem(plan.route, plan.bm, n_books)
    if need > SMEM_BUDGET:
        raise ValueError(f"codebooks of {n_books} entries together take "
                         f"{need} B of shared memory on the {plan.route} "
                         f"route; {SMEM_BUDGET} B fit")
    return plan


# lut_matmul.cu
LUT_ROWS = (4, 16)               # smem route
L2_ROWS = (4, 16, 64)            # l2 route
LUT_STAGE = 4                    # smem route: K granularity of a split
LUT_MAX_STAGES = 8               # smem route: ring depth at most
LUT_A_BYTES = 16 * 1024          # smem route: a split's scaled row ids
LUT_L2_MAX_N = 1024              # l2 route at M <= 4 up to this many columns


def lut_max_threads(bm: int, idx_bytes: int) -> int:
    """The smem route's __launch_bounds__: accumulators plus some 40
    registers a thread, within the SM's 65536."""
    return min(1024, 65536 // (bm * _vec(idx_bytes, bm) + 40) // 32 * 32)


def lut_stage_bytes(bm: int, n_cols: int) -> int:
    """Bytes of one ring stage: bm table rows (the ids go to registers)."""
    return bm * _cdiv(n_cols, 4) * 4 * 4


@functools.cache
def lut_plan(M: int, K: int, N: int, *, n_cols: int, idx_bytes: int,
             sms: int, route: str | None = None) -> Plan:
    """The route of one lut_matmul launch: table rows staged in shared
    memory where a ring of at least two stages fits beside the split's row
    ids (at most LUT_A_BYTES), else lookups through L2.  At M <= 4 a site
    of at most LUT_L2_MAX_N columns looks up through L2 too: a staged row
    serves too few columns there to pay for its copy, and the L2 route is
    no slower on any ids (PERF.md).  So does an int32 table whose rows do
    not start on 16-byte boundaries (``n_cols`` no multiple of 4, as the
    §4 engine's |W| + 1 columns): the smem route would copy its rows word
    by word, every k, and was 5.9 to 200 times slower than the L2 route
    on the §4 table on an H100 (PERF.md).  ``route`` forces "smem" or
    "l2"."""
    if route is None and (n_cols % 4
                          or (M <= LUT_ROWS[0] and N <= LUT_L2_MAX_N)):
        route = "l2"
    small, large = LUT_ROWS
    for bm in (() if route == "l2" else
               (small,) if M <= small else (large, small)):
        vec = _vec(idx_bytes, bm)
        threads = min(lut_max_threads(bm, idx_bytes),
                      _cdiv(_cdiv(N, vec), 32) * 32)
        bn = threads * vec
        stage = lut_stage_bytes(bm, n_cols)
        budget = SMEM_BUDGET - LUT_A_BYTES
        stages = next((s for s in range(LUT_MAX_STAGES, 1, -1)
                       if max(s * stage, bm * bn * 4) <= budget), 0)
        if stages:
            smem = max(stages * stage, bm * bn * 4) + LUT_A_BYTES
            regs = 65536 // lut_max_threads(bm, idx_bytes)   # the compiler's cap
            resident = max(1, min(2048 // threads, 65536 // (threads * regs),
                                  228 * 1024 // (smem + 1024)))
            tiles = _cdiv(N, bn) * _cdiv(M, bm)
            # a ring stage holds one k; splits of whole LUT_STAGEs, with
            # their row ids in LUT_A_BYTES of shared memory
            splits, k_chunk = _split(K, tiles, resident * sms, 1 << 30,
                                     stage=LUT_STAGE,
                                     max_chunk=LUT_A_BYTES // (4 * bm))
            return Plan("smem", bm, threads, stages, splits, k_chunk, tiles,
                        LUT_STAGE)
    if route == "smem":
        raise ValueError(f"rows of {n_cols} columns are too long to stage")
    bm = next((b for b in L2_ROWS if M <= b), L2_ROWS[-1])
    tiles = _cdiv(N, 64) * _cdiv(M, bm)
    splits, k_chunk = _split(K, tiles, 2 * sms, 1 << 30)
    return Plan("l2", bm, 256, 0, splits, k_chunk, tiles, STAGE)


def check_plan(plan: Plan, K: int, takes: dict, max_splits: int) -> None:
    """Raise ValueError unless operands with K rows can take ``plan``, a
    plan a caller passed in: ``takes[plan.route]`` is true, and at most
    ``max_splits`` splits cover K once, each a whole number of stages."""
    if not takes.get(plan.route, False):
        raise ValueError(f"these operands cannot take route {plan.route!r}")
    if not (0 < plan.stage and 0 < plan.k_chunk
            and plan.k_chunk % plan.stage == 0
            and 1 <= plan.splits <= max_splits
            and (plan.splits - 1) * plan.k_chunk < K
            <= plan.splits * plan.k_chunk):
        raise ValueError(f"plan {plan} does not split K = {K} into at most "
                         f"{max_splits} splits of whole stages")


_SCRATCH: dict = {}              # (tag, device) -> the buffer handed out now
_HANDED: list = []               # every buffer ever handed out


def scratch(tag: str, device, numel: int, dtype) -> torch.Tensor:
    """A zeroed tensor of at least ``numel`` elements, kept per device and
    tag.  Kernels leave it zeroed; it is replaced only to grow.

    A buffer once handed out is never freed: a CUDA graph captured on it
    keeps its address but no reference to it, so a buffer outgrown by a
    later, larger call (a prefill after a captured decode step) must stay
    allocated, and zeroed, for the graph's replays."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    buf = _SCRATCH.get((tag, device))
    if buf is None or buf.numel() < numel:
        buf = torch.zeros(max(numel, 1024), dtype=dtype, device=device)
        _SCRATCH[(tag, device)] = buf
        _HANDED.append(buf)
    return buf


def is_aligned(t: torch.Tensor, row_elems: int) -> bool:
    """Rows of ``row_elems`` elements of ``t`` start on 16-byte boundaries."""
    return t.data_ptr() % 16 == 0 and (row_elems * t.element_size()) % 16 == 0
