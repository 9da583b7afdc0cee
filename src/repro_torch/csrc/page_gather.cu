// page_gather for Hopper (sm_90a):  out_q[s] = pool_q[clamp(page_table[s], 0, n_pages_q - 1)]
// for up to four pools q that share one page table, in one launch.
//
// Replaces repro/kernels/page_gather.py::page_gather_kernel (the Pallas TPU
// kernel, reached through page_gather_pallas): the paged KV cache's gather,
// which assembles each serving slot's logical K/V sequence from a pool of
// fixed-size pages.  On the TPU the page table is scalar-prefetched and each
// (b, p) grid step DMAs one page.  Here it is a copy of whole pages, and the
// dtype does not matter, so the kernel moves bytes.  One code path serves
// int8 K/V pages (16, 8, 128) = 16 KB, bf16 K/V pages (32 KB), bf16 scale
// pages (16, 8) = 256 B and any other page shape.
//
// What bounds it: bytes.  Every gathered page is read once from device memory
// and written once, 2 * B * P * page_bytes in all, over 3.35 TB/s; it does no
// arithmetic.  At the decode shape of the serving path (B 4 slots, P 32 pages,
// 16 KB int8 pages) that is 2 * 2 MB, about 1.3 us: near the cost of a launch.
//
// What the design does about that:
// - One launch for every pool that shares a table.  A paged layer gathers K,
//   V and (int8 pages) their scales with the same table; the four copies are
//   one grid whose y axis runs over the chunks of every pool's page in turn,
//   so a layer pays one launch and one host call, not four.
// - The whole card takes part.  A block copies one chunk of kChunk = 2 KB of
//   one output page (blockIdx.x the slot, blockIdx.y the pool and chunk), so
//   a 1 x 32 prefill table of 16 KB pages is 256 blocks, not 32.
// - Bytes in flight without registers.  One thread of the block moves its
//   chunk with a TMA bulk copy into shared memory and a bulk store out of
//   it, completion on an mbarrier; a block is one warp, so 32 of them (64 KB
//   of copies) fit on an SM.  A route through registers (each of 128 threads
//   one 16-byte load before its store) was timed against it on the serving
//   path's multi-pool launch and lost by a few per cent (PERF.md).
// - A pool whose pages are no multiple of 16 bytes, or whose bases are not
//   16-byte aligned, is copied byte by byte by the warp.
// - The TPU kernel's scalar prefetch becomes one load of the block's page id,
//   clamped into its pool as the TPU wrapper clamps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxPools = 4;
constexpr int kChunk = 2048;                  // bytes of one page a block copies
constexpr int kThreads = 32;                  // one warp a block

struct Pool {
    const uint8_t* src;
    uint8_t* dst;
    long long page_bytes;
    int n_pages;
    int vec;          // 1: 16-byte vectors, 0: bytes
    int chunk0;       // first blockIdx.y of this pool
};

struct Pools {
    Pool p[kMaxPools];
    int n;
};

// The block's pool, chosen with constant indices so that the parameter
// struct is never copied to local memory.
__device__ __forceinline__ Pool pick(const Pools& ps, int y) {
    Pool q = ps.p[0];
#pragma unroll
    for (int j = 1; j < kMaxPools; ++j)
        if (j < ps.n && y >= ps.p[j].chunk0) q = ps.p[j];
    return q;
}

struct Chunk {
    const uint8_t* src;
    uint8_t* dst;
    long long begin, end;     // bytes of the page
};

__device__ __forceinline__ Chunk locate(const Pools& ps, const int32_t* __restrict__ table,
                                        Pool& q) {
    q = pick(ps, blockIdx.y);
    const long long slot = blockIdx.x;
    int pid = __ldg(table + slot);
    pid = min(max(pid, 0), q.n_pages - 1);
    Chunk c;
    c.src = q.src + (long long)pid * q.page_bytes;
    c.dst = q.dst + slot * q.page_bytes;
    c.begin = (long long)(blockIdx.y - q.chunk0) * kChunk;
    c.end = min(c.begin + kChunk, q.page_bytes);
    return c;
}

__global__ void __launch_bounds__(kThreads)
page_gather_kernel(Pools ps, const int32_t* __restrict__ table) {
    __shared__ alignas(128) uint8_t buf[kChunk];
    __shared__ alignas(8) uint64_t bar;
    Pool q;
    const Chunk c = locate(ps, table, q);
    if (!q.vec) {
        for (long long i = c.begin + threadIdx.x; i < c.end; i += kThreads) c.dst[i] = c.src[i];
        return;
    }
    if (threadIdx.x != 0) return;
    const unsigned bytes = (unsigned)(c.end - c.begin);
    csrc::mbar_init(&bar, 1);
    csrc::mbar_fence_init();
    csrc::mbar_expect_tx(&bar, bytes);
    csrc::bulk_copy(buf, c.src + c.begin, bytes, &bar);
    csrc::mbar_wait(&bar, 0);
    csrc::bulk_store(c.dst + c.begin, buf, bytes);
    csrc::bulk_store_wait_read();
}

}  // namespace

// page_table: n_slots int32 page ids, shared by the n_pools (1..4) pools.
// Pool q: src_q, n_pages_q pages of page_bytes_q each, contiguous (one
// layer's slice of the pool); dst_q, n_slots pages.  vec_q: 1 when page_bytes_q
// is a multiple of 16 and both bases are 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int page_gather_launch(const int32_t* page_table, int n_slots, int n_pools,
                                  const void* src0, void* dst0, int n_pages0,
                                  long long page_bytes0, int vec0, const void* src1, void* dst1,
                                  int n_pages1, long long page_bytes1, int vec1,
                                  const void* src2, void* dst2, int n_pages2,
                                  long long page_bytes2, int vec2, const void* src3, void* dst3,
                                  int n_pages3, long long page_bytes3, int vec3, void* stream) {
    if (n_pools < 1 || n_pools > kMaxPools)
        return (int)cudaErrorInvalidValue;
    if (n_slots <= 0) return (int)cudaSuccess;
    const void* src[kMaxPools] = {src0, src1, src2, src3};
    void* dst[kMaxPools] = {dst0, dst1, dst2, dst3};
    const int n_pages[kMaxPools] = {n_pages0, n_pages1, n_pages2, n_pages3};
    const long long page_bytes[kMaxPools] = {page_bytes0, page_bytes1, page_bytes2, page_bytes3};
    const int vec[kMaxPools] = {vec0, vec1, vec2, vec3};
    Pools ps = {};
    ps.n = n_pools;
    long long chunks = 0;
    for (int j = 0; j < kMaxPools; ++j) {
        const int k = j < n_pools ? j : n_pools - 1;      // unused slots repeat the last
        if (n_pages[k] <= 0 || page_bytes[k] <= 0) return (int)cudaErrorInvalidValue;
        ps.p[j] = Pool{static_cast<const uint8_t*>(src[k]), static_cast<uint8_t*>(dst[k]),
                       page_bytes[k], n_pages[k], vec[k], (int)chunks};
        if (j < n_pools) chunks += (page_bytes[k] + kChunk - 1) / kChunk;
    }
    for (int j = n_pools; j < kMaxPools; ++j) ps.p[j].chunk0 = (int)chunks;
    if (chunks > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)n_slots, (unsigned)chunks);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    page_gather_kernel<<<grid, kThreads, 0, s>>>(ps, page_table);
    return (int)cudaGetLastError();
}
