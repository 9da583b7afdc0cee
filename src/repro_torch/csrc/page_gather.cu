// page_gather for Hopper (sm_90a):  out[s] = pool[clamp(page_table[s], 0, n_pages - 1)]
//
// Replaces repro/kernels/page_gather.py::page_gather_kernel (the Pallas TPU
// kernel, reached through page_gather_pallas): the paged KV cache's gather,
// which assembles each serving slot's logical K/V sequence from a pool of
// fixed-size pages.  On the TPU the page table is scalar-prefetched and each
// (b, p) grid step DMAs one page.  Here there is no gather instruction to
// speak of either: it is a copy of whole pages, and the dtype does not matter,
// so the kernel moves bytes.  One code path serves int8 K/V pages
// (16, 8, 128) = 16 KB, bf16 K/V pages (32 KB), bf16 scale pages (16, 8) =
// 256 B and any other page shape.
//
// What bounds it: bytes.  Every gathered page is read once from device memory
// and written once, 2 * B * P * page_bytes in all, over 3.35 TB/s; it does no
// arithmetic.  At the decode shape of the serving path (B 4 slots, P 32 pages,
// 16 KB int8 pages) that is 2 * 2 MB, about 1.3 us, so one launch is near the
// cost of launching it at all.
//
// What the design does about that: one block per output page (blockIdx.x =
// b * P + p).  The block reads its own page id (the TPU kernel's scalar
// prefetch becomes one load per block), clamps it into the pool as the TPU
// kernel does, and its threads stream the page with 16-byte loads and stores,
// neighbouring threads on neighbouring addresses, several loads in flight per
// thread.  A page is contiguous in both pool and output, so the copy has no
// index arithmetic beyond the page base.  When both bases of a page are
// 16-byte aligned, its page_bytes / 16 vectors are copied as such and the tail
// of fewer than 16 bytes byte by byte; a page whose bases are not aligned (a
// page size that is no multiple of 16) is copied byte by byte.  Threads per
// block follow the page size (32 for a 256-byte scale page, 256 for K/V pages)
// so small pages do not leave most of a block idle.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kMaxThreads)
page_gather_kernel(const uint8_t* __restrict__ pool, const int32_t* __restrict__ page_table,
                   uint8_t* __restrict__ out, int n_pages, long long page_bytes) {
    const long long slot = blockIdx.x;
    int pid = page_table[slot];
    pid = min(max(pid, 0), n_pages - 1);
    const uint8_t* src = pool + (long long)pid * page_bytes;
    uint8_t* dst = out + slot * page_bytes;

    long long done = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
        (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        const long long n16 = page_bytes >> 4;
        const uint4* s = reinterpret_cast<const uint4*>(src);
        uint4* d = reinterpret_cast<uint4*>(dst);
        const long long step = (long long)blockDim.x * kUnroll;
        long long i = threadIdx.x;
        for (; i + (long long)blockDim.x * (kUnroll - 1) < n16; i += step) {
            uint4 v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(s + i + (long long)u * blockDim.x);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) d[i + (long long)u * blockDim.x] = v[u];
        }
        for (; i < n16; i += blockDim.x) d[i] = __ldg(s + i);
        done = n16 << 4;
    }
    for (long long i = done + threadIdx.x; i < page_bytes; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

// pool: n_pages pages of page_bytes each, contiguous (one layer's slice of the
// pool).  page_table: n_slots int32 page ids.  out: n_slots pages.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int page_gather_launch(const void* pool, const int32_t* page_table, void* out,
                                  int n_slots, int n_pages, long long page_bytes,
                                  void* stream) {
    if (n_slots <= 0 || page_bytes <= 0) return (int)cudaSuccess;
    if (n_pages <= 0) return (int)cudaErrorInvalidValue;
    const long long vecs = (page_bytes + 15) >> 4;
    int threads = (int)((vecs + 31) / 32 * 32);
    if (threads > kMaxThreads) threads = kMaxThreads;
    page_gather_kernel<<<n_slots, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(pool), page_table, static_cast<uint8_t*>(out), n_pages,
        page_bytes);
    return (int)cudaGetLastError();
}
