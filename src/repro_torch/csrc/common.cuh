// Shared by the matmul kernels of csrc/: the dispatch of launch parameters
// to template instances, cluster launches, the shared-memory opt-in,
// mbarriers and bulk (TMA) copies, and the in-launch split-K reductions.
//
// Split-K without a second launch, two ways.  codebook_matmul: the splits
// of a tile form one thread block cluster and add through distributed
// shared memory (cluster_sum).  lut_matmul: every block of a split tile
// adds its part into device memory, then counts itself in on the tile's
// arrival counter; the block that arrives last finishes the tile and sets
// the counter back to 0 for the next launch (arrive_last).  The counters
// are scratch the wrapper allocates zeroed once per device and keeps
// (kernels/_common.py), so launches that share them run in stream order.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <type_traits>

namespace csrc {

// f(std::integral_constant<int, BM>{}) for bm in {4, 16, 64}
template <typename F>
cudaError_t with_rows_per_block(int bm, F&& f) {
    switch (bm) {
        case 4: return f(std::integral_constant<int, 4>{});
        case 16: return f(std::integral_constant<int, 16>{});
        case 64: return f(std::integral_constant<int, 64>{});
    }
    return cudaErrorInvalidValue;
}

// f(IT{}) with IT the signed id type of idx_bytes (1, 2 or 4)
template <typename F>
cudaError_t with_id_type(int idx_bytes, F&& f) {
    switch (idx_bytes) {
        case 1: return f(int8_t{});
        case 2: return f(int16_t{});
        case 4: return f(int32_t{});
    }
    return cudaErrorInvalidValue;
}

// launch `kernel` with thread block clusters of `cluster` (x, y, z) blocks
template <typename... Params, typename... Args>
cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                             cudaStream_t stream, dim3 cluster, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster.x;
    attr[0].val.clusterDim.y = cluster.y;
    attr[0].val.clusterDim.z = cluster.z;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
    return e != cudaSuccess ? e : cudaGetLastError();
}

// VEC ids of one row of w_idx from src, straight into registers: one 16-byte
// load (8 bytes for int8 at 16 rows), or masked scalars where the thread's
// columns run past N or the rows are not 16-byte aligned (full false)
template <typename IT, int VEC>
__device__ __forceinline__ uint4 load_ids(const IT* __restrict__ src, int col, int N, bool full) {
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (full) {
        if constexpr (VEC * sizeof(IT) == 16) {
            raw = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
            const uint2 t = __ldg(reinterpret_cast<const uint2*>(src));
            raw.x = t.x;
            raw.y = t.y;
        }
    } else {
        IT v[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] = col + j < N ? src[j] : IT(0);
        memcpy(&raw, v, sizeof(v));
    }
    return raw;
}

// Opt `kernel` in to `bytes` of dynamic shared memory on the current device
// where a launch needs more than 48 KB with its static part.  The opt-in is
// set once per kernel and device, not on every launch.
inline cudaError_t allow_smem_fn(const void* kernel, size_t bytes) {
    if (bytes <= 32 * 1024) return cudaSuccess;     // static shared memory counts too
    struct Grant {
        const void* fn;
        int dev;
        size_t bytes;
    };
    static Grant grants[64];
    static int n_grants = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    int i = 0;
    while (i < n_grants && !(grants[i].fn == kernel && grants[i].dev == dev)) ++i;
    if (i < n_grants && grants[i].bytes >= bytes) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    if (i == n_grants && n_grants < 64) ++n_grants;
    if (i < n_grants) grants[i] = Grant{kernel, dev, bytes};
    return cudaSuccess;
}

template <typename... Params>
cudaError_t allow_smem(void (*kernel)(Params...), size_t bytes) {
    return allow_smem_fn(reinterpret_cast<const void*>(kernel), bytes);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers and bulk (TMA) copies, for rings of shared memory
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT_%=;\n"
        "}\n" ::"r"(smem_addr(bar)),
        "r"(parity)
        : "memory");
}

// the async proxy sees this thread's earlier shared-memory accesses
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from shared to
// global memory as one bulk group; bulk_store_wait_read returns once the
// shared memory of every group this thread committed has been read
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        "cp.async.bulk.commit_group;\n" ::"l"(dst), "r"(smem_addr(src)), "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void bulk_store_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Count this block in on its tile's counter after its stores; true in the
// block that arrives last (of `total`), which then sees every other
// block's stores.  Every thread of the block must call it.
__device__ __forceinline__ bool arrive_last(unsigned* counter, unsigned total) {
    __shared__ unsigned last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        last = atomicAdd(counter, 1u) == total - 1u;
        if (last) *counter = 0u;          // every block of this launch is in
    }
    __syncthreads();
    const bool is_last = last;
    if (is_last) __threadfence();
    return is_last;
}

// The splits of a tile form one thread block cluster (at most 8 blocks) and
// each holds its (rows x bn) sums in shared memory at `vals`.  Every block
// adds one slice of the tile over the cluster's blocks, in rank order (the
// same bits whichever block adds), and writes it to out at (m0, n0).
__device__ __forceinline__ void cluster_sum(const float* vals, float* out, int rows, int bn,
                                            int cols, int m0, int n0, int N) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    cluster.sync();
    const int n = rows * bn, per = (n + cs - 1) / cs;
    const int i1 = min(n, (rank + 1) * per);
    for (int i = rank * per + threadIdx.x; i < i1; i += blockDim.x) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = q < cs ? cluster.map_shared_rank(vals, q)[i] : 0.f;
        float s = v[0];
#pragma unroll
        for (int q = 1; q < 8; ++q)
            if (q < cs) s += v[q];
        const int m = i / bn, c = i - m * bn;
        if (c < cols) out[(size_t)(m0 + m) * N + n0 + c] = s;
    }
    cluster.sync();                  // no block leaves while its sums are read
}

}  // namespace csrc
