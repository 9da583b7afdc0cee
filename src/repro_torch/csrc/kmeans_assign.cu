// kmeans_assign for Hopper (sm_90a): one Lloyd step's assignment of n values
// to k sorted centers, with per-center sums and counts (paper §2.2).
//
//   idx[i]    = #{ j : (c[j] + c[j+1]) / 2 <= v[i] }   (searchsorted, side right)
//   sums[c]   = sum of the values assigned to c         (f32)
//   counts[c] = number of values assigned to c          (exact, returned as f32)
//
// Replaces repro/kernels/kmeans1d.py::kmeans_assign_kernel (the Pallas TPU
// kernel, reached through kmeans_assign_pallas).  On the TPU the grid walks
// the values in order and carries the sums in one resident output block,
// with the rank computed as a broadcast compare against all boundaries and
// the sums as one-hot matmuls.  Here blocks run in parallel and in no order,
// so each block sums its own contiguous chunk and a second launch adds the
// blocks' partials in block order.
//
// What bounds it: bytes.  Each value is read once (4 B) and its index
// written once (4 B): 8 B a value, 13.77 GB at the full model's n of
// 1.72e9, 4.11 ms at 3.35 TB/s.  In practice the per-value work (a binary
// search over the k - 1 midpoints in shared memory, log2(k) dependent loads,
// and the histogram update) sets the time.
//
// Design:
// - The midpoints, computed in f32 as (c[j] + c[j+1]) / 2 as the reference
//   does, live in shared memory; a branchless binary search of fixed depth
//   gives the rank.
// - Determinism.  A Lloyd step whose sums changed from run to run would
//   change the codebook, then every weight's index, then the served tokens.
//   So there are no float atomics anywhere.  Each warp keeps its own f32
//   histogram of sums in shared memory.  The warp's 32 lanes group by center
//   (__match_any_sync); the lowest lane of a group adds its group's values in
//   lane order and then adds that to the warp's histogram, so every
//   histogram entry sees its additions in one fixed order.  At the end the
//   block adds its warps' histograms in warp order and writes them to a
//   (n_blocks, k) buffer; the second launch adds the blocks in block order.
//   The chunking depends on n only, so the result does not depend on the
//   card either.
// - Counts are integers: shared-memory integer atomics (exact in any order),
//   summed over blocks in 64 bits and converted to f32 at the end.  They stay
//   exact past 2^24 values a center, where the TPU kernel's f32 running count
//   stops growing; the f32 result is the exact count rounded once.
// - 64-bit offsets: n reaches 1.72e9 at full width.  A bounds check takes the
//   place of the TPU wrapper's 2 * BIG padding.
// - Shared memory: (k - 1) midpoints, 8 warp histograms of k floats, k
//   counts and a 32-float staging row per warp, 40 KB at k = 1000 (five
//   blocks to an SM) and 161 KB at the largest k, 4096.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

size_t smem_bytes(int k) { return ((size_t)k * (kWarps + 2) + kWarps * 32) * sizeof(float); }

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ values, long long n,
                     const float* __restrict__ centers, int k, long long chunk,
                     int32_t* __restrict__ idx, float* __restrict__ part_sums,
                     uint32_t* __restrict__ part_counts) {
    extern __shared__ float smem[];
    float* bounds = smem;                                   // k - 1 used
    float* wsum = bounds + k;                               // kWarps x k
    uint32_t* cnt = reinterpret_cast<uint32_t*>(wsum + (size_t)kWarps * k);   // k
    float* stage = reinterpret_cast<float*>(cnt + k);       // kWarps x 32

    const int m = k - 1;
    for (int j = threadIdx.x; j < m; j += kThreads)
        bounds[j] = __fdiv_rn(__fadd_rn(centers[j], centers[j + 1]), 2.f);
    for (int j = threadIdx.x; j < kWarps * k; j += kThreads) wsum[j] = 0.f;
    for (int j = threadIdx.x; j < k; j += kThreads) cnt[j] = 0u;
    __syncthreads();

    int top = 1;                              // largest power of two <= m (0 when m = 0)
    while (top <= m) top <<= 1;
    top >>= 1;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* hist = wsum + (size_t)warp * k;
    float* st = stage + warp * 32;
    const long long begin = (long long)blockIdx.x * chunk;
    const long long end = begin + chunk < n ? begin + chunk : n;

    for (long long base = begin + warp * 32; base < end; base += kThreads) {
        const long long i = base + lane;
        const bool live = i < end;
        const float v = live ? values[i] : 0.f;
        int pos = 0;
        for (int s = top; s > 0; s >>= 1)
            if (pos + s <= m && bounds[pos + s - 1] <= v) pos += s;
        if (live) idx[i] = pos;
        const unsigned grp = __match_any_sync(kFull, live ? pos : -1);
        st[lane] = v;
        __syncwarp();
        if (live && lane == __ffs(grp) - 1) {
            float s = 0.f;
            for (unsigned g = grp; g != 0; g &= g - 1) s = __fadd_rn(s, st[__ffs(g) - 1]);
            hist[pos] = __fadd_rn(hist[pos], s);
            atomicAdd(&cnt[pos], (uint32_t)__popc(grp));
        }
        __syncwarp();
    }
    __syncthreads();

    for (int c = threadIdx.x; c < k; c += kThreads) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, wsum[(size_t)w * k + c]);
        part_sums[(size_t)blockIdx.x * k + c] = s;
        part_counts[(size_t)blockIdx.x * k + c] = cnt[c];
    }
}

__global__ void kmeans_reduce_kernel(const float* __restrict__ part_sums,
                                     const uint32_t* __restrict__ part_counts, int n_blocks,
                                     int k, float* __restrict__ sums, float* __restrict__ counts) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= k) return;
    float s = 0.f;
    unsigned long long total = 0;
    for (int b = 0; b < n_blocks; ++b) {
        s = __fadd_rn(s, part_sums[(size_t)b * k + c]);
        total += part_counts[(size_t)b * k + c];
    }
    sums[c] = s;
    counts[c] = (float)total;
}

}  // namespace

// Shared memory one block of the assignment kernel needs for k centers.
extern "C" long long kmeans_assign_smem_bytes(int k) { return (long long)smem_bytes(k); }

// values: n f32; centers: k sorted f32 (1 <= k); idx: n int32; sums, counts:
// k f32; part_sums, part_counts: n_blocks x k scratch (f32, uint32).  The
// blocks take consecutive chunks of `chunk` values.  Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int kmeans_assign_launch(const float* values, long long n, const float* centers, int k,
                                    int32_t* idx, float* sums, float* counts, float* part_sums,
                                    uint32_t* part_counts, int n_blocks, long long chunk,
                                    void* stream) {
    if (k <= 0 || n_blocks <= 0 || chunk <= 0 || (long long)n_blocks * chunk < n)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = smem_bytes(k);
    cudaError_t err = cudaFuncSetAttribute(kmeans_assign_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kmeans_assign_kernel<<<n_blocks, kThreads, smem, s>>>(values, n, centers, k, chunk, idx,
                                                          part_sums, part_counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    kmeans_reduce_kernel<<<(k + 255) / 256, 256, 0, s>>>(part_sums, part_counts, n_blocks, k, sums,
                                                         counts);
    return (int)cudaGetLastError();
}
