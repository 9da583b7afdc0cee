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
// the sums as one-hot matmuls.  Here blocks run in parallel and in no order.
//
// What bounds it: bytes.  The full form reads each value (4 B) and writes its
// index (4 B): 13.77 GB at the full model's n of 1.72e9, 4.11 ms at
// 3.35 TB/s.  The sums-only form (mode 1, for the Lloyd loop, which never
// reads idx) reads the values alone: 2.05 ms.  At that rate an SM issues
// some 40 warp instructions for every 32 values (132 SMs, four schedulers
// each at the 1.98 GHz boost clock), so the per-value work has to be short.
//
// Design:
// - Three launches a call: a prologue kernel builds, once, the midpoints
//   (in f32 as (c[j] + c[j+1]) / 2, as the reference computes them), each
//   center's fixed-point scale, a bucket table, and zeroes the accumulators;
//   the assignment kernel; a kernel that turns the accumulators into f32.
// - A bucketed search that gives the same index, bit for bit, as a search
//   over all midpoints.  Any map f from values to buckets that never
//   decreases as v grows will do: with lo[b] the number of midpoints m with
//   f(m) < b, a value of bucket b has its index in [lo[b], lo[b + 1]], and a
//   binary search over that range alone, with the same `bounds[j] <= v`
//   compare, finds it.  The map spends its kBuckets on the 16 octaves of |v|
//   below the largest |midpoint| (256 buckets an octave and sign: the
//   exponent and top 8 mantissa bits of |v|, clamped into those octaves,
//   mirrored for negative v, -0 counted as +0), where a k-means codebook
//   keeps its centers, so most buckets hold at most one midpoint.  One
//   shared-memory load of a packed (lo[b], lo[b + 1]) pair and a compare or
//   two a value take the place of log2(k) dependent loads, whose bank
//   conflicts bounded the search.  Values beyond the extreme midpoints land
//   in buckets of an empty range.
// - Sums without float atomics and without a serial walk.  A Lloyd step
//   whose sums changed from run to run would change the codebook, then every
//   weight's index, then the served tokens.  So each value is added as a
//   64-bit integer, round(v * 2^e_c), with integer atomics: first into the
//   block's shared-memory histogram (two 32-bit words and the carry between
//   them: a 64-bit shared atomic add would be a compare-and-swap loop), then
//   into device memory.  Integer sums
//   are exact in any order, so the result is the same in every run and on
//   every card, and the one rounding left is the final conversion to f32.
//   The scale 2^e_c is a power of two with |v| * 2^e_c < 2^(62 - L) for
//   every value the center can hold, where n < 2^L: a value assigned to a
//   center lies between its two midpoints, or between the smallest value
//   and the first midpoint, or the last midpoint and the largest value (the
//   caller's `extremes`).  So the n values cannot overflow 2^62, and each is
//   rounded by at most 2^-(63 - L) of the largest |v| its center can hold:
//   2^-32 at the full model's n (L = 31), where a bf16 weight is exact
//   unless it is 2^-24 of that bound or smaller.  A finite value that the
//   extremes did not cover, and whose |v| * 2^e_c reaches 2^(62 - L), is
//   flagged on its center; where that center's sum would be finite, the
//   call reports it through `fault` and the wrapper raises.
// - Infinities and NaNs are not summed but flagged per center (an atomic
//   OR, in any order): a center that holds a NaN, or +inf and -inf, sums to
//   NaN, else one that holds an infinity to it, as an f32 sum would.
// - Counts are integers: exact past 2^24 values a center, where the TPU
//   kernel's f32 running count stops growing; the f32 result is the exact
//   count rounded once.
// - Bytes in flight: each thread loads four 16-byte vectors of values before
//   it works on any of them, and stores the indices as 16-byte vectors.
// - 64-bit offsets: n reaches 1.72e9 at full width.  A bounds check takes the
//   place of the TPU wrapper's 2 * BIG padding.
// - Shared memory: the histogram (16 B a center), scales and midpoints
//   (8 B a center) and the bucket table (32 KB): 56 KB at k = 1000, four
//   blocks to an SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                            // 16-byte vectors a thread loads at once
constexpr int kBuckets = 8192;                     // 4096 a sign
constexpr int kOctaves = 16;                       // of |v| below the largest |midpoint|
constexpr int kShift = 15;                         // 2^(23 - kShift) = 256 buckets an octave
static_assert((kOctaves << (23 - kShift)) == kBuckets / 2, "buckets of a sign");

enum Mode { kFull = 0, kStats = 1, kIdxOnly = 2 };

// Scratch in device memory, laid out by offsets of k.
struct Scratch {
    unsigned long long* acc_sum;   // k, two's complement
    unsigned long long* acc_cnt;   // k
    unsigned* acc_flag;            // k: 1 +inf, 2 -inf, 4 NaN among the values,
                                   // 8 a finite value beyond the scale's range
    float* bounds;                 // k (k - 1 used)
    float* scale;                  // k
    unsigned* table;               // kBuckets: lo[b] | lo[b + 1] << 16
    unsigned* base;                // 1: the f32 bits of |v| at the first bucket
    unsigned* fault;               // 1: nonzero when a finite sum may have overflowed
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline size_t scratch_bytes(int k) {
    return 2 * align16((size_t)k * 8) + 3 * align16((size_t)k * 4) + kBuckets * 4 + 16;
}

__host__ __device__ inline Scratch carve(void* base, int k) {
    uint8_t* p = static_cast<uint8_t*>(base);
    Scratch s;
    s.acc_sum = reinterpret_cast<unsigned long long*>(p);
    p += align16((size_t)k * 8);
    s.acc_cnt = reinterpret_cast<unsigned long long*>(p);
    p += align16((size_t)k * 8);
    s.acc_flag = reinterpret_cast<unsigned*>(p);
    p += align16((size_t)k * 4);
    s.bounds = reinterpret_cast<float*>(p);
    p += align16((size_t)k * 4);
    s.scale = reinterpret_cast<float*>(p);
    p += align16((size_t)k * 4);
    s.table = reinterpret_cast<unsigned*>(p);
    p += kBuckets * 4;
    s.base = reinterpret_cast<unsigned*>(p);
    return s;
}

size_t smem_bytes(int k, int mode) {
    size_t b = align16((size_t)k * 4) + kBuckets * 4;               // bounds, table
    if (mode != kIdxOnly) b += 5 * align16((size_t)k * 4);     // hlo, hhi, hcnt, hflag, scale
    return b;
}

__device__ __forceinline__ float midpoint(const float* __restrict__ c, int j) {
    return __fdiv_rn(__fadd_rn(c[j], c[j + 1]), 2.f);
}

// f32 bits of |v| at the first bucket: kOctaves octaves below the power of
// two above the largest |midpoint| (the midpoints are sorted: an end's)
__device__ __forceinline__ unsigned bucket_base(const float* __restrict__ c, int k) {
    int ex = 0;
    if (k > 1) {
        const float hi = fmaxf(fabsf(midpoint(c, 0)), fabsf(midpoint(c, k - 2)));
        if (hi > 0.f && isfinite(hi)) frexpf(hi, &ex);             // hi < 2^ex
    }
    const int top = min(max(ex + 127, kOctaves), 255);             // biased exponent
    return (unsigned)(top - kOctaves) << 23;
}

// the bucket of v: never decreasing as v grows (-0 counts as +0)
__device__ __forceinline__ int bucket_of(float v, unsigned base) {
    const unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
    const unsigned a = min(max(u & 0x7fffffffu, base), base + ((unsigned)kOctaves << 23) - 1u);
    const int g = (int)((a - base) >> kShift);
    return (u >> 31) ? kBuckets / 2 - 1 - g : kBuckets / 2 + g;
}

// number of midpoints whose bucket lies below b
__device__ __forceinline__ int below(const float* __restrict__ c, int k, unsigned base, int b) {
    int lo = 0, len = k - 1;
    while (len > 0) {
        const int half = len >> 1;
        if (bucket_of(midpoint(c, lo + half), base) < b) {
            lo += half + 1;
            len -= half + 1;
        } else {
            len = half;
        }
    }
    return lo;
}

// One thread per entry: midpoints, scales, accumulators, bucket table.
__global__ void kmeans_prologue_kernel(const float* __restrict__ centers, int k,
                                       const float* __restrict__ extremes, int room, Scratch s) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int m = k - 1;
    if (t < k) {
        s.acc_sum[t] = 0ull;
        s.acc_cnt[t] = 0ull;
        s.acc_flag[t] = 0u;
        s.bounds[t] = t < m ? midpoint(centers, t) : 0.f;
        // the center's values lie in [below, above]
        const float below = t > 0 ? midpoint(centers, t - 1) : extremes[0];
        const float above = t < m ? midpoint(centers, t) : extremes[1];
        const float hi = fmaxf(fabsf(below), fabsf(above));
        int ex = 0;
        if (hi > 0.f && isfinite(hi)) frexpf(hi, &ex);             // hi < 2^ex
        s.scale[t] = ldexpf(1.f, min(max(room - ex, -126), 126));
    }
    if (t < kBuckets) {
        const unsigned base = bucket_base(centers, k);
        if (t == 0) {
            *s.base = base;
            *s.fault = 0u;
        }
        s.table[t] = (unsigned)below(centers, k, base, t) |
                     ((unsigned)below(centers, k, base, t + 1) << 16);
    }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 4)
kmeans_assign_kernel(const float* __restrict__ values, long long n, int k, long long chunk,
                     float lim, Scratch g, int32_t* __restrict__ idx) {
    constexpr bool kHist = kMode != kIdxOnly, kIdx = kMode != kStats;
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* p = smem;
    unsigned* hlo = nullptr;                  // the block's sums: hhi * 2^32 + hlo
    unsigned* hhi = nullptr;
    unsigned* hcnt = nullptr;
    unsigned* hflag = nullptr;
    float* scale = nullptr;
    if constexpr (kHist) {
        hlo = reinterpret_cast<unsigned*>(p);
        p += align16((size_t)k * 4);
        hhi = reinterpret_cast<unsigned*>(p);
        p += align16((size_t)k * 4);
        hcnt = reinterpret_cast<unsigned*>(p);
        p += align16((size_t)k * 4);
        hflag = reinterpret_cast<unsigned*>(p);
        p += align16((size_t)k * 4);
        scale = reinterpret_cast<float*>(p);
        p += align16((size_t)k * 4);
    }
    float* bounds = reinterpret_cast<float*>(p);
    p += align16((size_t)k * 4);
    unsigned* table = reinterpret_cast<unsigned*>(p);
    __shared__ int max_len;

    const int tid = threadIdx.x;
    if (tid == 0) max_len = 0;
    for (int j = tid; j < k; j += kThreads) {
        bounds[j] = g.bounds[j];
        if constexpr (kHist) {
            scale[j] = g.scale[j];
            hlo[j] = 0u;
            hhi[j] = 0u;
            hcnt[j] = 0u;
            hflag[j] = 0u;
        }
    }
    int longest = 0;
    for (int b = tid; b < kBuckets; b += kThreads) {
        const unsigned e = g.table[b];
        table[b] = e;
        longest = max(longest, (int)(e >> 16) - (int)(e & 0xffffu));
    }
    const unsigned base = *g.base;
    longest = __reduce_max_sync(0xffffffffu, longest);
    __syncthreads();                          // max_len is 0 before any atomicMax
    if ((tid & 31) == 0) atomicMax(&max_len, longest);
    __syncthreads();
    int top = 1;                              // largest power of two <= max_len (0 when 0)
    while (top <= max_len) top <<= 1;
    top >>= 1;

    auto assign = [&](float v) -> int {
        const unsigned e = table[bucket_of(v, base)];
        int pos = (int)(e & 0xffffu), len = (int)(e >> 16) - pos;
        for (int st = top; st > 0; st >>= 1) {
            if (st <= len) {
                const bool ge = bounds[pos + st - 1] <= v;
                pos = ge ? pos + st : pos;
                len = ge ? len - st : st - 1;
            }
        }
        if constexpr (kHist) {
            // a 64-bit add as two native 32-bit atomics (a 64-bit shared
            // atomic add compiles to a compare-and-swap loop): the low
            // word's old value says whether this add carries
            if (isfinite(v)) {
                const float x = __fmul_rn(v, scale[pos]);       // exact: a power of two
                if (fabsf(x) >= lim) atomicOr(&hflag[pos], 8u);
                const long long q = __float2ll_rn(x);
                const unsigned ql = (unsigned)q;
                const unsigned old = atomicAdd(&hlo[pos], ql);
                atomicAdd(&hhi[pos], (unsigned)(q >> 32) + (old + ql < old ? 1u : 0u));
            } else {
                atomicOr(&hflag[pos], isnan(v) ? 4u : v > 0.f ? 1u : 2u);
            }
            atomicAdd(&hcnt[pos], 1u);
        }
        return pos;
    };

    const long long begin = (long long)blockIdx.x * chunk;
    const long long end = begin + chunk < n ? begin + chunk : n;
    // whole 16-byte vectors: begin is a multiple of 4 (chunk is) and values
    // 16-byte aligned (the wrapper's check)
    const long long v0 = begin >> 2, v1 = end >> 2;
    const float4* vals4 = reinterpret_cast<const float4*>(values);
    int4* idx4 = reinterpret_cast<int4*>(idx);
    for (long long base = v0 + tid; base < v1; base += (long long)kVec * kThreads) {
        float4 r[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
            const long long i = base + (long long)u * kThreads;
            if (i < v1) r[u] = __ldcs(vals4 + i);
        }
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
            const long long i = base + (long long)u * kThreads;
            if (i < v1) {
                int4 o;
                o.x = assign(r[u].x);
                o.y = assign(r[u].y);
                o.z = assign(r[u].z);
                o.w = assign(r[u].w);
                if constexpr (kIdx) __stcs(idx4 + i, o);
            }
        }
    }
    for (long long i = (v1 << 2) + tid; i < end; i += kThreads) {      // at most 3 values
        const int pos = assign(values[i]);
        if constexpr (kIdx) idx[i] = pos;
    }

    if constexpr (kHist) {
        __syncthreads();
        for (int c = tid; c < k; c += kThreads) {
            if (hcnt[c] != 0u) {
                atomicAdd(&g.acc_sum[c], ((unsigned long long)hhi[c] << 32) | hlo[c]);
                atomicAdd(&g.acc_cnt[c], (unsigned long long)hcnt[c]);
                if (hflag[c] != 0u) atomicOr(&g.acc_flag[c], hflag[c]);
            }
        }
    }
}

__global__ void kmeans_finish_kernel(Scratch g, int k, float* __restrict__ sums,
                                     float* __restrict__ counts) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= k) return;
    // the integer sum rounded once; the power-of-two scale divides exactly
    float sum = __fmul_rn(__ll2float_rn((long long)g.acc_sum[c]), __frcp_rn(g.scale[c]));
    const unsigned f = g.acc_flag[c];
    if (f & 4u || (f & 3u) == 3u) {
        sum = __int_as_float(0x7fffffff);
    } else if (f & 3u) {
        sum = f & 1u ? __int_as_float(0x7f800000) : __int_as_float((int)0xff800000u);
    } else if (f & 8u) {                    // a finite sum that may have overflowed
        sum = __int_as_float(0x7fffffff);
        atomicOr(g.fault, 1u);
    }
    sums[c] = sum;
    counts[c] = __ull2float_rn(g.acc_cnt[c]);
}

template <int kMode>
cudaError_t run(const float* values, long long n, int k, float lim, Scratch g, int32_t* idx,
                int n_blocks, long long chunk, cudaStream_t s) {
    const size_t smem = smem_bytes(k, kMode);
    cudaError_t e = csrc::allow_smem(kmeans_assign_kernel<kMode>, smem);
    if (e != cudaSuccess) return e;
    kmeans_assign_kernel<kMode><<<n_blocks, kThreads, smem, s>>>(values, n, k, chunk, lim, g,
                                                                  idx);
    return cudaGetLastError();
}

}  // namespace

// Bytes of device scratch a call needs for k centers (16-byte aligned base).
extern "C" long long kmeans_assign_scratch_bytes(int k) { return (long long)scratch_bytes(k); }

// values: n f32, 16-byte aligned, n < 2^32; centers: k sorted f32
// (1 <= k <= 65535); extremes: two f32 on the card, lo <= every finite value
// <= hi (a finite value beyond them sets *fault where its center's sum
// could overflow; the infinities are summed by flag and need no cover);
// mode: 0 full (idx, sums, counts), 1 sums and counts only (idx unused),
// 2 idx only (sums, counts unused: the search alone, for timing).  idx: n
// int32; sums, counts: k f32; scratch: kmeans_assign_scratch_bytes(k);
// fault: one uint32, nonzero after the call when a center's sum is not to
// be trusted (full and sums-only forms; that center's sum is NaN).  The
// blocks take consecutive chunks of `chunk` values, a multiple of 4.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int kmeans_assign_launch(const float* values, long long n, const float* centers, int k,
                                    const float* extremes, int mode, int32_t* idx, float* sums,
                                    float* counts, void* scratch, unsigned* fault, int n_blocks,
                                    long long chunk, void* stream) {
    if (k <= 0 || k > 65535 || n < 0 || n >= (1ll << 32) || n_blocks <= 0 || chunk <= 0 ||
        chunk % 4 != 0 || (long long)n_blocks * chunk < n || mode < 0 || mode > 2 ||
        (reinterpret_cast<uintptr_t>(values) & 15) != 0 ||
        (reinterpret_cast<uintptr_t>(scratch) & 15) != 0 || fault == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Scratch g = carve(scratch, k);
    g.fault = fault;
    int bits = 1;                                       // n < 2^bits
    while (bits < 63 && (n >> bits) != 0) ++bits;
    const int prologue = (k > kBuckets ? k : kBuckets);
    const int room = 62 - bits;                         // |v| * 2^e_c < 2^room
    const float lim = ldexpf(1.f, room);
    kmeans_prologue_kernel<<<(prologue + 255) / 256, 256, 0, s>>>(centers, k, extremes, room, g);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (mode == kFull)
        e = run<kFull>(values, n, k, lim, g, idx, n_blocks, chunk, s);
    else if (mode == kStats)
        e = run<kStats>(values, n, k, lim, g, idx, n_blocks, chunk, s);
    else
        e = run<kIdxOnly>(values, n, k, lim, g, idx, n_blocks, chunk, s);
    if (e != cudaSuccess || mode == kIdxOnly) return (int)e;
    kmeans_finish_kernel<<<(k + 255) / 256, 256, 0, s>>>(g, k, sums, counts);
    return (int)cudaGetLastError();
}
