// codebook_matmul for Hopper (sm_90a):  out[M,N] (f32) = x[M,K] @ codebook[canon(w_idx[K,N])]
//
// Replaces repro/kernels/codebook_matmul.py::codebook_matmul_kernel (the
// Pallas TPU kernel).  Weights stay narrow integer ids in device memory
// (int8 for |W| <= 256, int16 up to 65536, int32 beyond) and are dequantized
// on chip through a codebook held in shared memory.
//
// What bounds it: at the decode shapes of the serving path (M = 1..4 rows)
// the kernel must stream the K x N id matrix once and does 2 flops per id and
// row, so it is bound by device-memory bytes, and the ids are the bytes.  At
// prefill shapes (M = 32..256) the same ids feed more rows and the FMA pipe
// starts to matter.
//
// What the design does about that: every id is read from device memory once
// per row tile (the row tile covers all of M at decode), converted in shared
// memory, and reused from there by every row of the tile.  Few output tiles
// exist at small M, so K is split across blockIdx.z to put enough blocks on
// the 132 SMs; each split writes its own partial plane and a second kernel
// sums the planes in split order, so the result does not depend on
// scheduling.  This is a plain FMA tile kernel; wgmma/TMA come later.
//
// Numerics: each codebook entry is rounded to x's dtype before the product
// (codebook_matmul.py casts w to x.dtype), products and sums are f32.  For
// bf16 x the products are exact in f32, so the result differs from the
// reference only in summation order.  Negative ids are canonicalized
// (id < 0 -> id + |W|) and clamped into the codebook; the ragged K tail is
// masked on both operands.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;                    // output columns per block (one per thread column)
constexpr int kBK = 32;                    // K depth of one shared-memory stage
constexpr int kRowGroups = kThreads / kBN; // 4 thread rows

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// codebook entry rounded to x's dtype (round to nearest even, as XLA converts)
__device__ __forceinline__ float as_x_dtype(float v, const float*) { return v; }
__device__ __forceinline__ float as_x_dtype(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename XT, typename IT, int BM>
__global__ void __launch_bounds__(kThreads)
codebook_matmul_kernel(const XT* __restrict__ x, const IT* __restrict__ w_idx,
                       const float* __restrict__ codebook, float* __restrict__ out,
                       int M, int K, int N, int n_book, int k_chunk) {
    constexpr int RPT = BM / kRowGroups;   // rows per thread
    extern __shared__ float book_s[];      // n_book entries, already in x's dtype
    __shared__ float xs[kBK][BM];
    __shared__ float ws[kBK][kBN];

    const int tid = threadIdx.x;
    const int tx = tid % kBN, ty = tid / kBN;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
    const int k_begin = blockIdx.z * k_chunk;
    const int k_end = min(K, k_begin + k_chunk);

    for (int i = tid; i < n_book; i += kThreads) book_s[i] = as_x_dtype(codebook[i], x);
    __syncthreads();

    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

    for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
        for (int i = tid; i < BM * kBK; i += kThreads) {
            const int mm = i / kBK, kk = i % kBK;
            const int m = m0 + mm, k = k0 + kk;
            xs[kk][mm] = (m < M && k < k_end) ? load_x(x + (size_t)m * K + k) : 0.f;
        }
        for (int i = tid; i < kBK * kBN; i += kThreads) {
            const int kk = i / kBN, nn = i % kBN;
            const int k = k0 + kk, n = n0 + nn;
            float w = 0.f;
            if (k < k_end && n < N) {
                int id = (int)w_idx[(size_t)k * N + n];
                if (id < 0) id += n_book;
                id = min(max(id, 0), n_book - 1);
                w = book_s[id];
            }
            ws[kk][nn] = w;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
            const float w = ws[kk][tx];
#pragma unroll
            for (int r = 0; r < RPT; ++r) acc[r] = fmaf(xs[kk][ty * RPT + r], w, acc[r]);
        }
        __syncthreads();
    }

    float* dst = out + (size_t)blockIdx.z * M * N;
    const int n = n0 + tx;
    if (n < N) {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int m = m0 + ty * RPT + r;
            if (m < M) dst[(size_t)m * N + n] = acc[r];
        }
    }
}

template <typename XT>
cudaError_t launch(const void* x, int idx_bytes, const void* w_idx, const float* codebook,
                   float* dst, int M, int K, int N, int n_book, int bm, int splits,
                   int k_chunk, cudaStream_t stream) {
    return csrc::with_id_type(idx_bytes, [&](auto id) {
        using IT = decltype(id);
        return csrc::with_rows_per_block(bm, [&](auto rows) {
            constexpr int BM = decltype(rows)::value;
            auto kernel = codebook_matmul_kernel<XT, IT, BM>;
            const size_t smem = (size_t)n_book * sizeof(float);
            // static tiles take 16 KB at BM = 64; past 48 KB in all the
            // dynamic part needs the opt-in
            if (smem > 32 * 1024) {
                cudaError_t e = cudaFuncSetAttribute(
                    kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
                if (e != cudaSuccess) return e;
            }
            dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
            kernel<<<grid, kThreads, smem, stream>>>(static_cast<const XT*>(x),
                                                     static_cast<const IT*>(w_idx), codebook,
                                                     dst, M, K, N, n_book, k_chunk);
            return cudaGetLastError();
        });
    });
}

}  // namespace

// x_is_bf16: 0 = f32 x, 1 = bf16 x.  idx_bytes: 1, 2 or 4.  bm: rows per block (4, 16, 64).
// partial: (splits, M, N) f32 scratch when splits > 1, else unused (may be null).
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int codebook_matmul_launch(const void* x, int x_is_bf16, const void* w_idx,
                                      int idx_bytes, const float* codebook, int n_book,
                                      float* out, float* partial, int M, int K, int N,
                                      int bm, int splits, int k_chunk, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* dst = splits > 1 ? partial : out;
    cudaError_t e = x_is_bf16
        ? launch<__nv_bfloat16>(x, idx_bytes, w_idx, codebook, dst, M, K, N, n_book, bm, splits, k_chunk, s)
        : launch<float>(x, idx_bytes, w_idx, codebook, dst, M, K, N, n_book, bm, splits, k_chunk, s);
    if (e == cudaSuccess && splits > 1) e = csrc::sum_splits(partial, out, splits, (size_t)M * N, s);
    return (int)e;
}
