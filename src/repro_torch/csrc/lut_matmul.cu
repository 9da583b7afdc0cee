// lut_matmul for Hopper (sm_90a):  acc[m,n] = sum_k T[a_scaled[m,k] + canon(w_idx[k,n])]  (int32, wrapping)
//
// Replaces repro/kernels/lut_matmul.py::lut_matmul_kernel (the Pallas TPU
// kernel), the paper's §4 engine: both operands are indices, the product is a
// lookup in the multiplication table T (flattened, row index pre-scaled by the
// column count C in the wrapper), and the contraction is integer adds only.
// Tensor cores do no work here.
//
// What bounds it: every (m, k, n) term is a dependent 4-byte lookup at a
// data-dependent address.  The table of one layer (|A| x |W| = 4096 x 1000
// int32 = 16 MB on the serving path) does not fit in the 227 KB of shared
// memory a block may use, so lookups go through L2 (50 MB on the card, which
// holds the table of the layer being run).  The ids themselves must still be
// streamed from device memory once, so the floor is the id bytes; in practice
// the L2 lookup rate is the limit.
//
// What the design does about that: index tiles (a_scaled and canonical w) are
// staged in shared memory, so every device-memory read of an id is shared by
// all rows (for w) or columns (for a) of the block's tile; each thread owns
// one output column and a few rows, and its lookups for one k hit one table
// row of 4 KB (neighbouring threads, neighbouring w ids), read through the
// read-only cache path (__ldg).  K is split across blockIdx.z when there are
// few output tiles; the partial planes are summed by a second kernel.
//
// Numerics: accumulation is in uint32_t, so wrap-around is defined behaviour,
// and the result is reinterpreted as int32: bit-exact with the reference,
// whatever the order of the adds.  Addresses are computed in wrapping 32-bit
// arithmetic and clamped into the table, as the Pallas kernel does; the K
// tail is masked.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kRowGroups = kThreads / kBN;

template <typename IT, int BM>
__global__ void __launch_bounds__(kThreads)
lut_matmul_kernel(const int32_t* __restrict__ a_scaled, const IT* __restrict__ w_idx,
                  const int32_t* __restrict__ table, uint32_t* __restrict__ out,
                  int M, int K, int N, int n_cols, int table_size, int k_chunk) {
    constexpr int RPT = BM / kRowGroups;
    __shared__ int32_t as[kBK][BM];
    __shared__ int32_t ws[kBK][kBN];

    const int tid = threadIdx.x;
    const int tx = tid % kBN, ty = tid / kBN;
    const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
    const int k_begin = blockIdx.z * k_chunk;
    const int k_end = min(K, k_begin + k_chunk);

    uint32_t acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0u;

    for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
        for (int i = tid; i < BM * kBK; i += kThreads) {
            const int mm = i / kBK, kk = i % kBK;
            const int m = m0 + mm, k = k0 + kk;
            as[kk][mm] = (m < M && k < k_end) ? a_scaled[(size_t)m * K + k] : 0;
        }
        for (int i = tid; i < kBK * kBN; i += kThreads) {
            const int kk = i / kBN, nn = i % kBN;
            const int k = k0 + kk, n = n0 + nn;
            int id = 0;
            if (k < k_end && n < N) {
                id = (int)w_idx[(size_t)k * N + n];
                if (id < 0) id += n_cols;
            }
            ws[kk][nn] = id;
        }
        __syncthreads();
        const int kmax = min(kBK, k_end - k0);   // K tail: masked terms are skipped
        for (int kk = 0; kk < kmax; ++kk) {
            const uint32_t w = (uint32_t)ws[kk][tx];
#pragma unroll
            for (int r = 0; r < RPT; ++r) {
                int addr = (int)((uint32_t)as[kk][ty * RPT + r] + w);
                addr = min(max(addr, 0), table_size - 1);
                acc[r] += (uint32_t)__ldg(table + addr);
            }
        }
        __syncthreads();
    }

    uint32_t* dst = out + (size_t)blockIdx.z * M * N;
    const int n = n0 + tx;
    if (n < N) {
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
            const int m = m0 + ty * RPT + r;
            if (m < M) dst[(size_t)m * N + n] = acc[r];
        }
    }
}

}  // namespace

// a_scaled: (M, K) int32, canonical row ids already multiplied by n_cols.
// w_idx: (K, N) int8/int16/int32 (idx_bytes 1, 2, 4).  table: (R * n_cols) int32.
// out: (M, N) int32.  partial: (splits, M, N) int32 scratch when splits > 1.
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int lut_matmul_launch(const int32_t* a_scaled, const void* w_idx, int idx_bytes,
                                 const int32_t* table, int n_cols, int table_size,
                                 int32_t* out, int32_t* partial, int M, int K, int N,
                                 int bm, int splits, int k_chunk, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint32_t* dst = reinterpret_cast<uint32_t*>(splits > 1 ? partial : out);
    cudaError_t e = csrc::with_id_type(idx_bytes, [&](auto id) {
        using IT = decltype(id);
        return csrc::with_rows_per_block(bm, [&](auto rows) {
            constexpr int BM = decltype(rows)::value;
            dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
            lut_matmul_kernel<IT, BM><<<grid, kThreads, 0, s>>>(
                a_scaled, static_cast<const IT*>(w_idx), table, dst, M, K, N, n_cols,
                table_size, k_chunk);
            return cudaGetLastError();
        });
    });
    if (e == cudaSuccess && splits > 1)
        e = csrc::sum_splits(reinterpret_cast<const uint32_t*>(partial),
                             reinterpret_cast<uint32_t*>(out), splits, (size_t)M * N, s);
    return (int)e;
}
