// lut_matmul for Hopper (sm_90a):  acc[m,n] = sum_k T[a[m,k]·C + canon(w_idx[k,n])]  (int32, wrapping)
//
// Replaces repro/kernels/lut_matmul.py::lut_matmul_kernel (the Pallas TPU
// kernel), the paper's §4 engine: both operands are indices, the product is a
// lookup in the multiplication table T (flattened; the row id is
// canonicalized and scaled by the column count C here, in wrapping int32, as
// lut_matmul_pallas does before its kernel), and the contraction is integer
// adds only.  Tensor cores do no work here.
//
// What bounds it.  One layer's table (|A| x |W| = 4096 x 1000 int32 = 16.4 MB
// on the serving path) does not fit in shared memory.  Looked up term by term
// through L2, as the first version of this kernel did, a warp's 32 lookups
// fall in one 4000-byte row and touch some 28 distinct 32-byte sectors: about
// 28 bytes of L2 traffic per 4-byte term, and the kernel was bound by L2
// sectors.  This version copies the rows a block needs into shared memory
// once and is bound by shared-memory lookups (random words of a row, a few
// bank conflicts each), with the row copies and the id stream beside them.
//
// Two routes, picked by kernels/_common.py::lut_plan:
//
// * smem (tables whose rows fit a ring of at least two stages): a block
//   owns BM rows of a (4, or 16 beyond M = 4) and up to 6144 columns, so each
//   staged row serves them all, and one k a ring stage.  The rows
//   T[a[m,k], 0:C] that lie in the table come in bulk (TMA) copies, one
//   thread a row, counted on the stage's mbarrier (C % 4 == 0 and an aligned
//   table); other rows are copied word by word with clamped addresses.  The
//   split's row ids are staged in shared memory up front, so no copy waits
//   on a dependent load.  Each thread loads its 16 bytes of ids of a row
//   straight into registers, four rows ahead, and takes its terms from the
//   staged rows.  A term whose canonical w lies outside [0, C) reads the flat
//   address from device memory, clamped, as the first version did, so the
//   flat-address semantics hold for every id.
// * l2: the first version's tile, every lookup through L2, for rows too
//   long to stage, for rows off 16-byte boundaries (the smem route would
//   copy those word by word, every k: the §4 engine's |W| + 1 columns),
//   and, at M <= 4, for sites of at most 1024 columns, where a staged row
//   serves too few columns to pay for its copy.
//
// K is split across blocks to fill the card.  uint32 sums wrap the same in
// any order, so the splits add their parts with integer atomics into a
// zeroed accumulator the wrapper keeps; the block that arrives last on the
// tile's counter copies the tile out and zeroes it again (common.cuh), all
// in one launch.
//
// Numerics: accumulation is in uint32_t, so wrap-around is defined behaviour,
// and the result is reinterpreted as int32: bit-exact with the reference,
// whatever the order of the adds.  Addresses are computed in wrapping 32-bit
// arithmetic and clamped into the table, as the Pallas kernel does; the K
// tail is masked.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "common.cuh"

namespace {

// the Pallas wrapper's a_scaled: canonical row id times C, in wrapping int32
__device__ __forceinline__ int scaled_row(int a, int n_rows, int C) {
    if (a < 0) a += n_rows;
    return (int)((uint32_t)a * (uint32_t)C);
}

__device__ __forceinline__ int flat_addr(int a, int w, int table_size) {
    const int addr = (int)((uint32_t)a + (uint32_t)w);
    return min(max(addr, 0), table_size - 1);
}

// The block's part of its tile: written out when K is not split; else added
// with integer atomics into the zeroed accumulator, and the block that
// arrives last copies the tile out and zeroes it again.
__device__ __forceinline__ void finish_tile(const uint32_t* __restrict__ part, int n_part,
                                            uint32_t* __restrict__ out,
                                            uint32_t* __restrict__ acc_g,
                                            unsigned* __restrict__ counters, int splits, int m0,
                                            int rows, int n0, int cols, int N) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    for (int i = threadIdx.x; i < rows * n_part; i += blockDim.x) {
        const int m = i / n_part, c = i - m * n_part;
        if (c >= cols) continue;
        const size_t e = (size_t)(m0 + m) * N + n0 + c;
        if (splits == 1) out[e] = part[i];
        else atomicAdd(acc_g + e, part[i]);
    }
    if (splits > 1 && csrc::arrive_last(counters + tile, splits)) {
        for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
            const int m = i / cols, c = i - m * cols;
            const size_t e = (size_t)(m0 + m) * N + n0 + c;
            out[e] = __ldcg(acc_g + e);
            acc_g[e] = 0u;
        }
    }
}

// ------------------------------------------------------------------ smem route

template <typename IT, int BM>
struct Lut {
    static constexpr int kVecIds = 16 / (int)sizeof(IT);
    static constexpr int VEC = kVecIds < 128 / BM ? kVecIds : 128 / BM;     // columns a thread
    static constexpr int kRegThreads = 65536 / (BM * VEC + 40) / 32 * 32;
    static constexpr int MAX_THREADS = kRegThreads < 1024 ? kRegThreads : 1024;
};

constexpr int kMaxStages = 8;

// one ring stage: BM table rows of c_stride words
struct StageLayout {
    size_t bytes;
    __host__ __device__ StageLayout(int bm, int c_stride) { bytes = (size_t)bm * c_stride * 4; }
};

// where the split's row ids start: after the ring and the block's sums
__host__ __device__ inline size_t lut_a_offset(int stages, size_t stage_bytes, int bm, int bn) {
    const size_t ring = (size_t)stages * stage_bytes, sums = (size_t)bm * bn * 4;
    return ((ring > sums ? ring : sums) + 15) & ~(size_t)15;
}

// Stage i of the ring: bulk copies of the rows that lie in the table, one
// thread a row so they go out together (thread 0 also tells the stage's
// barrier how many bytes will land); every thread copies its share of the
// other rows, clamped word by word.
__device__ __noinline__ void stage_rows(unsigned char* lsm, size_t stage_bytes, int stages, int i,
                                        const int* a_blk, int bm, int rows, int tid, int nt,
                                        const int32_t* __restrict__ table, int table_size, int C,
                                        int c_stride, int row_vec_ok, uint64_t* bars) {
    uint32_t* rows_s = reinterpret_cast<uint32_t*>(lsm + (size_t)(i % stages) * stage_bytes);
    const int* a_s = a_blk + i * bm;
    uint64_t* bar = &bars[i % stages];
    auto in_table = [&](int a) { return row_vec_ok && a >= 0 && a <= table_size - C; };
    if (tid == 0) {
        unsigned bytes = 0u;
        for (int m = 0; m < rows; ++m)
            if (in_table(a_s[m])) bytes += C * 4;
        csrc::mbar_expect_tx(bar, bytes);
    }
    if (tid < rows && in_table(a_s[tid])) {
        csrc::fence_proxy_async();
        csrc::bulk_copy(rows_s + tid * c_stride, table + a_s[tid], C * 4, bar);
    }
    for (int m = 0; m < rows; ++m) {
        const int a = a_s[m];
        if (in_table(a)) continue;
        for (int c = tid; c < C; c += nt)
            rows_s[m * c_stride + c] = (uint32_t)table[flat_addr(a, c, table_size)];
    }
}

// this thread's VEC ids of row k_begin + i, zeros past the split
template <typename IT, int VEC>
__device__ __forceinline__ uint4 row_ids(const IT* __restrict__ w_idx, int k_begin, int i, int kn,
                                         int N, int col, bool full) {
    if (i >= kn) return make_uint4(0u, 0u, 0u, 0u);
    return csrc::load_ids<IT, VEC>(w_idx + (size_t)(k_begin + i) * N + col, col, N, full);
}

template <typename IT, int BM>
__global__ void __launch_bounds__(Lut<IT, BM>::MAX_THREADS)
lut_smem_kernel(const int32_t* __restrict__ a_idx, const IT* __restrict__ w_idx,
                const int32_t* __restrict__ table, uint32_t* __restrict__ out,
                uint32_t* __restrict__ acc_g, unsigned* __restrict__ counters, int M, int K,
                int N, int n_rows, int C, int c_stride, int table_size, int k_chunk, int stages,
                int vec_ok, int row_vec_ok) {
    constexpr int VEC = Lut<IT, BM>::VEC;
    extern __shared__ __align__(16) unsigned char lsm[];
    __shared__ __align__(8) uint64_t bars[kMaxStages];   // one per ring stage
    const int NT = blockDim.x, tid = threadIdx.x, BN = NT * VEC;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, col = n0 + tid * VEC;
    const int k_begin = blockIdx.z * k_chunk, k_end = min(K, k_begin + k_chunk);
    const int kn = max(0, k_end - k_begin);
    const int rows = min(BM, M - m0);
    const StageLayout L(BM, c_stride);
    // the split's scaled row ids [k][BM], after the ring (or the sums that
    // reuse it at the end)
    int* a_blk = reinterpret_cast<int*>(lsm + lut_a_offset(stages, L.bytes, BM, BN));
    const bool full = vec_ok && col + VEC <= N;
    const int32_t* a_row = a_idx + (size_t)m0 * K + k_begin;

    // the split's row ids first, eight loads in flight a thread, so no
    // copy waits on a dependent load
    constexpr int AB = 8;
    for (int t0 = tid; t0 < rows * kn; t0 += NT * AB) {
        int v[AB];
#pragma unroll
        for (int u = 0; u < AB; ++u) {
            const int t = t0 + u * NT, m = t / max(kn, 1), kk = t - m * kn;
            v[u] = t < rows * kn ? __ldg(a_row + (size_t)m * K + kk) : 0;
        }
#pragma unroll
        for (int u = 0; u < AB; ++u) {
            const int t = t0 + u * NT, m = t / max(kn, 1), kk = t - m * kn;
            if (t < rows * kn) a_blk[kk * BM + m] = scaled_row(v[u], n_rows, C);
        }
    }
    if (tid == 0) {
        for (int st = 0; st < stages; ++st) csrc::mbar_init(&bars[st], 1);
        csrc::mbar_fence_init();
    }
    __syncthreads();
    for (int st = 0; st < stages - 1 && st < kn; ++st) stage_rows(lsm, L.bytes, stages, st, a_blk, BM, rows, tid, NT, table, table_size, C, c_stride, row_vec_ok, bars);

    uint32_t acc[BM][VEC];
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[m][j] = 0u;

    // four rows of ids in flight a thread, in registers that take turns
    constexpr int Q = 4;
    uint4 q[Q];
#pragma unroll
    for (int u = 0; u < Q; ++u) q[u] = row_ids<IT, VEC>(w_idx, k_begin, u, kn, N, col, full);
    for (int i0 = 0; i0 < kn; i0 += Q) {
#pragma unroll
        for (int u = 0; u < Q; ++u) {
            const int i = i0 + u;
            if (i >= kn) continue;
            csrc::mbar_wait(&bars[i % stages], (unsigned)(i / stages) & 1u);
            __syncthreads();         // stage i is complete; stage i - 1 is consumed
            if (i + stages - 1 < kn)
                stage_rows(lsm, L.bytes, stages, i + stages - 1, a_blk, BM, rows, tid, NT, table,
                           table_size, C, c_stride, row_vec_ok, bars);

            const uint32_t* rows_s =
                reinterpret_cast<const uint32_t*>(lsm + (size_t)(i % stages) * L.bytes);
            IT ids[VEC];
            memcpy(ids, &q[u], sizeof(ids));
            q[u] = row_ids<IT, VEC>(w_idx, k_begin, i + Q, kn, N, col, full);
            int av[BM];
#pragma unroll
            for (int m = 0; m < BM; ++m) av[m] = m < rows ? a_blk[i * BM + m] : 0;
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
                int w = (int)ids[j];
                if (w < 0) w += C;
                if ((unsigned)w < (unsigned)C) {         // in the staged row
#pragma unroll
                    for (int m = 0; m < BM; ++m)
                        if (m < rows) acc[m][j] += rows_s[m * c_stride + w];
                } else {                                  // another row: the flat address
#pragma unroll
                    for (int m = 0; m < BM; ++m)
                        if (m < rows)
                            acc[m][j] += (uint32_t)__ldg(table + flat_addr(av[m], w, table_size));
                }
            }
        }
    }
    __syncthreads();                 // the ring is free: stage the block's sums there

    uint32_t* red = reinterpret_cast<uint32_t*>(lsm);    // [rows][BN]
#pragma unroll
    for (int m = 0; m < BM; ++m)
        if (m < rows)
#pragma unroll
            for (int j = 0; j < VEC; ++j) red[m * BN + tid * VEC + j] = acc[m][j];
    __syncthreads();
    finish_tile(red, BN, out, acc_g, counters, gridDim.z, m0, rows, n0, min(BN, N - n0), N);
}

// -------------------------------------------------------------------- l2 route

constexpr int kL2Threads = 256;
constexpr int kL2BN = 64;
constexpr int kL2BK = 32;
constexpr int kRowGroups = kL2Threads / kL2BN;

template <typename IT, int BM>
__global__ void __launch_bounds__(kL2Threads)
lut_l2_kernel(const int32_t* __restrict__ a_idx, const IT* __restrict__ w_idx,
              const int32_t* __restrict__ table, uint32_t* __restrict__ out,
              uint32_t* __restrict__ acc_g, unsigned* __restrict__ counters, int M, int K, int N,
              int n_rows, int n_cols, int table_size, int k_chunk) {
    constexpr int RPT = BM / kRowGroups;
    __shared__ int32_t as[kL2BK][BM];
    __shared__ int32_t ws[kL2BK][kL2BN];
    __shared__ uint32_t red[BM * kL2BN];

    const int tid = threadIdx.x;
    const int tx = tid % kL2BN, ty = tid / kL2BN;
    const int n0 = blockIdx.x * kL2BN, m0 = blockIdx.y * BM;
    const int k_begin = blockIdx.z * k_chunk;
    const int k_end = min(K, k_begin + k_chunk);

    uint32_t acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0u;

    for (int k0 = k_begin; k0 < k_end; k0 += kL2BK) {
        for (int i = tid; i < BM * kL2BK; i += kL2Threads) {
            const int mm = i / kL2BK, kk = i % kL2BK;
            const int m = m0 + mm, k = k0 + kk;
            as[kk][mm] =
                (m < M && k < k_end) ? scaled_row(a_idx[(size_t)m * K + k], n_rows, n_cols) : 0;
        }
        for (int i = tid; i < kL2BK * kL2BN; i += kL2Threads) {
            const int kk = i / kL2BN, nn = i % kL2BN;
            const int k = k0 + kk, n = n0 + nn;
            int id = 0;
            if (k < k_end && n < N) {
                id = (int)w_idx[(size_t)k * N + n];
                if (id < 0) id += n_cols;
            }
            ws[kk][nn] = id;
        }
        __syncthreads();
        const int kmax = min(kL2BK, k_end - k0);   // K tail: masked terms are skipped
        for (int kk = 0; kk < kmax; ++kk) {
            const int w = ws[kk][tx];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
                acc[r] += (uint32_t)__ldg(table + flat_addr(as[kk][ty * RPT + r], w, table_size));
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) red[(ty * RPT + r) * kL2BN + tx] = acc[r];
    __syncthreads();
    finish_tile(red, kL2BN, out, acc_g, counters, gridDim.z, m0, min(BM, M - m0), n0,
                min(kL2BN, N - n0), N);
}

enum Route { kSmem = 0, kL2 = 1 };

}  // namespace

// a_idx: (M, K) int32 row ids of the table (canonicalized and scaled by
// n_cols in the kernel, in wrapping int32, as lut_matmul_pallas does).
// w_idx: (K, N) int8/int16/int32 (idx_bytes 1, 2, 4).  table: (n_rows * n_cols) int32.
// out: (M, N) int32.  acc: (M, N) zeroed uint32 scratch and counters: one
// zeroed counter per output tile, both used when splits > 1 and left
// zeroed.  route 0 smem (bm 4 or 16, threads, stages), 1 l2 (bm 4, 16 or 64), as
// kernels/_common.py::lut_plan picks them.  vec_ok: w_idx rows may be read as
// 16-byte vectors; row_vec_ok: n_cols % 4 == 0 and the table is 16-byte
// aligned.  One launch; returns cudaGetLastError() after it (0 = success).
extern "C" int lut_matmul_launch(const int32_t* a_idx, const void* w_idx, int idx_bytes,
                                 const int32_t* table, int n_rows, int n_cols, int table_size,
                                 int32_t* out, uint32_t* acc, unsigned* counters, int M, int K,
                                 int N, int route, int bm, int threads, int stages, int splits,
                                 int k_chunk, int vec_ok, int row_vec_ok, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out);
    cudaError_t e = csrc::with_id_type(idx_bytes, [&](auto id) {
        using IT = decltype(id);
        return csrc::with_rows_per_block(bm, [&](auto rows) -> cudaError_t {
            constexpr int BM = decltype(rows)::value;
            if (route == kSmem) {
                if constexpr (BM != 4 && BM != 16) {
                    return cudaErrorInvalidValue;
                } else {
                    using S = Lut<IT, BM>;
                    if (threads < 32 || threads > S::MAX_THREADS || threads % 32 || stages < 2 ||
                        stages > kMaxStages)
                        return cudaErrorInvalidValue;
                    const int c_stride = (n_cols + 3) & ~3;
                    const int bn = threads * S::VEC;
                    const StageLayout L(BM, c_stride);
                    const size_t smem = lut_a_offset(stages, L.bytes, BM, bn) +
                                        (((size_t)BM * k_chunk * 4 + 15) & ~(size_t)15);
                    auto kernel = lut_smem_kernel<IT, BM>;
                    cudaError_t e2 = csrc::allow_smem(kernel, smem);
                    if (e2 != cudaSuccess) return e2;
                    dim3 grid((N + bn - 1) / bn, (M + BM - 1) / BM, splits);
                    kernel<<<grid, threads, smem, s>>>(
                        a_idx, static_cast<const IT*>(w_idx), table, dst, acc, counters, M, K, N,
                        n_rows, n_cols, c_stride, table_size, k_chunk, stages, vec_ok,
                        row_vec_ok);
                    return cudaGetLastError();
                }
            }
            if (route == kL2) {
                dim3 grid((N + kL2BN - 1) / kL2BN, (M + BM - 1) / BM, splits);
                lut_l2_kernel<IT, BM><<<grid, kL2Threads, 0, s>>>(
                    a_idx, static_cast<const IT*>(w_idx), table, dst, acc, counters, M, K, N,
                    n_rows, n_cols, table_size, k_chunk);
                return cudaGetLastError();
            }
            return cudaErrorInvalidValue;
        });
    });
    return (int)e;
}
