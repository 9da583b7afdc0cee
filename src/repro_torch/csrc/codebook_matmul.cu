// codebook_matmul for Hopper (sm_90a):  out[M,N] (f32) = x[M,K] @ codebook[canon(w_idx[K,N])]
//
// Replaces repro/kernels/codebook_matmul.py::codebook_matmul_kernel (the
// Pallas TPU kernel).  Weights stay narrow integer ids in device memory
// (int8 for |W| <= 256, int16 up to 65536, int32 beyond) and are dequantized
// on chip through a codebook held in shared memory.
//
// What bounds it: the kernel must stream the K x N id matrix once; at every
// row count the serving path gives it (M <= 256) that takes longer than the
// 2MKN products at the bf16 tensor-core rate, so the bound is device-memory
// bytes, and the ids are the bytes.  PERF.md has the measured times; what
// keeps the kernel from its bound (per-block set-up and reduction, and at
// decode too few blocks to keep enough loads in flight) is written there.
//
// Two routes, picked by kernels/_common.py::codebook_plan from the shape,
// the dtype of x and the alignment of the rows:
//
// * mma (bf16 x, 16-byte aligned rows, every M): tensor cores.  A block owns
//   16 (M <= 16) or 64 rows and 64 columns; each 128-deep stage, its threads
//   load 16-byte chunks of x and of the raw ids straight into registers two
//   stages ahead, dequantize the ids to bf16 into a padded shared-memory
//   tile that ldmatrix.trans reads without bank conflicts, and 8 warps each
//   run a 16-deep slice with mma.sync.m16n8k16 (bf16 in, f32 accumulate;
//   the tensor cores add in their own order).  The warps' sums meet in warp
//   order.  Register loads, not per-thread cp.async rings: on the H100 the
//   rings streamed the same ids more slowly.
// * fma (f32 x, and bf16 rows that are not 16-byte aligned): a plain FMA
//   tile of 64 x 64 outputs, 32 K rows a stage.
//
// Few output tiles: K is split across blocks (every split a whole number of
// 32-deep stages, at most 8 splits), and the splits of a tile form one
// thread block cluster: each block adds one slice of the tile over the
// cluster's blocks through distributed shared memory, in rank order
// (common.cuh).  So the result does not depend on scheduling, and neither a
// second launch nor float atomics touch the values.
//
// The gated launch (codebook_swiglu_launch): a SwiGLU FFN's gate and up
// products, G = x @ book1[w1] and U = x @ book3[w3], in one launch, with
// the quantized activation as their epilogue: h = T(act_q(T(G)) * T(U)),
// T = x's dtype, act_q the act_apply form of act_quant.cuh.  A block owns
// the same 32 columns of both products: its 64-wide tile holds w1's ids in
// its first half and w3's in its second, so it loads the x tile once for
// both, keeps the single product's registers and pipeline, and G, U and the
// activation never reach device memory.  Every product term, warp slice,
// warp order and split is the single product's of the same plan (each
// output sum runs the same sequence of adds whatever its column in a tile),
// so G and U carry the bits of two codebook_matmul launches and h equals
// the unfused chain (two launches, two casts, act_quant, the product) bit
// for bit.  Replaces no TPU kernel of its own: it is act_quant's redesign
// (repro/kernels/act_quant.py) as the epilogue of codebook_matmul's.
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
#include <string.h>

#include "act_quant.cuh"
#include "common.cuh"

namespace {

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// codebook entry rounded to x's dtype (round to nearest even, as XLA converts)
__device__ __forceinline__ float as_x_dtype(float v, const float*) { return v; }
__device__ __forceinline__ float as_x_dtype(float v, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int canon(int id, int n_book) {
    if (id < 0) id += n_book;
    return min(max(id, 0), n_book - 1);
}

// What a launch does with a tile's final sums, one output at a time: the f32
// sum of one product (codebook_matmul), or the SwiGLU of two (the gated
// launch).  kProducts: the products a block accumulates side by side.
struct StoreSum {
    static constexpr int kProducts = 1;
    float* out;
    int N;
    __device__ __forceinline__ void operator()(int m, int n, const float (&s)[1]) const {
        out[(size_t)m * N + n] = s[0];
    }
};

template <typename T>
struct StoreSwiglu {
    static constexpr int kProducts = 2;
    T* h;
    int N, kind;
    float lo, step, qmax;          // act_apply's, rounded to T
    __device__ __forceinline__ void operator()(int m, int n, const float (&s)[2]) const {
        float q;
        const float y = aq::quantize_apply<T>(kind, aq::rnd<T>(s[0]), lo, step, qmax, q);
        const float v = aq::with_mul<T>(y, aq::rnd<T>(s[1]));
        if constexpr (sizeof(T) == 2)
            h[(size_t)m * N + n] = __float2bfloat16_rn(v);
        else
            h[(size_t)m * N + n] = v;
    }
};

// the codebooks of a launch in shared memory, one after the other, each
// entry converted by cvt: n_a entries of book_a, then (NP = 2) n_b of book_b
template <int NP, int kThreadsT, typename S, typename Cvt>
__device__ __forceinline__ void load_books(S* dst, const float* book_a, int n_a,
                                           const float* book_b, int n_b, Cvt cvt) {
    constexpr int XB = 8;                        // codebook loads in flight a thread
    const int total = NP == 1 ? n_a : n_a + n_b;
    for (int i0 = threadIdx.x; i0 < total; i0 += kThreadsT * XB) {
        float v[XB];
#pragma unroll
        for (int u = 0; u < XB; ++u) {
            const int i = i0 + u * kThreadsT;
            v[u] = i < n_a ? book_a[i] : i < total ? book_b[i - n_a] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < XB; ++u) {
            const int i = i0 + u * kThreadsT;
            if (i < total) dst[i] = cvt(v[u]);
        }
    }
}

// ------------------------------------------------------------------- mma route

constexpr int kMmaThreads = 256;                 // 8 warps, each a 16-deep slice of a stage
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kMBN = 64, kMSK = 128;             // columns a block, K rows a stage
constexpr int kAStride = kMSK + 8;               // 272-byte rows: ldmatrix conflict-free
constexpr int kStride = kMBN + 8;                // 144-byte rows: ldmatrix.trans conflict-free
constexpr int kRedStride = kMBN + 8;             // f32 sums: float2 stores conflict-free

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(csrc::smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(csrc::smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A block owns a (BM x 64) tile of sums and a K split: 64 columns of one
// product, or (the gated launch) the same 32 columns of two, side by side.
// Each 128-deep stage: every thread loads 16-byte chunks of x and of the raw
// ids into registers two stages ahead, dequantizes the ids through the bf16
// codebook(s) in shared memory into a padded bf16 tile, and the 8 warps each
// run the stage's 16-deep slice on the tensor cores (ldmatrix,
// ldmatrix.trans, mma.m16n8k16); the warps' sums meet in warp order at the
// end, then the splits in the cluster, and `epi` stores each output.
template <typename IT, int BM, typename Epi>
__global__ void __launch_bounds__(kMmaThreads)
mma_kernel(const __nv_bfloat16* __restrict__ x, const IT* __restrict__ w_a,
           const IT* __restrict__ w_b, const float* __restrict__ book_a,
           const float* __restrict__ book_b, int n_book_a, int n_book_b, Epi epi, int M, int K,
           int N, int k_chunk) {
    constexpr int NP = Epi::kProducts;
    constexpr int PW = kMBN / NP;                           // columns of each product
    constexpr int IDS16 = 16 / (int)sizeof(IT);            // ids in one 16-byte chunk
    constexpr int CPR = kMBN / IDS16;                       // id chunks a row of the tile
    constexpr int CPP = CPR / NP;                           // ... of one product
    constexpr int NID = kMSK * CPR / kMmaThreads;           // id chunks a thread a stage
    constexpr int NX = BM * (kMSK / 8) / kMmaThreads;       // x chunks a thread a stage
    constexpr int MT = BM / 16;
    static_assert(NID >= 1 && NX >= 1 && CPP >= 1, "tile");
    extern __shared__ __align__(16) unsigned char msm[];
    __nv_bfloat16* a_s[2];
    __nv_bfloat16* b_s[2];
    a_s[0] = reinterpret_cast<__nv_bfloat16*>(msm);
    a_s[1] = a_s[0] + BM * kAStride;
    b_s[0] = a_s[1] + BM * kAStride;
    b_s[1] = b_s[0] + kMSK * kStride;
    float* red = reinterpret_cast<float*>(b_s[1] + kMSK * kStride);   // [BM][kRedStride]
    __nv_bfloat16* book_h = reinterpret_cast<__nv_bfloat16*>(red + BM * kRedStride);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n0 = blockIdx.x * PW, m0 = blockIdx.y * BM, z = blockIdx.z;
    const int k_begin = z * k_chunk, k_end = min(K, k_begin + k_chunk);
    const int n_steps = max(0, (k_end - k_begin + kMSK - 1) / kMSK);
    const int rows = min(BM, M - m0), cols = min(PW, N - n0);

    auto load = [&](int step, uint4 (&xr)[NX], uint4 (&ir)[NID]) {
        const int k0 = k_begin + step * kMSK;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            const int c = tid + i * kMmaThreads, r = c / (kMSK / 8), k = k0 + (c % (kMSK / 8)) * 8;
            xr[i] = r < rows && k < k_end
                        ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k))
                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < NID; ++i) {
            const int c = (tid + i * kMmaThreads) % CPR, r = (tid + i * kMmaThreads) / CPR;
            const int n = n0 + (c % CPP) * IDS16, k = k0 + r;
            const IT* w = c < CPP ? w_a : w_b;              // the chunk's product
            ir[i] = k < k_end && n < N
                        ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * N + n))
                        : make_uint4(0u, 0u, 0u, 0u);
        }
    };
    auto store = [&](int step, int buf, const uint4 (&xr)[NX], const uint4 (&ir)[NID]) {
        const int k0 = k_begin + step * kMSK;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
            const int c = tid + i * kMmaThreads, r = c / (kMSK / 8), kc = (c % (kMSK / 8)) * 8;
            *reinterpret_cast<uint4*>(a_s[buf] + r * kAStride + kc) = xr[i];
        }
#pragma unroll
        for (int i = 0; i < NID; ++i) {
            const int c = (tid + i * kMmaThreads) % CPR, r = (tid + i * kMmaThreads) / CPR;
            const int cc = c * IDS16;
            const bool second = c >= CPP;
            const __nv_bfloat16* book = second ? book_h + n_book_a : book_h;
            const int n_book = second ? n_book_b : n_book_a;
            IT ids[IDS16];
            memcpy(ids, &ir[i], sizeof(ids));
            __align__(16) __nv_bfloat16 w[IDS16];
            const bool k_in = k0 + r < k_end;   // the K tail is zero on both operands
#pragma unroll
            for (int j = 0; j < IDS16; ++j)
                w[j] = k_in ? book[canon((int)ids[j], n_book)] : __float2bfloat16_rn(0.f);
            __nv_bfloat16* dst = b_s[buf] + r * kStride + cc;
#pragma unroll
            for (int h = 0; h < IDS16 / 8; ++h)
                reinterpret_cast<uint4*>(dst)[h] = reinterpret_cast<const uint4*>(w)[h];
            if constexpr (IDS16 == 4)
                *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(w);
        }
    };

    uint4 xa[NX], ia[NID], xb[NX], ib[NID];
    if (n_steps > 0) load(0, xa, ia);
    if (n_steps > 1) load(1, xb, ib);
    load_books<NP, kMmaThreads>(book_h, book_a, n_book_a, book_b, n_book_b,
                                [](float v) { return __float2bfloat16_rn(v); });
    __syncthreads();

    constexpr int NT8 = kMBN / 8;                          // n8 tiles a warp
    float acc[MT][NT8][4];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NT8; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

    const int j = lane >> 3, r8 = lane & 7;
    auto mma_stage = [&](int buf) {
        unsigned af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(af[mt], a_s[buf] + (mt * 16 + (j & 1) * 8 + r8) * kAStride + warp * 16 +
                                (j >> 1) * 8);
#pragma unroll
        for (int np = 0; np < NT8 / 2; ++np) {
            unsigned bf[4];
            ldsm_x4_t(bf, b_s[buf] + (warp * 16 + (j & 1) * 8 + r8) * kStride + np * 16 +
                              (j >> 1) * 8);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                mma_bf16(acc[mt][np * 2], af[mt], bf[0], bf[1]);
                mma_bf16(acc[mt][np * 2 + 1], af[mt], bf[2], bf[3]);
            }
        }
    };
    // two register buffers alternate, so two stages of loads are in flight
    for (int step = 0; step < n_steps; step += 2) {
        store(step, 0, xa, ia);
        if (step + 2 < n_steps) load(step + 2, xa, ia);
        __syncthreads();
        mma_stage(0);
        if (step + 1 < n_steps) {
            store(step + 1, 1, xb, ib);
            if (step + 3 < n_steps) load(step + 3, xb, ib);
            __syncthreads();
            mma_stage(1);
        }
    }

    // the warps' sums, in warp order
    const int g = lane >> 2, t4 = lane & 3;
    for (int w = 0; w < kMmaWarps; ++w) {
        if (warp == w) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int nt = 0; nt < NT8; ++nt)
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        float2* r = reinterpret_cast<float2*>(
                            red + (mt * 16 + g + h * 8) * kRedStride + nt * 8 + t4 * 2);
                        float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
                        if (w > 0) {
                            const float2 o = *r;
                            v = make_float2(o.x + v.x, o.y + v.y);
                        }
                        *r = v;
                    }
        }
        __syncthreads();
    }

    auto emit = [&](int m, int c, const float (&sums)[NP]) { epi(m0 + m, n0 + c, sums); };
    if (gridDim.z == 1) {
        for (int i = tid; i < rows * PW; i += kMmaThreads) {
            const int m = i / PW, c = i - m * PW;
            if (c >= cols) continue;
            float sums[NP];
#pragma unroll
            for (int p = 0; p < NP; ++p) sums[p] = red[m * kRedStride + p * PW + c];
            emit(m, c, sums);
        }
        return;
    }
    csrc::cluster_reduce<NP>(red, rows, kRedStride, PW, cols, emit);   // the splits of this tile
}

// ------------------------------------------------------------------- fma route

constexpr int kFmaThreads = 256;
constexpr int kFBM = 64, kFBN = 64, kFBK = 32;
constexpr int kRowGroups = kFmaThreads / kFBN;   // 4 thread rows

// A block owns a (64 x 64) tile of sums and a K split: 64 columns of one
// product, or (the gated launch) the same 32 columns of two, side by side;
// thread (ty, tx) adds column tx of rows ty * 16 .. ty * 16 + 15 in k order.
template <typename XT, typename IT, typename Epi>
__global__ void __launch_bounds__(kFmaThreads)
fma_kernel(const XT* __restrict__ x, const IT* __restrict__ w_a, const IT* __restrict__ w_b,
           const float* __restrict__ book_a, const float* __restrict__ book_b, int n_book_a,
           int n_book_b, Epi epi, int M, int K, int N, int k_chunk) {
    constexpr int NP = Epi::kProducts;
    constexpr int PW = kFBN / NP;            // columns of each product
    constexpr int RPT = kFBM / kRowGroups;   // rows per thread
    extern __shared__ float book_s[];        // the codebooks, already in x's dtype
    // a stage's x [kFBK][kFBM] and weights [kFBK][kFBN]; then the block's
    // sums [kFBM][kFBN]
    __shared__ __align__(16) float tile_s[2 * kFBK * kFBM];
    float (*xs)[kFBM] = reinterpret_cast<float (*)[kFBM]>(tile_s);
    float (*ws)[kFBN] = reinterpret_cast<float (*)[kFBN]>(tile_s + kFBK * kFBM);
    static_assert(2 * kFBK * kFBM >= kFBM * kFBN, "the sums reuse the tiles");

    const int tid = threadIdx.x;
    const int tx = tid % kFBN, ty = tid / kFBN;
    const int n0 = blockIdx.x * PW, m0 = blockIdx.y * kFBM;
    const int k_begin = blockIdx.z * k_chunk;
    const int k_end = min(K, k_begin + k_chunk);

    load_books<NP, kFmaThreads>(book_s, book_a, n_book_a, book_b, n_book_b,
                                [&](float v) { return as_x_dtype(v, x); });
    __syncthreads();

    float acc[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

    for (int k0 = k_begin; k0 < k_end; k0 += kFBK) {
        for (int i = tid; i < kFBM * kFBK; i += kFmaThreads) {
            const int mm = i / kFBK, kk = i % kFBK;
            const int m = m0 + mm, k = k0 + kk;
            xs[kk][mm] = (m < M && k < k_end) ? load_x(x + (size_t)m * K + k) : 0.f;
        }
        for (int i = tid; i < kFBK * kFBN; i += kFmaThreads) {
            const int kk = i / kFBN, nn = i % kFBN;
            const int k = k0 + kk, n = n0 + nn % PW;
            const bool second = nn >= PW;                   // the column's product
            float w = 0.f;
            if (k < k_end && n < N)
                w = second ? book_s[n_book_a + canon((int)w_b[(size_t)k * N + n], n_book_b)]
                           : book_s[canon((int)w_a[(size_t)k * N + n], n_book_a)];
            ws[kk][nn] = w;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kFBK; ++kk) {
            const float w = ws[kk][tx];
#pragma unroll
            for (int r = 0; r < RPT; ++r) acc[r] = fmaf(xs[kk][ty * RPT + r], w, acc[r]);
        }
        __syncthreads();
    }

    const int rows = min(kFBM, M - m0), cols = min(PW, N - n0);
    float* red = tile_s;                     // the stage loop ended on a barrier
#pragma unroll
    for (int r = 0; r < RPT; ++r) red[(ty * RPT + r) * kFBN + tx] = acc[r];
    auto emit = [&](int m, int c, const float (&sums)[NP]) { epi(m0 + m, n0 + c, sums); };
    if (gridDim.z == 1) {
        __syncthreads();
        for (int i = tid; i < rows * PW; i += kFmaThreads) {
            const int m = i / PW, c = i - m * PW;
            if (c >= cols) continue;
            float sums[NP];
#pragma unroll
            for (int p = 0; p < NP; ++p) sums[p] = red[m * kFBN + p * PW + c];
            emit(m, c, sums);
        }
        return;
    }
    csrc::cluster_reduce<NP>(red, rows, kFBN, PW, cols, emit);   // the splits of this tile
}

enum Route { kMma = 0, kFma = 1 };

// Shared memory a launch of `route` takes beyond its static part: the bf16
// tiles and sums of the mma route and its codebooks in bf16, or the fma
// route's codebooks in x's dtype (as f32).
size_t dyn_smem(int route, int bm, int n_books) {
    if (route == kFma) return (size_t)n_books * sizeof(float);
    const size_t tiles = 2 * ((size_t)bm * kAStride * 2 + (size_t)kMSK * kStride * 2);
    return tiles + (size_t)bm * kRedStride * 4 + (((size_t)n_books * 2 + 15) & ~(size_t)15);
}

// One launch of codebook_matmul (Epi = StoreSum) or of the gated launch
// (StoreSwiglu): the splits of a tile form one cluster, at most 8 (the
// portable size), each a whole number of 32-deep stages covering K.
template <typename XT, typename IT, typename Epi>
cudaError_t launch(int route, const XT* x, const IT* w_a, const IT* w_b, const float* book_a,
                   const float* book_b, int n_book_a, int n_book_b, Epi epi, int M, int K,
                   int N, int bm, int splits, int k_chunk, int vec_ok, cudaStream_t s) {
    if (splits < 1 || splits > 8 || k_chunk <= 0 || k_chunk % 32 ||
        (long long)(splits - 1) * k_chunk >= K || (long long)splits * k_chunk < K)
        return cudaErrorInvalidValue;
    const dim3 cluster(1, 1, splits);
    const int n_books = n_book_a + (Epi::kProducts == 2 ? n_book_b : 0);
    if (route == kMma) {
        // 16-byte loads of x and of the id rows
        if constexpr (!std::is_same<XT, __nv_bfloat16>::value) {
            return cudaErrorInvalidValue;
        } else {
            if (!vec_ok || K % 8) return cudaErrorInvalidValue;
            auto go = [&](auto kernel, int bm_) -> cudaError_t {
                const size_t smem = dyn_smem(kMma, bm_, n_books);
                cudaError_t e = csrc::allow_smem(kernel, smem);
                if (e != cudaSuccess) return e;
                return csrc::launch_clustered(
                    kernel,
                    dim3((N + kMBN / Epi::kProducts - 1) / (kMBN / Epi::kProducts),
                         (M + bm_ - 1) / bm_, splits),
                    dim3(kMmaThreads), smem, s, cluster, x, w_a, w_b, book_a, book_b, n_book_a,
                    n_book_b, epi, M, K, N, k_chunk);
            };
            if (bm == 16) return go(mma_kernel<IT, 16, Epi>, 16);
            if (bm == 64) return go(mma_kernel<IT, 64, Epi>, 64);
            return cudaErrorInvalidValue;
        }
    }
    if (route == kFma) {
        if (bm != kFBM) return cudaErrorInvalidValue;
        auto kernel = fma_kernel<XT, IT, Epi>;
        const size_t smem = dyn_smem(kFma, bm, n_books);
        cudaError_t e = csrc::allow_smem(kernel, smem);
        if (e != cudaSuccess) return e;
        return csrc::launch_clustered(
            kernel,
            dim3((N + kFBN / Epi::kProducts - 1) / (kFBN / Epi::kProducts),
                 (M + kFBM - 1) / kFBM, splits),
            dim3(kFmaThreads), smem, s, cluster, x, w_a, w_b, book_a, book_b, n_book_a,
            n_book_b, epi, M, K, N, k_chunk);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// x_is_bf16: 0 = f32 x, 1 = bf16 x.  idx_bytes: 1, 2 or 4.  route: 0 mma
// (bf16 x, bm 16 or 64), 1 fma (bm 64), as kernels/_common.py::codebook_plan
// picks them.  splits: K splits of k_chunk rows (a multiple of 32), at most
// 8; the splits of a tile meet in one thread block cluster.  vec_ok: the
// rows of x and of w_idx may be read as 16-byte vectors (the mma route needs
// it).  One launch; returns cudaErrorInvalidValue for parameters the routes
// do not take, else cudaGetLastError() after it (0 = success).
extern "C" int codebook_matmul_launch(const void* x, int x_is_bf16, const void* w_idx,
                                      int idx_bytes, const float* codebook, int n_book,
                                      float* out, int M, int K, int N, int route, int bm,
                                      int splits, int k_chunk, int vec_ok, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const StoreSum epi{out, N};
    cudaError_t e = csrc::with_id_type(idx_bytes, [&](auto id) {
        using IT = decltype(id);
        const IT* w = static_cast<const IT*>(w_idx);
        return x_is_bf16
            ? launch(route, static_cast<const __nv_bfloat16*>(x), w, w, codebook, codebook,
                     n_book, n_book, epi, M, K, N, bm, splits, k_chunk, vec_ok, s)
            : launch(route, static_cast<const float*>(x), w, w, codebook, codebook, n_book,
                     n_book, epi, M, K, N, bm, splits, k_chunk, vec_ok, s);
    });
    return (int)e;
}

// The gated launch: h (M x N, x's dtype) = T(act_q(T(x @ book1[w1])) *
// T(x @ book3[w3])), act_q the act_apply form of act_quant.cuh with kind
// (0 tanh, 1 relu6, 2 sigmoid, 3 rtanh) and lo, step, qmax = L - 1 already
// rounded to x's dtype.  w1 and w3: K x N ids of one type (idx_bytes).
// route, bm, splits, k_chunk, vec_ok: codebook_matmul's plan for one
// (M, K, N) product, which the two products both take.  Returns as
// codebook_matmul_launch does.
extern "C" int codebook_swiglu_launch(const void* x, int x_is_bf16, const void* w1,
                                      const void* w3, int idx_bytes, const float* book1,
                                      int n_book1, const float* book3, int n_book3, void* h,
                                      int M, int K, int N, int route, int bm, int splits,
                                      int k_chunk, int vec_ok, int kind, float lo, float step,
                                      float qmax, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind < aq::kTanh || kind > aq::kRtanh) return (int)cudaErrorInvalidValue;
    cudaError_t e = csrc::with_id_type(idx_bytes, [&](auto id) {
        using IT = decltype(id);
        const IT* wa = static_cast<const IT*>(w1);
        const IT* wb = static_cast<const IT*>(w3);
        if (x_is_bf16) {
            const StoreSwiglu<__nv_bfloat16> epi{static_cast<__nv_bfloat16*>(h), N, kind, lo,
                                                 step, qmax};
            return launch(route, static_cast<const __nv_bfloat16*>(x), wa, wb, book1, book3,
                          n_book1, n_book3, epi, M, K, N, bm, splits, k_chunk, vec_ok, s);
        }
        const StoreSwiglu<float> epi{static_cast<float*>(h), N, kind, lo, step, qmax};
        return launch(route, static_cast<const float*>(x), wa, wb, book1, book3, n_book1,
                      n_book3, epi, M, K, N, bm, splits, k_chunk, vec_ok, s);
    });
    return (int)e;
}
