// act_quant for Hopper (sm_90a): the paper's quantized activation (§2.1),
// f(x) snapped to L levels equally spaced in output space, plus the int32
// level index.
//
// Replaces repro/kernels/act_quant.py::act_quant_kernel (the Pallas TPU
// kernel, reached through act_quant_pallas).  On the TPU it walks (256, 256)
// VMEM blocks of a padded 2-D view; here it is elementwise over the flat
// tensor, one element per thread in a grid-stride loop, with a bounds check in
// place of the padding.
//
// What bounds it: bytes.  Each element is read once (2 or 4 B) and written
// once (2 or 4 B, plus 4 B of index when asked for); it does one
// transcendental and a handful of flops.  At the serving site (4 x 6144 bf16
// at decode, no index) that is 98 KB, about 0.03 us at 3.35 TB/s, so a launch
// costs what launching costs.
//
// Two forms of one function, chosen by a template parameter:
//
// - kForm == kKernelForm: what act_quant_pallas computes as XLA compiles
//   it (the Pallas kernel runs under jit, in interpret mode too).  Cast x to
//   f32, y = f(x), q = rint((y - lo) * rcp) clamped to [0, L - 1], out =
//   fma(q, step, lo) rounded once and cast to x's dtype: XLA folds the
//   division by the constant step into a product with its f32 reciprocal
//   rcp, and contracts lo + q * step into one fused multiply-add.  f: tanhf,
//   the clamp of relu6, 1 / (1 + expf(-x)) for sigmoid, max(tanhf, 0) for
//   rtanh.
// - kForm == kApplyForm: what repro/core/activations.py act_apply and
//   act_index compute, op by op in x's dtype T: every operation is done in
//   f32 and rounded to T, as XLA does a bf16 operation, with lo, step and
//   L - 1 given already rounded to T.  y = T(f(x)); u = T(T(y - lo) / step);
//   q = clamp(rint(u), 0, T(L - 1)); v = T(lo + T(q * step)); out =
//   T(y + T(v - y)), the forward of y + stop_gradient(q(y) - y).  f: tanhf;
//   for sigmoid jax.nn.sigmoid, which XLA expands to 1 / (1 + exp(-x)) with
//   a rounding to T after the exp, the add and the division.  For T = f32
//   the roundings are the identity and this is act_apply's f32 arithmetic.
//
// The intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn) keep nvcc from contracting
// a product and a sum into an FMA where the reference rounds twice.  No fast
// math: a fast tanhf or expf moves elements across level boundaries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
enum { kTanh = 0, kRelu6 = 1, kSigmoid = 2, kRtanh = 3 };
enum { kKernelForm = 0, kApplyForm = 1 };

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) {
    p[i] = __float2bfloat16_rn(v);
}

// v rounded to T and back to f32 (the identity for T = float)
template <typename T>
__device__ __forceinline__ float rnd(float v) {
    if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
    return v;
}

// clamps that let a NaN through, as jnp.clip does
__device__ __forceinline__ float clip(float v, float lo, float hi) {
    v = v < lo ? lo : v;
    return v > hi ? hi : v;
}

template <typename T, int kKind>
__device__ __forceinline__ float f_kernel(float x) {
    if constexpr (kKind == kTanh) return tanhf(x);
    if constexpr (kKind == kRelu6) return clip(x, 0.f, 6.f);
    if constexpr (kKind == kSigmoid) return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
    float t = tanhf(x);
    return t < 0.f ? 0.f : t;
}

template <typename T, int kKind>
__device__ __forceinline__ float f_apply(float x) {
    if constexpr (kKind == kSigmoid) {
        const float e = rnd<T>(expf(-x));
        return rnd<T>(__fdiv_rn(1.f, rnd<T>(__fadd_rn(1.f, e))));
    }
    return rnd<T>(f_kernel<T, kKind>(x));
}

template <typename T, int kForm, int kKind>
__global__ void __launch_bounds__(kThreads)
act_quant_kernel(const T* __restrict__ x, T* __restrict__ y, int32_t* __restrict__ idx,
                 long long n, float lo, float step, float qmax, float rcp) {
    for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n;
         i += (long long)gridDim.x * kThreads) {
        const float xv = load_f(x, i);
        float q, out;
        if constexpr (kForm == kKernelForm) {
            const float fv = f_kernel<T, kKind>(xv);
            q = clip(rintf(__fmul_rn(__fsub_rn(fv, lo), rcp)), 0.f, qmax);
            out = __fmaf_rn(q, step, lo);
        } else {
            const float fv = f_apply<T, kKind>(xv);
            const float u = rnd<T>(__fdiv_rn(rnd<T>(__fsub_rn(fv, lo)), step));
            q = clip(rnd<T>(rintf(u)), 0.f, qmax);
            const float v = rnd<T>(__fadd_rn(lo, rnd<T>(__fmul_rn(q, step))));
            out = __fadd_rn(fv, rnd<T>(__fsub_rn(v, fv)));
        }
        store_f(y, i, out);
        if (idx != nullptr) idx[i] = (int32_t)q;
    }
}

template <typename T, int kForm>
cudaError_t launch_kind(int kind, const void* x, void* y, int32_t* idx, long long n, float lo,
                        float step, float qmax, float rcp, int blocks, cudaStream_t s) {
    const T* xp = static_cast<const T*>(x);
    T* yp = static_cast<T*>(y);
    switch (kind) {
        case kTanh:
            act_quant_kernel<T, kForm, kTanh><<<blocks, kThreads, 0, s>>>(xp, yp, idx, n, lo, step, qmax, rcp);
            break;
        case kRelu6:
            act_quant_kernel<T, kForm, kRelu6><<<blocks, kThreads, 0, s>>>(xp, yp, idx, n, lo, step, qmax, rcp);
            break;
        case kSigmoid:
            act_quant_kernel<T, kForm, kSigmoid><<<blocks, kThreads, 0, s>>>(xp, yp, idx, n, lo, step, qmax, rcp);
            break;
        case kRtanh:
            act_quant_kernel<T, kForm, kRtanh><<<blocks, kThreads, 0, s>>>(xp, yp, idx, n, lo, step, qmax, rcp);
            break;
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

}  // namespace

// x, y: n contiguous elements, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); idx: n
// int32 level indices, or null to skip them.  kind: 0 tanh, 1 relu6,
// 2 sigmoid, 3 rtanh.  form: 0 the Pallas kernel's, 1 act_apply's.  lo, step
// and qmax = L - 1: f32 for form 0, already rounded to x's dtype for form 1;
// rcp: the f32 reciprocal of the f32 step (form 0 only).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int act_quant_launch(const void* x, int x_bf16, void* y, int32_t* idx, long long n,
                                int kind, int form, float lo, float step, float qmax,
                                float rcp, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const long long want = (n + kThreads - 1) / kThreads;
    const int blocks = (int)(want < 65536 ? want : 65536);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (form == kKernelForm) {
        return x_bf16 ? (int)launch_kind<__nv_bfloat16, kKernelForm>(kind, x, y, idx, n, lo, step, qmax, rcp, blocks, s)
                      : (int)launch_kind<float, kKernelForm>(kind, x, y, idx, n, lo, step, qmax, rcp, blocks, s);
    }
    if (form == kApplyForm) {
        return x_bf16 ? (int)launch_kind<__nv_bfloat16, kApplyForm>(kind, x, y, idx, n, lo, step, qmax, rcp, blocks, s)
                      : (int)launch_kind<float, kApplyForm>(kind, x, y, idx, n, lo, step, qmax, rcp, blocks, s);
    }
    return (int)cudaErrorInvalidValue;
}
