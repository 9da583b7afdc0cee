// The quantized activation's arithmetic (paper §2.1), shared by the act_quant
// kernel (act_quant.cu) and the gated codebook launch's epilogue
// (codebook_matmul.cu), so that both compute the same function bit for bit.
//
// Two forms of one function (act_quant.cu's header says where each comes
// from): kKernelForm, what act_quant_pallas computes as XLA compiles it, and
// kApplyForm, what repro/core/activations.py act_apply computes op by op in
// x's dtype T.  quantize() returns the output before its rounding to T, and
// the level index in q.  with_mul() multiplies the output, rounded to T, by
// another operand in T: what `y * u` computes for two tensors of dtype T
// (the product of two bf16 values is exact in f32, so the one rounding to T
// is the only one).
//
// The intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn) keep nvcc from contracting
// a product and a sum into an FMA where the reference rounds twice.  No fast
// math: a fast tanhf or expf moves elements across level boundaries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace aq {

enum { kTanh = 0, kRelu6 = 1, kSigmoid = 2, kRtanh = 3 };
enum { kKernelForm = 0, kApplyForm = 1 };

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

// f(x) snapped to its level, before the rounding to T; the level in q.
// lo, step and qmax = L - 1: f32 for the kernel form, already rounded to T
// for the act_apply form; rcp: the f32 reciprocal of the f32 step (kernel
// form only).
template <typename T, int kForm, int kKind>
__device__ __forceinline__ float quantize(float xv, float lo, float step, float qmax, float rcp,
                                          float& q) {
    if constexpr (kForm == kKernelForm) {
        const float fv = f_kernel<T, kKind>(xv);
        q = clip(rintf(__fmul_rn(__fsub_rn(fv, lo), rcp)), 0.f, qmax);
        return __fmaf_rn(q, step, lo);
    } else {
        const float fv = f_apply<T, kKind>(xv);
        const float u = rnd<T>(__fdiv_rn(rnd<T>(__fsub_rn(fv, lo)), step));
        q = clip(rnd<T>(rintf(u)), 0.f, qmax);
        const float v = rnd<T>(__fadd_rn(lo, rnd<T>(__fmul_rn(q, step))));
        return __fadd_rn(fv, rnd<T>(__fsub_rn(v, fv)));   // y + stop_gradient(q(y) - y)
    }
}

// the act_apply form with the kind chosen at run time (an epilogue's kind)
template <typename T>
__device__ __forceinline__ float quantize_apply(int kind, float xv, float lo, float step,
                                                float qmax, float& q) {
    switch (kind) {
        case kTanh: return quantize<T, kApplyForm, kTanh>(xv, lo, step, qmax, 0.f, q);
        case kRelu6: return quantize<T, kApplyForm, kRelu6>(xv, lo, step, qmax, 0.f, q);
        case kSigmoid: return quantize<T, kApplyForm, kSigmoid>(xv, lo, step, qmax, 0.f, q);
        default: return quantize<T, kApplyForm, kRtanh>(xv, lo, step, qmax, 0.f, q);
    }
}

// T(out) · m, with m already in T; the caller's store rounds the product
template <typename T>
__device__ __forceinline__ float with_mul(float out, float m) {
    return __fmul_rn(rnd<T>(out), m);
}

}  // namespace aq
