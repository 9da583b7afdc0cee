// Shared by the kernels of csrc/: the ordered split-K reduction, and the
// dispatch from the launch parameters that kernels/_common.py::launch_tiling
// picks (rows per block) and the id width to template instances.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <type_traits>

namespace csrc {

// out[e] = sum over splits of part[s][e], in split order, so the result does
// not depend on how the split blocks were scheduled (for uint32_t the
// wrapping sum is the same in any order).
template <typename T>
__global__ void sum_splits_kernel(const T* __restrict__ part, T* __restrict__ out,
                                  int splits, size_t plane) {
    for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < plane;
         e += (size_t)gridDim.x * blockDim.x) {
        T s = T(0);
        for (int z = 0; z < splits; ++z) s += part[(size_t)z * plane + e];
        out[e] = s;
    }
}

template <typename T>
cudaError_t sum_splits(const T* part, T* out, int splits, size_t plane, cudaStream_t s) {
    const size_t want = (plane + 255) / 256;
    const int blocks = (int)(want < 4096 ? want : 4096);
    sum_splits_kernel<T><<<blocks, 256, 0, s>>>(part, out, splits, plane);
    return cudaGetLastError();
}

// f(std::integral_constant<int, BM>{}) for bm in launch_tiling's ROWS_PER_BLOCK
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

}  // namespace csrc
