// Helpers shared by K6 (knn_topk.cu) and K7 (pairwise_int8.cu): the
// epilogue of the squared-L2 expansion, the asynchronous copies, and K7's
// query-norm pre-pass.
//
// Arithmetic: f32 FMA products, never tensor cores or TF32; ||q||^2,
// ||x||^2 and q.x are separate sums taken in feature order, zeros past the
// feature edge adding nothing, in f32 within each 32-feature stage (each
// source says how it carries the stage totals).  The epilogue
// max(||q||^2 + ||x||^2 - 2 q.x, 0) is the plain version's in f32, with
// round-to-nearest intrinsics so the compiler cannot contract it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rowtile {

constexpr int kThreads = 256;  // threads of the query-norm pre-pass
constexpr int kQueries = 8;    // queries per K7 block (load_norms)
constexpr int kDChunk = 32;    // features per stage

__device__ __forceinline__ float sq_l2(float qn, float xn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, dot)), 0.f);
}

// Asynchronous global -> shared copies of 16 or 4 bytes; ``valid == false``
// reads nothing and fills zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

// ||q||^2 of every query, one thread per query, summed in feature order:
// f32 within each 32-feature stage, f64 across stages (the order K6 sums
// its queries in, in-kernel).  K7's pre-pass, launched once per call;
// loads go 16 at a time.
__global__ void __launch_bounds__(kThreads)
query_norms(const float* __restrict__ q, int nq, int dim, float* __restrict__ qn) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= nq) return;
  const float* row = q + i * dim;
  double total = 0.0;
  for (int d0 = 0; d0 < dim; d0 += kDChunk) {
    const int end = min(dim, d0 + kDChunk);
    float acc = 0.f;
    int d = d0;
    for (; d + 16 <= end; d += 16) {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = row[d + j];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc = fmaf(v[j], v[j], acc);
    }
    for (; d < end; ++d) acc = fmaf(row[d], row[d], acc);
    total += static_cast<double>(acc);
  }
  qn[i] = __double2float_rn(total);
}

inline cudaError_t launch_query_norms(const float* q, int nq, int dim, float* qn,
                                      cudaStream_t s) {
  query_norms<<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(q, nq, dim, qn);
  return cudaGetLastError();
}

// The block's query norms into registers (0 past nq).
__device__ __forceinline__ void load_norms(const float* __restrict__ qn, int64_t q0, int nq,
                                           float (&out)[kQueries]) {
#pragma unroll
  for (int i = 0; i < kQueries; ++i) out[i] = q0 + i < nq ? qn[q0 + i] : 0.f;
}

}  // namespace rowtile
