// K3, K4, K5: the DBSCAN eps-graph passes.  Each reduces one row of squared
// L2 distances per query, q (Q, D) against x (N, D), straight into a per-query
// result; the (Q, N) distance matrix never reaches device memory.
//
//   K3 eps_count         (Q,) i32: |{j : d2(q, x_j) <= eps_sq}|
//   K4 eps_min_label     (Q,) i32: min labels[j] over core j with d2 <= eps_sq;
//                        N (= len(x)) when there is none
//   K5 eps_nearest_core  (Q,) f32 d2 and (Q,) i32 label of the nearest core
//                        point, the first index winning a tie; (+inf, N) when
//                        x has no core point
//
// Replaces the TPU kernels repro/kernels/pairwise_l2.py::eps_count_pallas,
// eps_min_label_pallas and eps_nearest_core_pallas (bodies _eps_count_kernel,
// _eps_min_label_kernel, _eps_nearest_core_kernel).  The contract is the plain
// versions' (repro_torch/kernels/ref.py::eps_*_ref).
//
// What bounds it on an H100: operations.  DBSCAN runs each pass with Q = N,
// so a pass computes N^2 distances (10^12 on the 1,000,000-row dataset) and
// reads only the two (N, D) operands and an (N,) label and flag row.  At
// 3D + 2 f32 operations per pair the 67 TFLOP/s f32 rate is the roofline,
// far above what the bytes need.
//
// What the design does about it: one thread per query, 128 queries per
// block, one launch over all N queries (the TPU's lax.scan over blocks of
// 1,024 rows was its memory plan, not the function).  The query row lives in
// registers; x is streamed through shared memory in tiles of 128 rows, each
// row read by all 128 threads of the block as a broadcast.  The feature width
// is a template parameter: the paper's widths 5 and 20 run unpadded, other
// widths pad to the next of 8, 32, 64 with zeros (which add nothing), and a
// width above 64 reads both rows from global memory (right for any D, not
// tuned).  K4 and K5 skip non-core columns; the skip is the same for every
// thread of the block, so it costs no divergence.
//
// Exactness: the threshold d2 <= eps_sq is a hard decision, so the arithmetic
// is the plain version's and K2's: f32 FMA, never tensor cores or TF32;
// ||q||^2, ||x||^2 and q.x are separate sums taken in feature order; the
// epilogue max(||q||^2 + ||x||^2 - 2 q.x, 0) uses round-to-nearest intrinsics
// so the compiler cannot contract it.  K5 scans each query's columns in index
// order and replaces its best only on a strictly smaller d2, so the first
// index wins a tie, as argmin does.  Indices and counts are int32 (N < 2^31);
// addresses are computed in 64 bits.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 128;  // queries per block, one per thread
constexpr int kTile = 128;     // x rows staged in shared memory per pass

enum Mode { kCount = 0, kMinLabel = 1, kNearestCore = 2 };

__device__ __forceinline__ float sq_l2(float qn, float xn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, dot)), 0.f);
}

// DC > 0: rows padded to DC features, query in registers, x tile in shared
// memory.  DC == 0: any width, both rows read from global memory.
template <int MODE, int DC>
__global__ void __launch_bounds__(kQueries)
eps_kernel(const float* __restrict__ q, const float* __restrict__ x,
           const int* __restrict__ labels, const uint8_t* __restrict__ core,
           float eps_sq, int nq, int nx, int dim,
           int* __restrict__ out_label, float* __restrict__ out_d2) {
  constexpr int kStride = DC > 0 ? DC : 1;
  __shared__ __align__(16) float xs[kTile * kStride];
  __shared__ float xn[kTile];
  __shared__ int xl[kTile];
  __shared__ uint8_t xc[kTile];

  const int tid = threadIdx.x;
  const int i = blockIdx.x * kQueries + tid;
  const bool live = i < nq;
  const float* qrow = q + (int64_t)(live ? i : 0) * dim;

  float qr[kStride];
  float qn = 0.f;
  if (DC > 0) {
#pragma unroll
    for (int d = 0; d < kStride; ++d) qr[d] = (live && d < dim) ? qrow[d] : 0.f;
#pragma unroll
    for (int d = 0; d < kStride; ++d) qn = fmaf(qr[d], qr[d], qn);
    // the padding columns stay zero: staging below writes only d < dim
    if (dim < DC)
      for (int e = tid; e < kTile * DC; e += kQueries) xs[e] = 0.f;
  } else {
    for (int d = 0; d < dim; ++d) qn = fmaf(qrow[d], qrow[d], qn);
  }

  int count = 0;
  int best_label = nx;  // the sentinel
  float best_d2 = CUDART_INF_F;

  for (int t0 = 0; t0 < nx; t0 += kTile) {
    const int rows = min(kTile, nx - t0);
    const float* xt = x + (int64_t)t0 * dim;
    __syncthreads();  // the previous tile is consumed
    if (DC > 0) {
      for (int e = tid; e < rows * dim; e += kQueries) {
        const int r = e / dim;
        xs[r * DC + (e - r * dim)] = xt[e];
      }
    }
    if (MODE != kCount && tid < rows) {
      xl[tid] = labels[t0 + tid];
      xc[tid] = core[t0 + tid];
    }
    __syncthreads();
    if (tid < rows) {
      float n = 0.f;
      if (DC > 0) {
        for (int d = 0; d < dim; ++d) n = fmaf(xs[tid * DC + d], xs[tid * DC + d], n);
      } else {
        const float* xr = xt + (int64_t)tid * dim;
        for (int d = 0; d < dim; ++d) n = fmaf(xr[d], xr[d], n);
      }
      xn[tid] = n;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < rows; ++j) {
      if (MODE != kCount && !xc[j]) continue;  // uniform across the block
      float dot = 0.f;
      if (DC > 0) {
        const float* xr = xs + j * DC;
#pragma unroll
        for (int d = 0; d < kStride; ++d) dot = fmaf(qr[d], xr[d], dot);
      } else {
        const float* xr = xt + (int64_t)j * dim;
        for (int d = 0; d < dim; ++d) dot = fmaf(qrow[d], __ldg(xr + d), dot);
      }
      const float d2 = sq_l2(qn, xn[j], dot);
      if (MODE == kCount) {
        count += d2 <= eps_sq;
      } else if (MODE == kMinLabel) {
        if (d2 <= eps_sq) best_label = min(best_label, xl[j]);
      } else if (d2 < best_d2) {  // strict: the first index keeps a tie
        best_d2 = d2;
        best_label = xl[j];
      }
    }
  }
  if (!live) return;
  if (MODE == kCount) {
    out_label[i] = count;
  } else {
    out_label[i] = best_label;
    if (MODE == kNearestCore) out_d2[i] = best_d2;
  }
}

template <int MODE>
int launch(const float* q, const float* x, const int* labels, const uint8_t* core,
           float eps_sq, int nq, int nx, int dim, int* out_label, float* out_d2,
           void* stream) {
  const dim3 grid((nq + kQueries - 1) / kQueries);
  cudaStream_t s = (cudaStream_t)stream;
#define EPS_LAUNCH(DC) \
  eps_kernel<MODE, DC><<<grid, kQueries, 0, s>>>(q, x, labels, core, eps_sq, nq, nx, dim, \
                                                 out_label, out_d2)
  if (dim <= 5) EPS_LAUNCH(5);
  else if (dim <= 8) EPS_LAUNCH(8);
  else if (dim <= 20) EPS_LAUNCH(20);
  else if (dim <= 32) EPS_LAUNCH(32);
  else if (dim <= 64) EPS_LAUNCH(64);
  else EPS_LAUNCH(0);
#undef EPS_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int eps_count_f32(const float* q, const float* x, float eps_sq, int* out,
                             int nq, int nx, int dim, void* stream) {
  return launch<kCount>(q, x, nullptr, nullptr, eps_sq, nq, nx, dim, out, nullptr, stream);
}

extern "C" int eps_min_label_f32(const float* q, const float* x, const int* labels,
                                 const uint8_t* core, float eps_sq, int* out, int nq,
                                 int nx, int dim, void* stream) {
  return launch<kMinLabel>(q, x, labels, core, eps_sq, nq, nx, dim, out, nullptr, stream);
}

extern "C" int eps_nearest_core_f32(const float* q, const float* x, const int* labels,
                                    const uint8_t* core, float* out_d2, int* out_label,
                                    int nq, int nx, int dim, void* stream) {
  return launch<kNearestCore>(q, x, labels, core, 0.f, nq, nx, dim, out_label, out_d2,
                              stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
