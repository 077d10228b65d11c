// K7: squared-L2 distances of f32 queries against an int8 datastore with
// per-row f32 scales, q (Q, D) f32, x_q (N, D) i8, scale (N,) f32 ->
// (Q, N) f32.
//
// Replaces the TPU kernel repro/kernels/pairwise_l2.py::
// pairwise_sq_l2_int8_pallas (body _pairwise_int8_kernel).  The contract is
// the plain version's (repro_torch/kernels/ref.py::pairwise_sq_l2_int8_ref):
// row j dequantizes per element to float(x_q[j, d]) * scale[j] (one
// rounding; never scale^2 * sum x_q^2, which rounds differently), then
// max(||q||^2 + ||x||^2 - 2 q.x, 0).  The JAX kernel sums D in blocks of
// 256; this kernel follows the plain version's single expansion in feature
// order.
//
// What bounds it on an H100: bytes.  At decode (Q = 8, N = 2^20, D = 896)
// it reads 0.94 GB of int8 rows (4x fewer bytes than the f32 datastore) and
// writes the 33.5 MB (Q, N) matrix: ~0.29 ms at 3.35 TB/s, against 15 GFLOP
// of f32 work (~0.22 ms at 67 TFLOP/s).
//
// What the design does about it: ||q||^2 once per call in a pre-pass
// (rowtile::query_norms), then one block per (8 queries, 256 rows), the
// query tile fastest in the grid so the blocks that share a row tile run
// together and read it once from device memory.  The rows go through the
// shared distance tile (row_tile.cuh) as bytes, by cp.async, and each thread
// dequantizes its own row as it reads it; each output
// is computed once and written with consecutive threads on consecutive
// rows.  The selection of the k nearest that follows in the kNN-LM path is
// not part of this kernel (in JAX it is lax.top_k outside Pallas).
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_tile.cuh"

namespace {

using rowtile::kQueries;
using rowtile::kRows;
using rowtile::kThreads;

constexpr int kMaxRowTiles = 65535;  // grid.y limit; larger N loops

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pairwise_int8(const float* __restrict__ q, const float* __restrict__ qnorm,
              const int8_t* __restrict__ xq, const float* __restrict__ scale,
              float* __restrict__ out, int nq, int nx, int dim) {
  __shared__ rowtile::TileI8 tile;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQueries;
  float qn[kQueries];
  rowtile::load_norms(qnorm, q0, nq, qn);
  for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRows; r0 < nx;
       r0 += static_cast<int64_t>(gridDim.y) * kRows) {
    float d2[kQueries];
    rowtile::tile_distances<kVec>(tile, q, xq, scale, q0, nq, r0, nx, dim, qn, d2);
    const int64_t row = r0 + threadIdx.x;
    if (row < nx) {
#pragma unroll
      for (int i = 0; i < kQueries; ++i)
        if (q0 + i < nq) out[(q0 + i) * nx + row] = d2[i];
    }
  }
}

}  // namespace

// qnorm: (nq,) scratch.  vec: dim % 4 == 0 and x_q 4-byte aligned.
extern "C" int pairwise_sq_l2_int8(const float* q, const int8_t* xq, const float* scale,
                                   float* qnorm, float* out, int nq, int nx, int dim, int vec,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rowtile::launch_query_norms(q, nq, dim, qnorm, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (nx + kRows - 1) / kRows;
  dim3 grid((nq + kQueries - 1) / kQueries, row_tiles < kMaxRowTiles ? row_tiles : kMaxRowTiles);
  if (vec) {
    pairwise_int8<true><<<grid, kThreads, 0, s>>>(q, qnorm, xq, scale, out, nq, nx, dim);
  } else {
    pairwise_int8<false><<<grid, kThreads, 0, s>>>(q, qnorm, xq, scale, out, nq, nx, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
