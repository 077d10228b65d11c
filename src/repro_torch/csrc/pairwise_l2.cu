// K2: tiled squared-L2 distance matrix, (Q, D) x (N, D) -> (Q, N) f32.
//
// Replaces the TPU kernel repro/kernels/pairwise_l2.py::pairwise_sq_l2_pallas
// (body _pairwise_kernel): out[i, j] = max(||q_i||^2 + ||x_j||^2 - 2 q_i.x_j, 0).
//
// What bounds it on an H100: bytes.  On the search path D is 5 or 20 and the
// output (Q, N) f32 is written once, so each output element costs 4 bytes of
// store against 3*D flops; at D <= 128 the 67 TFLOP/s f32 rate is never the
// limit, the 3.35 TB/s write of the matrix is.
//
// What the design does about it: one 64 x 64 output tile per 256-thread block
// (4 x 4 outputs per thread held in registers), q and x rows staged through
// shared memory in D chunks of 16 so each input element is read from device
// memory once per tile, and the tile is written with consecutive threads on
// consecutive columns.  The arithmetic stays in f32 FMA, never tensor cores
// (TF32 would break the exactness of the bound pruning).  ||q||^2, ||x||^2 and
// q.x are separate sums, as in the plain version, and the epilogue uses
// round-to-nearest intrinsics so the compiler does not contract it into an
// FMA: near zero the cancellation behaves as the plain version's does.  The
// ragged Q, N and D edges are masked (zeros in the D tail add nothing).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;   // output rows (queries) and columns (points) per block
constexpr int kDChunk = 16; // feature columns staged per pass
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pairwise_sq_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                      float* __restrict__ out, int nq, int nx, int dim) {
  __shared__ float qs[kDChunk][kTile + 1];
  __shared__ float xs[kDChunk][kTile + 1];
  __shared__ float qn[kTile];
  __shared__ float xn[kTile];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float cross[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cross[i][j] = 0.f;
  float norm = 0.f;  // threads 0..63: ||q_row||^2, 64..127: ||x_col||^2

  for (int d0 = 0; d0 < dim; d0 += kDChunk) {
    // stage a (64 x 16) chunk of q and of x: 1024 elements each, 4 per thread
    for (int e = tid; e < kTile * kDChunk; e += kThreads) {
      const int r = e / kDChunk;
      const int c = e % kDChunk;
      const int d = d0 + c;
      const int gq = row0 + r;
      const int gx = col0 + r;
      qs[c][r] = (gq < nq && d < dim) ? q[(int64_t)gq * dim + d] : 0.f;
      xs[c][r] = (gx < nx && d < dim) ? x[(int64_t)gx * dim + d] : 0.f;
    }
    __syncthreads();
    if (tid < kTile) {
#pragma unroll
      for (int c = 0; c < kDChunk; ++c) norm = fmaf(qs[c][tid], qs[c][tid], norm);
    } else if (tid < 2 * kTile) {
#pragma unroll
      for (int c = 0; c < kDChunk; ++c)
        norm = fmaf(xs[c][tid - kTile], xs[c][tid - kTile], norm);
    }
#pragma unroll
    for (int c = 0; c < kDChunk; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xs[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cross[i][j] = fmaf(a[i], b[j], cross[i][j]);
    }
    __syncthreads();
  }
  if (tid < kTile) qn[tid] = norm;
  else if (tid < 2 * kTile) xn[tid - kTile] = norm;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int gq = row0 + r;
    if (gq >= nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const int gx = col0 + c;
      if (gx >= nx) continue;
      const float v = __fsub_rn(__fadd_rn(qn[r], xn[c]), __fmul_rn(2.f, cross[i][j]));
      out[(int64_t)gq * nx + gx] = fmaxf(v, 0.f);
    }
  }
}

}  // namespace

extern "C" int pairwise_sq_l2_f32(const float* q, const float* x, float* out,
                                  int nq, int nx, int dim, void* stream) {
  dim3 grid((nx + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
  pairwise_sq_l2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(q, x, out, nq, nx, dim);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
