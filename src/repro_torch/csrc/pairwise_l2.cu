// K2: squared-L2 distance matrix, (Q, D) x (N, D) -> (Q, N) f32.
//
// Replaces the TPU kernel repro/kernels/pairwise_l2.py::pairwise_sq_l2_pallas
// (body _pairwise_kernel): out[i, j] = max(||q_i||^2 + ||x_j||^2 - 2 q_i.x_j, 0).
//
// What bounds it on an H100: bytes.  On the search path D is 5 or 20 and the
// output (Q, N) f32 is written once, so each output element costs 4 bytes of
// store against 3*D flops; at D <= 128 the 67 TFLOP/s f32 rate is never the
// limit, the 3.35 TB/s write of the matrix is.  At the search's shapes (a few
// MB) a launch lasts a few microseconds, so its fixed cost counts too.
//
// What the design does about it, for D <= 32 (`pairwise_small<DC>`, the
// feature count a template parameter): a block owns 32 rows x 128 columns.
// The 128 columns are staged once, transposed, in shared memory with their
// norms; each warp takes 4 rows at once and each lane computes 4
// consecutive columns of each, 16 independent fmaf chains fed by one 16-byte
// shared load per feature, with no zero-padded features.  The output row is written with
// 16-byte float4 stores, consecutive lanes on consecutive columns.  Where N
// is not a multiple of 4 a row starts off 16-byte alignment: each lane then
// writes the aligned float4 that straddles its columns and its left
// neighbour's (a warp shuffle), and the row segment's two ragged ends go as
// scalar stores.  Larger D takes the tiled kernel (`pairwise_tiled`): one
// 64 x 64 output tile per block, q and x staged in D chunks of 16.
//
// Both keep the arithmetic of the plain version's order: ||q||^2, ||x||^2 and
// q.x are separate fmaf chains in feature order (a zero-padded feature adds
// +0 and changes no bit), never tensor cores (TF32 would break the exactness
// of the bound pruning), and the epilogue uses round-to-nearest intrinsics so
// the compiler does not contract it into an FMA: near zero the cancellation
// behaves as the plain version's does.  The ragged Q, N and D edges are
// masked.
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int kTile = 64;   // pairwise_tiled: output rows and columns per block
constexpr int kDChunk = 16; // pairwise_tiled: feature columns staged per pass
constexpr int kThreads = 256;
constexpr int kSmallD = 32;  // widest D of pairwise_small
constexpr int kCols = 128;   // pairwise_small: columns per block, 4 a lane
constexpr int kRows = 32;    // pairwise_small: rows per block
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = kRows / kWarps;  // pairwise_small: rows a warp
constexpr int kXStride = kCols + 4;  // padded row of the transposed x tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq_l2(float qn, float xn, float cross) {
  return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, cross)), 0.f);
}

template <int DC>
__global__ void __launch_bounds__(kThreads)
pairwise_small(const float* __restrict__ q, const float* __restrict__ x,
               float* __restrict__ out, int nq, int nx) {
  __shared__ __align__(16) float xt[DC][kXStride];  // x tile, transposed
  __shared__ __align__(16) float xn[kCols];
  __shared__ float qs[kRows][DC];
  __shared__ float qn[kRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = blockIdx.x * kCols;
  const int row0 = blockIdx.y * kRows;

  // stage: the tile's x rows and q rows are contiguous runs of global
  // memory; every load of a thread is issued before the first store, so the
  // block waits for one memory latency, not one a load
  constexpr int kXPer = (kCols * DC + kThreads - 1) / kThreads;
  constexpr int kQPer = (kRows * DC + kThreads - 1) / kThreads;
  const int64_t xbase = static_cast<int64_t>(col0) * DC;
  const int64_t qbase = static_cast<int64_t>(row0) * DC;
  float xr[kXPer], qr0[kQPer];
#pragma unroll
  for (int k = 0; k < kXPer; ++k) {
    const int e = tid + k * kThreads;
    xr[k] = e < kCols * DC && col0 + e / DC < nx ? x[xbase + e] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int e = tid + k * kThreads;
    qr0[k] = e < kRows * DC && row0 + e / DC < nq ? q[qbase + e] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kXPer; ++k) {
    const int e = tid + k * kThreads;
    if (e < kCols * DC) xt[e % DC][e / DC] = xr[k];
  }
#pragma unroll
  for (int k = 0; k < kQPer; ++k) {
    const int e = tid + k * kThreads;
    if (e < kRows * DC) qs[e / DC][e % DC] = qr0[k];
  }
  __syncthreads();
  if (tid < kCols) {
    float n = 0.f;
#pragma unroll
    for (int d = 0; d < DC; ++d) n = fmaf(xt[d][tid], xt[d][tid], n);
    xn[tid] = n;
  } else if (tid < kCols + kRows) {
    const int r = tid - kCols;
    float n = 0.f;
#pragma unroll
    for (int d = 0; d < DC; ++d) n = fmaf(qs[r][d], qs[r][d], n);
    qn[r] = n;
  }
  __syncthreads();

  const float4 xn4 = reinterpret_cast<const float4*>(xn)[lane];
  const int c_lane = col0 + 4 * lane;  // this lane's first column
  // the warp's rows warp, warp + 8, ... at once: kWarpRows x 4 independent
  // fmaf chains a lane, one 16-byte shared load per feature for all of them
  float cr[kWarpRows][4];
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cr[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < DC; ++d) {
    const float4 xv = reinterpret_cast<const float4*>(&xt[d][0])[lane];
#pragma unroll
    for (int i = 0; i < kWarpRows; ++i) {
      const float qd = qs[warp + kWarps * i][d];
      cr[i][0] = fmaf(qd, xv.x, cr[i][0]);
      cr[i][1] = fmaf(qd, xv.y, cr[i][1]);
      cr[i][2] = fmaf(qd, xv.z, cr[i][2]);
      cr[i][3] = fmaf(qd, xv.w, cr[i][3]);
    }
  }
#pragma unroll
  for (int i = 0; i < kWarpRows; ++i) {
    const int r = warp + kWarps * i;
    const int gq = row0 + r;
    if (gq >= nq) break;  // uniform over the warp
    const float qq = qn[r];
    float v[4] = {sq_l2(qq, xn4.x, cr[i][0]), sq_l2(qq, xn4.y, cr[i][1]),
                  sq_l2(qq, xn4.z, cr[i][2]), sq_l2(qq, xn4.w, cr[i][3])};

    float* orow = out + static_cast<int64_t>(gq) * nx;
    // misalignment of the segment's first column (the output starts 16-byte
    // aligned, so the flat index decides): the lane writes the aligned float4
    // at columns [c_lane - a, c_lane - a + 4)
    const int a = static_cast<int>((static_cast<int64_t>(gq) * nx + col0) & 3);
    float prev[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) prev[j] = __shfl_up_sync(kFull, v[j], 1);
    float o[4];
    switch (a) {
      case 0: o[0] = v[0]; o[1] = v[1]; o[2] = v[2]; o[3] = v[3]; break;
      case 1: o[0] = prev[3]; o[1] = v[0]; o[2] = v[1]; o[3] = v[2]; break;
      case 2: o[0] = prev[2]; o[1] = prev[3]; o[2] = v[0]; o[3] = v[1]; break;
      default: o[0] = prev[1]; o[1] = prev[2]; o[2] = prev[3]; o[3] = v[0]; break;
    }
    const int cs = c_lane - a;
    if (cs >= col0 && cs + 3 < nx) {
      // the intrinsic keeps one 16-byte store: a plain float4 assignment
      // beside the scalar branch is if-converted into four scalar stores
      __stwb(reinterpret_cast<float4*>(orow + cs), make_float4(o[0], o[1], o[2], o[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cs + j >= col0 && cs + j < nx) orow[cs + j] = o[j];
    }
    if (lane == 31) {  // the segment's last a columns, beyond the last float4
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j >= 4 - a && c_lane + j < nx) orow[c_lane + j] = v[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pairwise_tiled(const float* __restrict__ q, const float* __restrict__ x,
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
      out[(int64_t)gq * nx + gx] = sq_l2(qn[r], xn[c], cross[i][j]);
    }
  }
}

template <int DC>
void launch_small(const float* q, const float* x, float* out, int nq, int nx,
                  cudaStream_t stream) {
  dim3 grid((nx + kCols - 1) / kCols, (nq + kRows - 1) / kRows);
  pairwise_small<DC><<<grid, kThreads, 0, stream>>>(q, x, out, nq, nx);
}

template <int... Ds>
void dispatch_small(int dim, const float* q, const float* x, float* out, int nq, int nx,
                    cudaStream_t stream, std::integer_sequence<int, Ds...>) {
  ((dim == Ds + 1 ? launch_small<Ds + 1>(q, x, out, nq, nx, stream) : void()), ...);
}

}  // namespace

// `out` must be 16-byte aligned (the wrapper allocates it).
extern "C" int pairwise_sq_l2_f32(const float* q, const float* x, float* out,
                                  int nq, int nx, int dim, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim <= kSmallD) {
    dispatch_small(dim, q, x, out, nq, nx, s, std::make_integer_sequence<int, kSmallD>{});
  } else {
    dim3 grid((nx + kTile - 1) / kTile, (nq + kTile - 1) / kTile);
    pairwise_tiled<<<grid, kThreads, 0, s>>>(q, x, out, nq, nx, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
