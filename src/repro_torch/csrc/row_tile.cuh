// The distance tile shared by K6 (knn_topk.cu) and K7 (pairwise_int8.cu):
// 8 queries against 256 datastore rows, one row per thread, the (8, 256)
// squared L2 distances left in registers.
//
// Rows are staged through shared memory 32 features at a time with
// cp.async (every copy of a stage in flight at once, no register round
// trip); the 8 queries' slices sit beside them and every thread reads them
// as a broadcast.  f32 rows are staged as they are; int8 rows are staged as
// bytes and each thread dequantizes its own row as it reads it,
// float(x_q) * scale[row], one rounding, as the plain version does.  A
// thread reads 4 features of its row at once and does 4 + 4 * 8 FMAs per
// 9 shared loads.  Row strides are padded so a warp's reads hit distinct
// banks.  Widths that are not a multiple of 4 (or unaligned rows) take a
// plain load path.
//
// Arithmetic: f32 FMA products, never tensor cores or TF32; ||q||^2,
// ||x||^2 and q.x are separate sums taken in feature order, zeros past the
// feature edge adding nothing: in f32 within each 32-feature stage, and the
// stage totals carried in f64.  A plain f32 chain over D = 896 drifts ~15
// ulp of ||q||^2 + ||x||^2 from the plain version's blocked sums, past the
// in-band rule (8 ulp); the f64 carry keeps the kernel within ~1-2 ulp for
// 9 f64 adds per stage.  The sums are rounded to f32 once, and the epilogue
// max(||q||^2 + ||x||^2 - 2 q.x, 0) is the plain version's in f32, with
// round-to-nearest intrinsics so the compiler cannot contract it.  On rows
// where every product and partial sum is exact (a 1/8 grid, power-of-two
// scales) the result equals the plain version bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rowtile {

constexpr int kThreads = 256;          // one row of the tile per thread
constexpr int kRows = kThreads;
constexpr int kQueries = 8;            // queries per block
constexpr int kDChunk = 32;            // features staged per pass
constexpr int kGroups = kDChunk / 4;   // 4-feature groups per row and pass
constexpr int kPerThread = kRows * kGroups / kThreads;  // groups each thread stages
constexpr int kXStride = kDChunk + 4;  // f32 row stride: float4 reads conflict-free
constexpr int kBStride = kDChunk + 4;  // int8 row stride in bytes (9 words: odd)

struct __align__(16) TileF32 {
  float xs[kRows][kXStride];
  float qs[kQueries][kDChunk];
};

struct __align__(16) TileI8 {
  int8_t xb[kRows][kBStride];
  float qs[kQueries][kDChunk];
};

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ||q||^2 of every query, one thread per query, summed in feature order as
// the tile sums: f32 within each 32-feature stage, f64 across stages.  A
// pre-pass launched once per call; loads go 16 at a time.
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

// Stage features [d0, d0 + 32) of rows [r0, r0 + 256) (zero past row_end
// and past dim) and of the block's queries.  kVec: dim % 4 == 0 and rows
// 16-byte (f32) or 4-byte (int8) aligned, so a group of 4 features is one
// asynchronous copy; the caller waits (cp_async_wait_all) and synchronises.
template <bool kVec>
__device__ __forceinline__ void stage_rows(TileF32& t, const float* __restrict__ x,
                                           int64_t r0, int64_t row_end, int dim, int d0) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int g = threadIdx.x + j * kThreads;
    const int r = g / kGroups;
    const int c = (g % kGroups) * 4;
    const int64_t row = r0 + r;
    const int d = d0 + c;
    const bool live = row < row_end && d < dim;
    const float* src = live ? x + row * dim + d : x;
    if (kVec) {
      cp_async16(&t.xs[r][c], src, live);
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = (live && d + e < dim) ? src[e] : 0.f;
      *reinterpret_cast<float4*>(&t.xs[r][c]) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void stage_rows(TileI8& t, const int8_t* __restrict__ x,
                                           int64_t r0, int64_t row_end, int dim, int d0) {
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int g = threadIdx.x + j * kThreads;
    const int r = g / kGroups;
    const int c = (g % kGroups) * 4;
    const int64_t row = r0 + r;
    const int d = d0 + c;
    const bool live = row < row_end && d < dim;
    const int8_t* src = live ? x + row * dim + d : x;
    if (kVec) {
      cp_async4(&t.xb[r][c], src, live);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) t.xb[r][c + e] = (live && d + e < dim) ? src[e] : 0;
    }
  }
}

template <typename Tile>
__device__ __forceinline__ void stage_queries(Tile& t, const float* __restrict__ q, int64_t q0,
                                              int nq, int dim, int d0) {
  const int i = threadIdx.x / kDChunk;  // 256 threads = 8 queries x 32 features
  const int c = threadIdx.x % kDChunk;
  const int d = d0 + c;
  t.qs[i][c] = (q0 + i < nq && d < dim) ? q[(q0 + i) * dim + d] : 0.f;
}

// Features c..c+3 of this thread's row, dequantized for int8.
__device__ __forceinline__ float4 row_group(const TileF32& t, int c, float) {
  return *reinterpret_cast<const float4*>(&t.xs[threadIdx.x][c]);
}

__device__ __forceinline__ float4 row_group(const TileI8& t, int c, float s) {
  const char4 b = *reinterpret_cast<const char4*>(&t.xb[threadIdx.x][c]);
  return make_float4(__fmul_rn(static_cast<float>(b.x), s), __fmul_rn(static_cast<float>(b.y), s),
                     __fmul_rn(static_cast<float>(b.z), s), __fmul_rn(static_cast<float>(b.w), s));
}

// d2[i] = squared distance of query q0 + i to row r0 + threadIdx.x.  Every
// thread of the block must call it (it synchronises and ends on a barrier);
// rows past row_end and queries past nq get meaningless values the caller
// masks.  ``scale`` is the int8 rows' per-row scales (unused for f32).
template <bool kVec, typename Tile, typename Row>
__device__ __forceinline__ void tile_distances(Tile& t, const float* __restrict__ q,
                                               const Row* __restrict__ x,
                                               const float* __restrict__ scale,
                                               int64_t q0, int nq, int64_t r0,
                                               int64_t row_end, int dim,
                                               const float (&qn)[kQueries],
                                               float (&d2)[kQueries]) {
  double dot_total[kQueries];
#pragma unroll
  for (int i = 0; i < kQueries; ++i) dot_total[i] = 0.0;
  double xn_total = 0.0;
  const int64_t my_row = r0 + threadIdx.x;
  const float s = (scale != nullptr && my_row < row_end) ? scale[my_row] : 0.f;
  for (int d0 = 0; d0 < dim; d0 += kDChunk) {
    stage_rows<kVec>(t, x, r0, row_end, dim, d0);
    stage_queries(t, q, q0, nq, dim, d0);
    if (kVec) cp_async_wait_all();
    __syncthreads();
    float dot[kQueries];
#pragma unroll
    for (int i = 0; i < kQueries; ++i) dot[i] = 0.f;
    float xn = 0.f;
#pragma unroll
    for (int c = 0; c < kDChunk; c += 4) {
      const float4 xv = row_group(t, c, s);
      xn = fmaf(xv.x, xv.x, xn);
      xn = fmaf(xv.y, xv.y, xn);
      xn = fmaf(xv.z, xv.z, xn);
      xn = fmaf(xv.w, xv.w, xn);
#pragma unroll
      for (int i = 0; i < kQueries; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&t.qs[i][c]);
        dot[i] = fmaf(qv.x, xv.x, dot[i]);
        dot[i] = fmaf(qv.y, xv.y, dot[i]);
        dot[i] = fmaf(qv.z, xv.z, dot[i]);
        dot[i] = fmaf(qv.w, xv.w, dot[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kQueries; ++i) dot_total[i] += static_cast<double>(dot[i]);
    xn_total += static_cast<double>(xn);
    __syncthreads();
  }
  const float xn = __double2float_rn(xn_total);
#pragma unroll
  for (int i = 0; i < kQueries; ++i) d2[i] = sq_l2(qn[i], xn, __double2float_rn(dot_total[i]));
}

}  // namespace rowtile
