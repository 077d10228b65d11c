// K6: fused squared-L2 distance + per-query top-k over a flat datastore,
// q (Q, D) f32 against x (N, D) f32 -> (Q, k) f32 ascending and (Q, k) i32
// row indices; the (Q, N) distance matrix never reaches device memory.
//
// Replaces the TPU kernel repro/kernels/topk.py::knn_topk_pallas (body
// _knn_topk_kernel).  The contract is the plain version's
// (repro_torch/kernels/ref.py::knn_topk_ref): the k smallest per query in
// the lexicographic order of (d2, row index), so an exact tie goes to the
// lower row, and (+inf, -1) past the end when N < k.
//
// What bounds it on an H100: bytes at decode batch.  The kNN-LM engine
// sends Q = num_slots (4-8) queries per step against a datastore shard of
// 2^20 x 896 f32 rows: 3.76 GB to read once against 2QND = 15 GFLOP, so the
// 3.35 TB/s read sets the bound (~1.1 ms) and the f32 rate does not (the
// operations set it only from Q ~ 150 up; at Q = 1024 they do, ~29 ms).
//
// What the design does about it.  The TPU kernel walks all N rows for one
// query tile, sequentially; at Q = 8 that is one block for the whole card.
// Here N is split across the grid:
//   pass 0 (rowtile::query_norms): ||q||^2 per query, once per call.
//   pass 1 (knn_topk_partial): block (query tile of 8, chunk of rows).
//     Each 256-row tile goes through the shared distance tile
//     (row_tile.cuh: one row per thread, 32 features staged at a time by
//     cp.async, the 8 queries read as a broadcast), so a row is read from
//     device memory once for all 8 queries.  The (8, 256) distances go to shared memory
//     and warp w merges query w's into a running top-k kept sorted in
//     shared memory: a ballot keeps the candidates below the current k-th,
//     and each survivor is inserted after every entry <= it.  Rows arrive
//     in index order, so "after every equal value" is the lower-row-first
//     tie order.  Output: (Q, n_chunks, k) partial lists.
//   pass 2 (knn_topk_merge): one warp per query merges its n_chunks lists
//     in chunk order by the same insertion, which keeps the tie order
//     (every row of a later chunk has a larger index).
// Query tiles of one chunk are adjacent in the grid, so at large Q a chunk
// is read from device memory once and from L2 by the other tiles.  The
// wrapper counts the three passes as one K6 launch.
//
// k <= 64.  Indices are int32 (N < 2^31); addresses are computed in 64 bits.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "row_tile.cuh"

namespace {

using rowtile::kQueries;
using rowtile::kRows;
using rowtile::kThreads;

constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;

// Insert (d, j) into the warp's sorted list (tv, ti) of k entries, after
// every entry whose value is <= d.  The caller has checked d < tv[k - 1];
// every lane calls with the same (d, j).
__device__ __forceinline__ void warp_insert(float* tv, int* ti, int k, float d, int j,
                                            int lane) {
  const int e0 = lane;
  const int e1 = lane + 32;
  const bool le0 = e0 < k && tv[e0] <= d;
  const bool le1 = e1 < k && tv[e1] <= d;
  const int pos = __popc(__ballot_sync(kFull, le0)) + __popc(__ballot_sync(kFull, le1));
  const bool m0 = e0 > pos && e0 < k;
  const bool m1 = e1 > pos && e1 < k;
  float v0 = 0.f, v1 = 0.f;
  int i0 = 0, i1 = 0;
  if (m0) { v0 = tv[e0 - 1]; i0 = ti[e0 - 1]; }
  if (m1) { v1 = tv[e1 - 1]; i1 = ti[e1 - 1]; }
  __syncwarp();
  if (m0) { tv[e0] = v0; ti[e0] = i0; }
  if (m1) { tv[e1] = v1; ti[e1] = i1; }
  if (lane == 0) { tv[pos] = d; ti[pos] = j; }
  __syncwarp();
}

// Offer 32 candidates, one per lane, in lane order (= index order).
__device__ __forceinline__ void warp_offer(float* tv, int* ti, int k, float cv, int ci,
                                           int lane) {
  unsigned mask = __ballot_sync(kFull, cv < tv[k - 1]);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float d = __shfl_sync(kFull, cv, src);
    const int j = __shfl_sync(kFull, ci, src);
    if (d < tv[k - 1]) warp_insert(tv, ti, k, d, j, lane);
  }
}

__device__ __forceinline__ void warp_init(float* tv, int* ti, int k, int lane) {
  for (int e = lane; e < k; e += 32) {
    tv[e] = CUDART_INF_F;
    ti[e] = -1;
  }
  __syncwarp();
}

struct __align__(16) PartialSmem {
  union {
    rowtile::TileF32 tile;       // while the distances are computed
    float dist[kQueries][kRows]; // then, while the warps merge them
  };
  float top_val[kQueries][kMaxK];
  int top_idx[kQueries][kMaxK];
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
knn_topk_partial(const float* __restrict__ q, const float* __restrict__ qnorm,
                 const float* __restrict__ x, int nq, int nx, int dim, int k, int chunk_rows,
                 int n_chunks, float* __restrict__ part_val, int* __restrict__ part_idx) {
  __shared__ PartialSmem sm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQueries;
  const int chunk = blockIdx.y;
  const int64_t row_begin = static_cast<int64_t>(chunk) * chunk_rows;
  const int64_t row_end = min(static_cast<int64_t>(nx), row_begin + chunk_rows);
  const bool live_query = q0 + warp < nq;
  float* tv = sm.top_val[warp];
  int* ti = sm.top_idx[warp];

  warp_init(tv, ti, k, lane);
  float qn[kQueries];
  rowtile::load_norms(qnorm, q0, nq, qn);

  for (int64_t r0 = row_begin; r0 < row_end; r0 += kRows) {
    float d2[kQueries];
    rowtile::tile_distances<kVec>(sm.tile, q, x, nullptr, q0, nq, r0, row_end, dim,
                                         qn, d2);
    // tile_distances ends on a barrier: the tile is free to reuse as dist
    const bool live_row = r0 + threadIdx.x < row_end;
#pragma unroll
    for (int i = 0; i < kQueries; ++i) sm.dist[i][threadIdx.x] = live_row ? d2[i] : CUDART_INF_F;
    __syncthreads();
    if (live_query) {
      for (int t0 = 0; t0 < kRows; t0 += 32)
        warp_offer(tv, ti, k, sm.dist[warp][t0 + lane], static_cast<int>(r0) + t0 + lane, lane);
    }
    __syncthreads();  // the next tile's staging overwrites dist
  }
  if (live_query) {
    const int64_t base = ((q0 + warp) * n_chunks + chunk) * k;
    for (int e = lane; e < k; e += 32) {
      part_val[base + e] = tv[e];
      part_idx[base + e] = ti[e];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
knn_topk_merge(const float* __restrict__ part_val, const int* __restrict__ part_idx, int nq,
               int n_chunks, int k, float* __restrict__ out_val, int* __restrict__ out_idx) {
  __shared__ float top_val[kThreads / 32][kMaxK];
  __shared__ int top_idx[kThreads / 32][kMaxK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t qi = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + warp;
  if (qi >= nq) return;  // whole warps only; no block barrier below
  float* tv = top_val[warp];
  int* ti = top_idx[warp];
  warp_init(tv, ti, k, lane);
  const int64_t total = static_cast<int64_t>(n_chunks) * k;
  const float* pv = part_val + qi * total;
  const int* pi = part_idx + qi * total;
  for (int64_t f0 = 0; f0 < total; f0 += 32) {
    const int64_t f = f0 + lane;
    const float cv = f < total ? pv[f] : CUDART_INF_F;
    const int ci = f < total ? pi[f] : -1;
    warp_offer(tv, ti, k, cv, ci, lane);
  }
  for (int e = lane; e < k; e += 32) {
    out_val[qi * k + e] = tv[e];
    out_idx[qi * k + e] = ti[e];
  }
}

}  // namespace

// qnorm: (nq,) scratch; part_val/part_idx: (nq, n_chunks, k) scratch;
// out_val/out_idx: (nq, k).  vec: dim % 4 == 0 and x 16-byte aligned.
extern "C" int knn_topk_f32(const float* q, const float* x, float* qnorm, float* part_val,
                            int* part_idx, float* out_val, int* out_idx, int nq, int nx,
                            int dim, int k, int chunk_rows, int n_chunks, int vec,
                            void* stream) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rowtile::launch_query_norms(q, nq, dim, qnorm, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid1((nq + kQueries - 1) / kQueries, n_chunks);
  if (vec) {
    knn_topk_partial<true><<<grid1, kThreads, 0, s>>>(q, qnorm, x, nq, nx, dim, k, chunk_rows,
                                                      n_chunks, part_val, part_idx);
  } else {
    knn_topk_partial<false><<<grid1, kThreads, 0, s>>>(q, qnorm, x, nq, nx, dim, k,
                                                       chunk_rows, n_chunks, part_val,
                                                       part_idx);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kThreads / 32;
  knn_topk_merge<<<(nq + per_block - 1) / per_block, kThreads, 0, s>>>(
      part_val, part_idx, nq, n_chunks, k, out_val, out_idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
