// K6: fused squared-L2 distance + per-query top-k over a flat datastore,
// q (Q, D) f32 against x (N, D) f32 -> (Q, k) f32 ascending and (Q, k) i32
// row indices; the (Q, N) distance matrix never reaches device memory.
//
// Replaces the TPU kernel repro/kernels/topk.py::knn_topk_pallas (body
// _knn_topk_kernel).  The contract is the plain version's
// (repro_torch/kernels/ref.py::knn_topk_ref): the k smallest per query in
// the lexicographic order of (d2, row index), so an exact tie goes to the
// lower row, and (+inf, -1) past the end when N < k.  1 <= k <= 64.
//
// What bounds it on an H100.  At decode batch (the kNN-LM engine sends
// Q = num_slots, 8 by default) bytes: a 2^20 x 896 f32 shard is 3.76 GB to
// read once against 2QND = 15 GFLOP, ~1.1 ms at 3.35 TB/s.  From Q ~ 150 up
// the f32 FMA rate: at Q = 1024 the same shard is 1.9 TFLOP, ~29 ms.
//
// One launch a call, in one of two block shapes (the wrapper's planner,
// kernels/topk.py::plan, picks it by Q and sizes the grid):
//
// * stream (Q <= 32): a block holds all the queries (8, 16 or 32, padded
//   with zeros) and a 256-row tile, one row per thread; the grid is one
//   block per resident slot (two an SM at Q <= 8, with a ring of two
//   stages each; one at 16 and 32, whose registers allow one, with four),
//   each block owning one contiguous, ascending range of rows, so every
//   row is read from device memory once for all the queries.
// * tiled (Q > 32): a register-tiled SIMT product.  A block of 128 threads
//   computes 32 queries x 128 rows, each thread 4 queries x 8 rows in
//   registers, so a staged slice is read from shared memory once per 4
//   queries (or 8 rows) and not once per query; two blocks an SM.  The
//   grid is (query tiles, row ranges), whole waves of at least two, the
//   query tiles fastest so the blocks sharing a range run together and
//   read it from device memory about once.
//
// Both stream their range through a ring of kStages buffers in shared
// memory, each 32 features of the tile's rows and of the block's queries,
// filled by cp.async (16 bytes a copy; 4 where D % 4 != 0 or an operand is
// not 16-byte aligned): while stage s is computed, stages s+1 .. s+kStages-1
// are in flight, across tile boundaries too.  ||q||^2 is summed from the
// same staged slices during a block's first tile, ||x||^2 once a stage per
// row (not once per query tile).  At a tile's end the (queries, rows) d2
// go to shared memory, each thread marks the 32-row chunks that hold a row
// below a query's current k-th, and warp w merges query w's (w + warps,
// ...) marked chunks into its running top-k: the list sits in the warp's
// registers for the turn (two entries a lane, inserted by shuffles) and in
// shared memory between turns; a ballot keeps the candidates below the
// current k-th, refreshed after each insertion, and each survivor is
// inserted after every entry <= it.  Rows arrive in index order, so "after
// every equal value" is the lower-row-first tie order.
//
// The merge across row ranges is in the same launch: each block writes its
// partial lists, and the block of a query tile that finishes last (an
// atomic ticket after __threadfence) merges the tile's lists in range
// order by the same insertion, which keeps the tie order (every row of a
// later range has a larger index).  The tickets are one counter a query
// tile, zero between calls: the merging block puts its counter back to
// zero.  The wrapper caches the counters per (device, stream), so two
// streams never share one and calls on one stream run one after another.
//
// Arithmetic (tools/compare_prev_k6.py holds it bit for bit to the
// three-launch build of commit 38197a8): ||q||^2, ||x||^2 and q.x are
// separate f32 FMA chains in feature order within each 32-feature stage
// (zeros past D add nothing), the stage totals carried in f64 and rounded
// to f32 once; the epilogue is rowtile::sq_l2, the plain
// version's max(||q||^2 + ||x||^2 - 2 q.x, 0), uncontracted.  No tensor
// cores and no TF32.  On rows where every product and partial sum is exact
// (a 1/8 grid) the result equals the plain version bit for bit.
//
// Indices are int32 (N < 2^31); addresses are computed in 64 bits.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "row_tile.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDChunk = 32;           // features a stage: the span of one f32 chain
constexpr int kStride = kDChunk + 4;  // floats between staged rows: float4 reads conflict-free
constexpr int kMergeBatch = 16;       // candidates a lane loads ahead in the range merge

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A running top-k of one query, held by one warp in registers while it
// takes candidates: lane e holds entries e and e + 32 (value and row),
// ascending; lanes past k are never read.  It lives in shared memory
// between a warp's turns (list_load / list_store).
struct WarpList {
  float v0, v1;
  int i0, i1;
};

__device__ __forceinline__ WarpList list_load(const float* tv, const int* ti, int k, int lane) {
  WarpList l;
  l.v0 = lane < k ? tv[lane] : CUDART_INF_F;
  l.i0 = lane < k ? ti[lane] : -1;
  l.v1 = lane + 32 < k ? tv[lane + 32] : CUDART_INF_F;
  l.i1 = lane + 32 < k ? ti[lane + 32] : -1;
  return l;
}

__device__ __forceinline__ void list_store(const WarpList& l, float* tv, int* ti, int k,
                                           int lane) {
  if (lane < k) {
    tv[lane] = l.v0;
    ti[lane] = l.i0;
  }
  if (lane + 32 < k) {
    tv[lane + 32] = l.v1;
    ti[lane + 32] = l.i1;
  }
  __syncwarp();
}

// The current k-th value, in every lane.
__device__ __forceinline__ float list_kth(const WarpList& l, int k) {
  return __shfl_sync(kFull, k > 32 ? l.v1 : l.v0, (k - 1) & 31);
}

// Insert (d, j) after every entry whose value is <= d (the caller has
// checked d < the k-th); every lane calls with the same (d, j).
__device__ __forceinline__ void list_insert(WarpList& l, int k, float d, int j, int lane) {
  const int pos = __popc(__ballot_sync(kFull, lane < k && l.v0 <= d)) +
                  __popc(__ballot_sync(kFull, lane + 32 < k && l.v1 <= d));
  const float up0 = __shfl_up_sync(kFull, l.v0, 1);
  const int ui0 = __shfl_up_sync(kFull, l.i0, 1);
  float up1 = __shfl_up_sync(kFull, l.v1, 1);
  int ui1 = __shfl_up_sync(kFull, l.i1, 1);
  const float top0 = __shfl_sync(kFull, l.v0, 31);  // entry 31 moves to entry 32
  const int topi0 = __shfl_sync(kFull, l.i0, 31);
  if (lane == 0) {
    up1 = top0;
    ui1 = topi0;
  }
  if (lane == pos) {
    l.v0 = d;
    l.i0 = j;
  } else if (lane > pos) {
    l.v0 = up0;
    l.i0 = ui0;
  }
  if (lane + 32 == pos) {
    l.v1 = d;
    l.i1 = j;
  } else if (lane + 32 > pos) {
    l.v1 = up1;
    l.i1 = ui1;
  }
}

// Offer 32 candidates, one per lane, in lane order (= index order): each
// one still below the k-th when its turn comes is inserted.  ``kth`` is the
// list's k-th value, kept current.
__device__ __forceinline__ void list_offer(WarpList& l, float& kth, int k, float cv, int ci,
                                           int lane) {
  unsigned mask = __ballot_sync(kFull, cv < kth);
  while (mask) {
    const int src = __ffs(mask) - 1;
    const float d = __shfl_sync(kFull, cv, src);
    const int j = __shfl_sync(kFull, ci, src);
    list_insert(l, k, d, j, lane);
    kth = list_kth(l, k);
    mask &= __ballot_sync(kFull, cv < kth) & ~((2u << src) - 1u);  // lanes past src only
  }
}

__device__ __forceinline__ void warp_init(float* tv, int* ti, int k, int lane) {
  for (int e = lane; e < k; e += 32) {
    tv[e] = CUDART_INF_F;
    ti[e] = -1;
  }
  __syncwarp();
}

// A block shape: BQ queries x BR rows a tile, each thread TQ queries x TR
// rows (queries tq + i * BQ/TQ, rows tr + j * BR/TR), Stages ring buffers,
// at least MinBlocks resident an SM (the register budget).
template <int BQ, int TQ, int BR, int TR, int Stages, int MinBlocks>
struct Shape {
  static constexpr int kBQ = BQ, kTQ = TQ, kBR = BR, kTR = TR;
  static constexpr int kStages = Stages, kMinBlocks = MinBlocks;
  static constexpr int kRowThreads = BR / TR;
  static constexpr int kQThreads = BQ / TQ;
  static constexpr int kThreads = kRowThreads * kQThreads;
  static constexpr int kWarps = kThreads / 32;
  // one thread column (stream): each thread owns whole rows and sums their
  // ||x||^2 itself; else threads [0, BR) sum one row each
  static constexpr bool kOwnRows = kQThreads == 1;
  // threads [base, base + BQ) sum ||q||^2 (past the row-norm threads if they fit)
  static constexpr int kQnBase = kOwnRows || BR + BQ > kThreads ? 0 : BR;
  static constexpr int kDStride = BR + 16;            // the d2 tile's row stride
  static constexpr int kStageFloats = (BR + BQ) * kStride;
  // lanes that share a query and whose rows lie in one 32-row chunk
  static constexpr int kGroup = kRowThreads < 32 ? kRowThreads : 32;
  static constexpr unsigned kGroupMask = kGroup == 32 ? ~0u : (1u << kGroup) - 1;
  static_assert(kThreads % 32 == 0 && kQnBase + BQ <= kThreads, "shape");
  static_assert(kOwnRows || BR <= kThreads, "shape");
  static_assert(kRowThreads % 32 == 0 || 32 % kRowThreads == 0, "shape");
  static_assert(BR % 32 == 0 && BR <= 32 * 32, "a chunk mask is one word");

  // dynamic shared memory: ring, d2 tile, row and query norms, the running
  // top-k lists (k entries a query), the chunk marks, the last-block flag
  static constexpr int smem_bytes(int k) {
    return 4 * (Stages * kStageFloats + BQ * kDStride + BR + 2 * BQ + 2 * BQ * k) + 16;
  }
};

// The shapes the planner chooses from, by index (kernels/topk.py::SHAPES
// mirrors this table).
using Stream8 = Shape<8, 8, 256, 1, 2, 2>;
using Stream16 = Shape<16, 16, 256, 1, 4, 1>;
using Stream32 = Shape<32, 32, 256, 1, 4, 1>;
using Tiled = Shape<32, 4, 128, 8, 2, 2>;

// Features [d0, d0 + 32) of rows [r0, r0 + BR) (zeros at and past r_end)
// and of queries [q0, q0 + BQ) (zeros past nq) into one ring buffer, zeros
// past dim.  Asynchronous: the caller commits the group.
template <class S, bool kVec>
__device__ __forceinline__ void load_stage(float* xs, const float* __restrict__ q,
                                           const float* __restrict__ x, int64_t q0, int nq,
                                           int64_t r0, int64_t r_end, int dim, int d0) {
  float* qs = xs + S::kBR * kStride;
  if (kVec) {
    constexpr int kRowUnits = S::kBR * (kDChunk / 4);
    constexpr int kQUnits = S::kBQ * (kDChunk / 4);
#pragma unroll
    for (int j = 0; j < (kRowUnits + S::kThreads - 1) / S::kThreads; ++j) {
      const int u = threadIdx.x + j * S::kThreads;
      if (kRowUnits % S::kThreads != 0 && u >= kRowUnits) break;
      const int r = u >> 3;
      const int c = (u & 7) * 4;
      const int64_t row = r0 + r;
      const bool live = row < r_end && d0 + c < dim;
      rowtile::cp_async16(xs + r * kStride + c, live ? x + row * dim + d0 + c : x, live);
    }
#pragma unroll
    for (int j = 0; j < (kQUnits + S::kThreads - 1) / S::kThreads; ++j) {
      const int u = threadIdx.x + j * S::kThreads;
      if (kQUnits % S::kThreads != 0 && u >= kQUnits) break;
      const int i = u >> 3;
      const int c = (u & 7) * 4;
      const bool live = q0 + i < nq && d0 + c < dim;
      rowtile::cp_async16(qs + i * kStride + c, live ? q + (q0 + i) * dim + d0 + c : q, live);
    }
  } else {
    for (int e = threadIdx.x; e < S::kBR * kDChunk; e += S::kThreads) {
      const int r = e / kDChunk;
      const int c = e % kDChunk;
      const int64_t row = r0 + r;
      const bool live = row < r_end && d0 + c < dim;
      rowtile::cp_async4(xs + r * kStride + c, live ? x + row * dim + d0 + c : x, live);
    }
    for (int e = threadIdx.x; e < S::kBQ * kDChunk; e += S::kThreads) {
      const int i = e / kDChunk;
      const int c = e % kDChunk;
      const bool live = q0 + i < nq && d0 + c < dim;
      rowtile::cp_async4(qs + i * kStride + c, live ? q + (q0 + i) * dim + d0 + c : q, live);
    }
  }
}

// ||v||^2 of one staged row or query slice: 32 FMAs in feature order.
__device__ __forceinline__ float stage_norm(const float* v) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kDChunk; c += 4) {
    const float4 a = ld4(v + c);
    acc = fmaf(a.x, a.x, acc);
    acc = fmaf(a.y, a.y, acc);
    acc = fmaf(a.z, a.z, acc);
    acc = fmaf(a.w, a.w, acc);
  }
  return acc;
}

// The thread's TQ x TR stage dots (and, with kOwnRows, its rows' ||x||^2)
// over one staged buffer.  The smaller of the two operand sets is held in
// registers for a 4-feature step and the other streamed past it.
template <class S>
__device__ __forceinline__ void stage_dots(const float* xs, const float* qs, int tq, int tr,
                                           float (&acc)[S::kTQ][S::kTR],
                                           float (&xacc)[S::kTR]) {
#pragma unroll
  for (int i = 0; i < S::kTQ; ++i)
#pragma unroll
    for (int j = 0; j < S::kTR; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int j = 0; j < S::kTR; ++j) xacc[j] = 0.f;
  const float* xrow = xs + tr * kStride;
  const float* qrow = qs + tq * kStride;
  constexpr int kXStep = S::kRowThreads * kStride;  // floats between a thread's rows
  constexpr int kQStep = S::kQThreads * kStride;    // ... and between its queries
#pragma unroll
  for (int c = 0; c < kDChunk; c += 4) {
    if constexpr (S::kTR <= S::kTQ) {
      float4 xv[S::kTR];
#pragma unroll
      for (int j = 0; j < S::kTR; ++j) {
        xv[j] = ld4(xrow + j * kXStep + c);
        if constexpr (S::kOwnRows) {
          xacc[j] = fmaf(xv[j].x, xv[j].x, xacc[j]);
          xacc[j] = fmaf(xv[j].y, xv[j].y, xacc[j]);
          xacc[j] = fmaf(xv[j].z, xv[j].z, xacc[j]);
          xacc[j] = fmaf(xv[j].w, xv[j].w, xacc[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < S::kTQ; ++i) {
        const float4 qv = ld4(qrow + i * kQStep + c);
#pragma unroll
        for (int j = 0; j < S::kTR; ++j) {
          acc[i][j] = fmaf(qv.x, xv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv.y, xv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv.z, xv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv.w, xv[j].w, acc[i][j]);
        }
      }
    } else {
      static_assert(!S::kOwnRows, "a thread owning whole rows holds them");
      float4 qv[S::kTQ];
#pragma unroll
      for (int i = 0; i < S::kTQ; ++i) qv[i] = ld4(qrow + i * kQStep + c);
#pragma unroll
      for (int j = 0; j < S::kTR; ++j) {
        const float4 xv = ld4(xrow + j * kXStep + c);
#pragma unroll
        for (int i = 0; i < S::kTQ; ++i) {
          acc[i][j] = fmaf(qv[i].x, xv.x, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, xv.y, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, xv.z, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, xv.w, acc[i][j]);
        }
      }
    }
  }
}

// grid (query tiles, row ranges).  Range b of R holds rows
// [b * N / R, (b + 1) * N / R).  part_val / part_idx: (nq, R, k) scratch;
// tickets: one zeroed counter a query tile.
template <class S, bool kVec>
__global__ void __launch_bounds__(S::kThreads, S::kMinBlocks)
knn_topk_ranges(const float* __restrict__ q, const float* __restrict__ x, int nq, int nx,
                int dim, int k, float* __restrict__ part_val, int* __restrict__ part_idx,
                unsigned* __restrict__ tickets, float* __restrict__ out_val,
                int* __restrict__ out_idx) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* dist = ring + S::kStages * S::kStageFloats;
  float* xnorm = dist + S::kBQ * S::kDStride;
  float* qnorm = xnorm + S::kBR;
  float* top_val = qnorm + S::kBQ;
  int* top_idx = reinterpret_cast<int*>(top_val + S::kBQ * k);
  unsigned* chunks = reinterpret_cast<unsigned*>(top_idx + S::kBQ * k);
  int* last = reinterpret_cast<int*>(chunks + S::kBQ);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tr = tid % S::kRowThreads;
  const int tq = tid / S::kRowThreads;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * S::kBQ;
  const int live_q = static_cast<int>(min(static_cast<int64_t>(S::kBQ), nq - q0));
  const int ranges = gridDim.y;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * nx / ranges;
  const int64_t r_end = static_cast<int64_t>(blockIdx.y + 1) * nx / ranges;
  const int n_dc = (dim + kDChunk - 1) / kDChunk;
  const int64_t total = (r_end - r_begin + S::kBR - 1) / S::kBR * n_dc;  // stages
  const bool qn_thread = tid >= S::kQnBase && tid < S::kQnBase + S::kBQ;
  const int qn_row = tid - S::kQnBase;

  for (int i = warp; i < S::kBQ; i += S::kWarps) warp_init(top_val + i * k, top_idx + i * k, k, lane);
  if (tid < S::kBQ) chunks[tid] = 0u;

  // the next stage to load: its count, ring slot, first row and feature
  // chunk (kept as counters: a 64-bit division a stage costs ~100 instructions)
  int64_t l_count = 0, l_row = r_begin;
  int l_slot = 0, l_dc = 0;
  auto load_next = [&]() {
    if (l_count < total)
      load_stage<S, kVec>(ring + l_slot * S::kStageFloats, q, x, q0, nq, l_row, r_end, dim,
                          l_dc * kDChunk);
    commit();  // an empty group past the end keeps the count uniform
    ++l_count;
    l_slot = l_slot + 1 == S::kStages ? 0 : l_slot + 1;
    if (++l_dc == n_dc) {
      l_dc = 0;
      l_row += S::kBR;
    }
  };
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) load_next();

  double tot[S::kTQ][S::kTR];
  double xtot[S::kTR];
#pragma unroll
  for (int j = 0; j < S::kTR; ++j) {
    xtot[j] = 0.0;
#pragma unroll
    for (int i = 0; i < S::kTQ; ++i) tot[i][j] = 0.0;
  }
  double qtot = 0.0;

  int64_t r0 = r_begin;  // the computed stage's first row, ring slot and feature chunk
  int slot = 0, dc = -1;
  for (int64_t it = 0; it < total; ++it) {
    if (++dc == n_dc) {
      dc = 0;
      r0 += S::kBR;
    }
    wait_pending<S::kStages - 2>();
    __syncthreads();  // stage it has landed; every thread is done with stage it - 1
    load_next();      // stage it + kStages - 1, into the slot stage it - 1 held
    const float* xs = ring + slot * S::kStageFloats;
    const float* qs = xs + S::kBR * kStride;
    slot = slot + 1 == S::kStages ? 0 : slot + 1;
    const bool first_tile = r0 == r_begin;
    const bool tile_end = dc == n_dc - 1;

    float acc[S::kTQ][S::kTR];
    float xacc[S::kTR];
    stage_dots<S>(xs, qs, tq, tr, acc, xacc);
#pragma unroll
    for (int j = 0; j < S::kTR; ++j) {
#pragma unroll
      for (int i = 0; i < S::kTQ; ++i) tot[i][j] += static_cast<double>(acc[i][j]);
      if (S::kOwnRows) xtot[j] += static_cast<double>(xacc[j]);
    }
    if (!S::kOwnRows && tid < S::kBR) xtot[0] += static_cast<double>(stage_norm(xs + tid * kStride));
    if (first_tile && qn_thread) qtot += static_cast<double>(stage_norm(qs + qn_row * kStride));
    if (!tile_end) continue;

    // the tile's d2 into shared memory, with a bit per query and 32-row
    // chunk that holds a row below the query's current k-th; then each warp
    // merges its queries' marked chunks, in row order
    if (first_tile && qn_thread) qnorm[qn_row] = __double2float_rn(qtot);
    if (!S::kOwnRows && tid < S::kBR) {
      xnorm[tid] = __double2float_rn(xtot[0]);
      xtot[0] = 0.0;
    }
    __syncthreads();
    float kth[S::kTQ];
#pragma unroll
    for (int i = 0; i < S::kTQ; ++i) kth[i] = top_val[(tq + i * S::kQThreads) * k + k - 1];
#pragma unroll
    for (int j = 0; j < S::kTR; ++j) {
      const int row = tr + j * S::kRowThreads;
      const float xn = S::kOwnRows ? __double2float_rn(xtot[j]) : xnorm[row];
      const bool live_row = r0 + row < r_end;
#pragma unroll
      for (int i = 0; i < S::kTQ; ++i) {
        const int qi = tq + i * S::kQThreads;
        const float d2 = live_row ? rowtile::sq_l2(qnorm[qi], xn, __double2float_rn(tot[i][j]))
                                  : CUDART_INF_F;
        dist[qi * S::kDStride + row] = d2;
        tot[i][j] = 0.0;
        // the lanes of a group share qi and the chunk of their rows
        const unsigned hit = __ballot_sync(kFull, qi < live_q && d2 < kth[i]);
        if (lane % S::kGroup == 0 && (hit & (S::kGroupMask << lane)))
          atomicOr(chunks + qi, 1u << (row >> 5));
      }
      if (S::kOwnRows) xtot[j] = 0.0;
    }
    __syncthreads();
    for (int i = warp; i < live_q; i += S::kWarps) {
      const unsigned marked = chunks[i];
      __syncwarp();
      if (lane == 0) chunks[i] = 0u;
      if (!marked) continue;
      WarpList l = list_load(top_val + i * k, top_idx + i * k, k, lane);
      float kth = list_kth(l, k);
      for (unsigned m = marked; m; m &= m - 1) {
        const int t0 = 32 * (__ffs(m) - 1);
        list_offer(l, kth, k, dist[i * S::kDStride + t0 + lane],
                   static_cast<int>(r0 + t0 + lane), lane);
      }
      list_store(l, top_val + i * k, top_idx + i * k, k, lane);
    }
    // the next write of dist, the marks or the norms follows the next
    // loop-top barrier
  }
  wait_pending<0>();

  for (int i = warp; i < live_q; i += S::kWarps) {
    const int64_t base = ((q0 + i) * ranges + blockIdx.y) * k;
    for (int e = lane; e < k; e += 32) {
      part_val[base + e] = top_val[i * k + e];
      part_idx[base + e] = top_idx[i * k + e];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(tickets + blockIdx.x, 1u) == static_cast<unsigned>(ranges - 1);
  __syncthreads();
  if (!*last) return;
  __threadfence();

  // the last block of the query tile: merge its queries' lists in range order
  const int64_t n = static_cast<int64_t>(ranges) * k;
  for (int i = warp; i < live_q; i += S::kWarps) {
    WarpList l{CUDART_INF_F, CUDART_INF_F, -1, -1};
    float kth = CUDART_INF_F;
    const float* pv = part_val + (q0 + i) * n;
    const int* pi = part_idx + (q0 + i) * n;
    for (int64_t f0 = 0; f0 < n; f0 += 32 * kMergeBatch) {
      float cv[kMergeBatch];
      int ci[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const int64_t f = f0 + 32 * u + lane;
        cv[u] = f < n ? __ldcg(pv + f) : CUDART_INF_F;
        ci[u] = f < n ? __ldcg(pi + f) : -1;
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) list_offer(l, kth, k, cv[u], ci[u], lane);
    }
    list_store(l, out_val + (q0 + i) * k, out_idx + (q0 + i) * k, k, lane);
  }
  if (tid == 0) tickets[blockIdx.x] = 0u;  // ready for the next call on this stream
}

template <class S>
int launch(const float* q, const float* x, float* part_val, int* part_idx, unsigned* tickets,
           float* out_val, int* out_idx, int nq, int nx, int dim, int k, int ranges, int vec,
           cudaStream_t s) {
  auto kernel = vec ? knn_topk_ranges<S, true> : knn_topk_ranges<S, false>;
  const int smem = S::smem_bytes(k);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + S::kBQ - 1) / S::kBQ, ranges);
  kernel<<<grid, S::kThreads, smem, s>>>(q, x, nq, nx, dim, k, part_val, part_idx, tickets,
                                         out_val, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of block shape ``shape`` at ``k`` (the planner's
// number, held against this by the card tests); -1 for an unknown shape.
extern "C" int knn_topk_smem(int shape, int k) {
  switch (shape) {
    case 0: return Stream8::smem_bytes(k);
    case 1: return Stream16::smem_bytes(k);
    case 2: return Stream32::smem_bytes(k);
    case 3: return Tiled::smem_bytes(k);
    default: return -1;
  }
}

// One launch: block shape ``shape`` (0-2 stream at 8/16/32 queries, 3
// tiled), ``ranges`` row ranges.  part_val/part_idx: (nq, ranges, k)
// scratch; tickets: ceil(nq / block queries) counters, zero on entry and
// on return; out_val/out_idx: (nq, k).  vec: dim % 4 == 0 and q, x 16-byte
// aligned.
extern "C" int knn_topk_f32(const float* q, const float* x, float* part_val, int* part_idx,
                            unsigned* tickets, float* out_val, int* out_idx, int nq, int nx,
                            int dim, int k, int shape, int ranges, int vec, void* stream) {
  if (k < 1 || k > kMaxK || ranges < 1 || ranges > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch_as = [&](auto shape_tag) {
    using S = decltype(shape_tag);
    return launch<S>(q, x, part_val, part_idx, tickets, out_val, out_idx, nq, nx, dim, k,
                     ranges, vec, s);
  };
  switch (shape) {
    case 0: return launch_as(Stream8{});
    case 1: return launch_as(Stream16{});
    case 2: return launch_as(Stream32{});
    case 3: return launch_as(Tiled{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
