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
// What bounds them on an H100: operations.  DBSCAN runs each pass with Q = N,
// so a pass computes N^2 distances (10^12 on the 1,000,000-row dataset) and
// reads only the two (N, D) operands and an (N,) label and flag row.  The
// 67 TFLOP/s f32 rate is the roofline, far above what the bytes need; at
// D = 5 what the f32 pipe can issue per pair is what counts.
//
// K3, K4, K5 share one design.  K3 counts over all N columns; K4 and K5 need
// only core columns, so their wrapper compacts them first (the core rows of
// x in ascending index order, and their labels).  eps_core_pack writes each
// column as one aligned row {x_0 .. x_{DC-1}, ||x||^2, label bits (K3: 0),
// 0 ...} of a multiple of 4 floats, with ||x||^2 summed once per call, so
// the main loop has no flag load, no per-column branch, and loads a row with
// float4 reads (two at D = 5).
//
// Each thread keeps R queries in registers (at D = 5, 16 for K3 and K4
// and 8 for K5, which keeps a d2 and an index per query; 8 at D = 8, 4 at
// D <= 20, fewer above) and reads each staged row once for all R, which cuts
// the shared loads per pair R-fold; the column loop is unrolled 8 deep.  At
// D = 5 a pair costs 11 issue slots in K4 (5 FFMA, FADD, FMUL, FADD and
// FMNMX for the distance, then a compare and a predicated min, written in
// PTX: the compiler's own form adds an integer compare), 12 in K5 (a
// compare and two selects) and 9 in K3 (5 FFMA, FADD, one FFMA for the
// expansion, a compare and a predicated add; see ``within``), against the
// 6.5 that the f32 rate's bound counts (2D + 3 = 13 flops, two to an FFMA).
// At D = 20 (4 queries per thread) K3 takes ~25.5 slots a pair (24 and
// six shared float4 loads a column for 4 queries) against the bound's 21.5.
// The grid is two-dimensional: query tiles of 128 R on x, chunks of `chunk`
// columns on y, so even a few hundred query tiles fill the card.  Chunks
// merge exactly and in any order through one atomic per query and chunk:
//   K3  atomicAdd of the chunk's count on the int32 output, which starts at
//       0, skipped where the count is 0 (integer sums are exact in any
//       order);
//   K4  atomicMin on the int32 output, which starts at the sentinel N;
//   K5  atomicMin on a 64-bit key (bits of d2) << 32 | compact index, which
//       starts at INT64_MAX.  d2 = max(., +0) is finite and never -0 here,
//       so its bits order as the values do: the smallest key is the
//       smallest d2 and, among equal d2, the lowest index, argmin's rule.
//       The wrapper maps the key back to (d2, label), INT64_MAX to (+inf, N).
// Inside a chunk a thread scans its columns in ascending order and keeps a
// new best only on a strictly smaller d2, as the plain argmin does.  A read
// of the current output before each atomic skips the atomics that cannot
// lower it (the output only ever decreases, so a stale read is safe).
//
// Widths: the feature width is a template parameter; the paper's widths 5
// and 20 run unpadded, other widths pad to the next of 8, 32, 64 with zeros
// (which add nothing), and a width above 64 reads rows from global memory,
// one query per thread (right for any D, not tuned).
//
// Exactness: the threshold d2 <= eps_sq is a hard decision, so the arithmetic
// is the plain version's and K2's: f32 FMA, never tensor cores or TF32;
// ||q||^2, ||x||^2 and q.x are separate fmaf chains in feature order; the
// epilogue max(||q||^2 + ||x||^2 - 2 q.x, 0) uses round-to-nearest intrinsics
// so the compiler cannot contract it.  Every pair's d2 is therefore the same
// bits in every kernel here, whatever the grid.  K3 decides with the
// expansion fused into one FFMA, !(fmaf(-2, q.x, ||q||^2 + ||x||^2) > eps_sq)
// (``within``): 2 q.x is exact, so the FFMA rounds once to the value the
// subtraction gives; eps_sq >= 0 makes the clamp at 0 irrelevant to the
// decision, and a NaN passes both forms (fmaxf maps it to 0).  The build
// keeps denormals (no -ftz, no --use_fast_math), so both forms see the same
// values.  Indices and counts are int32 (N < 2^31); addresses are computed
// in 64 bits.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block

enum Mode { kMinLabel = 1, kNearestCore = 2, kCount = 3 };

__device__ __forceinline__ float sq_l2(float qn, float xn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(qn, xn), __fmul_rn(2.f, dot)), 0.f);
}

// K3's decision sq_l2(qn, xn, dot) <= eps_sq, with the expansion as one FFMA
// (the header says why the decisions are the same); 1 or 0.
__device__ __forceinline__ int within(float qn, float xn, float dot, float eps_sq) {
  return !(fmaf(-2.f, dot, __fadd_rn(qn, xn)) > eps_sq);
}

// ---------------------------------------------------------------------------
// K3, K4, K5: over the packed columns
// ---------------------------------------------------------------------------

// Features a packed row holds: the padded width, or the width itself above 64.
__host__ __device__ constexpr int padded_dim(int dim) {
  return dim <= 5 ? 5 : dim <= 8 ? 8 : dim <= 20 ? 20 : dim <= 32 ? 32 : dim <= 64 ? 64 : dim;
}

// Floats per packed row: the features, ||x||^2 and the label, to a multiple of 4.
__host__ __device__ constexpr int packed_width(int dc) { return (dc + 2 + 3) / 4 * 4; }

// Queries per thread: as many as the registers allow at each width (K3 and
// K4, which keep one int per query, take 16 at D = 5; K5 keeps two values).
__host__ __device__ constexpr int queries_per_thread(int mode, int dc) {
  return dc == 5 && mode != kNearestCore ? 16 : dc <= 8 ? 8 : dc <= 20 ? 4 : dc <= 32 ? 2 : 1;
}

// One thread per row: copy its features (zero padded to dc), its ||x||^2
// summed by fmaf in feature order, and its label (kLabels; else 0) into the
// packed row.
template <bool kLabels>
__global__ void eps_core_pack(const float* __restrict__ x_core, const int* __restrict__ lab_core,
                              int n_core, int dim, int dc, int width,
                              float* __restrict__ packed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_core) return;
  const float* xr = x_core + (int64_t)i * dim;
  float* out = packed + (int64_t)i * width;
  float n = 0.f;
  for (int d = 0; d < dim; ++d) {
    const float v = xr[d];
    n = fmaf(v, v, n);
    out[d] = v;
  }
  for (int d = dim; d < dc; ++d) out[d] = 0.f;
  out[dc] = n;
  out[dc + 1] = kLabels ? __int_as_float(lab_core[i]) : 0.f;
  for (int d = dc + 2; d < width; ++d) out[d] = 0.f;
}

// out_label is K3's count or K4's label.
template <int MODE>
__device__ __forceinline__ void merge_result(int i, int best_label, float best_d2, int best_j,
                                             int nx, int* out_label,
                                             unsigned long long* out_key) {
  if (MODE == kCount) {
    if (best_label > 0) atomicAdd(out_label + i, best_label);
  } else if (MODE == kMinLabel) {
    if (best_label < nx && best_label < __ldcg(out_label + i)) atomicMin(out_label + i, best_label);
  } else if (best_j >= 0) {
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(best_d2) << 32) | (unsigned)best_j;
    if (key < __ldcg(out_key + i)) atomicMin(out_key + i, key);
  }
}

// Block (query tile of kThreads * R, chunk of packed columns [c0, c1)).
// Thread t holds queries q0 + r * kThreads + t, r < R.  K3 keeps its count
// in best_label.
template <int MODE, int DC>
__global__ void __launch_bounds__(kThreads)
eps_core_kernel(const float* __restrict__ q, const float4* __restrict__ packed,
                float eps_sq, int nq, int nx, int n_core, int dim, int chunk,
                int* __restrict__ out_label, unsigned long long* __restrict__ out_key) {
  constexpr int R = queries_per_thread(MODE, DC);
  constexpr int W = packed_width(DC);
  constexpr int V = W / 4;  // float4 per packed row
  constexpr int kStage = W <= 24 ? 256 : W <= 36 ? 128 : 64;  // rows per shared stage
  __shared__ float4 xs[kStage * V];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * (kThreads * R);
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(c0 + chunk, n_core);

  float qr[R][DC];
  float qn[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + r * kThreads + tid;
    const float* qrow = q + (int64_t)(i < nq ? i : 0) * dim;
#pragma unroll
    for (int d = 0; d < DC; ++d) qr[r][d] = (i < nq && d < dim) ? qrow[d] : 0.f;
    qn[r] = 0.f;
#pragma unroll
    for (int d = 0; d < DC; ++d) qn[r] = fmaf(qr[r][d], qr[r][d], qn[r]);
  }

  int best_label[R];
  float best_d2[R];
  int best_j[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best_label[r] = MODE == kCount ? 0 : nx;  // K4: the sentinel
    best_d2[r] = CUDART_INF_F;
    best_j[r] = -1;
  }

  for (int t0 = c0; t0 < c1; t0 += kStage) {
    const int rows = min(kStage, c1 - t0);
    __syncthreads();  // the previous stage is consumed
    const float4* src = packed + (int64_t)t0 * V;
    for (int e = tid; e < rows * V; e += kThreads) xs[e] = src[e];
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < rows; ++j) {
      float xr[W];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float4 f = xs[j * V + v];  // the same address in every thread: a broadcast
        xr[4 * v] = f.x;
        xr[4 * v + 1] = f.y;
        xr[4 * v + 2] = f.z;
        xr[4 * v + 3] = f.w;
      }
      const float xn = xr[DC];
      const int lab = __float_as_int(xr[DC + 1]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DC; ++d) dot = fmaf(qr[r][d], xr[d], dot);
        if (MODE == kCount) {
          // if !(fmaf(-2, dot, qn + xn) > eps_sq) ++count, as one compare
          // (unordered or <=) and one predicated add
          const float v = fmaf(-2.f, dot, __fadd_rn(qn[r], xn));
          asm("{\n\t.reg .pred p;\n\tsetp.leu.f32 p, %1, %2;\n\t@p add.s32 %0, %0, 1;\n\t}"
              : "+r"(best_label[r])
              : "f"(v), "f"(eps_sq));
          continue;
        }
        const float d2 = sq_l2(qn[r], xn, dot);
        if (MODE == kMinLabel) {
          // if (d2 <= eps_sq) best = min(best, lab), as one compare and one
          // predicated min (the compiler's own form is a compare, an integer
          // compare and a select: one issue slot more per pair)
          asm("{\n\t.reg .pred p;\n\tsetp.le.f32 p, %1, %2;\n\t@p min.s32 %0, %0, %3;\n\t}"
              : "+r"(best_label[r])
              : "f"(d2), "f"(eps_sq), "r"(lab));
        } else if (d2 < best_d2[r]) {  // strict: the first index keeps a tie
          best_d2[r] = d2;
          best_j[r] = t0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + r * kThreads + tid;
    if (i < nq) merge_result<MODE>(i, best_label[r], best_d2[r], best_j[r], nx, out_label, out_key);
  }
}

// Any width: one query per thread, q and the packed rows read from global
// memory (every thread of a block reads the same row: an L1 broadcast).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
eps_core_kernel_any(const float* __restrict__ q, const float* __restrict__ packed,
                    float eps_sq, int nq, int nx, int n_core, int dim, int chunk,
                    int* __restrict__ out_label, unsigned long long* __restrict__ out_key) {
  const int width = packed_width(dim);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= nq) return;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(c0 + chunk, n_core);
  const float* qrow = q + (int64_t)i * dim;
  float qn = 0.f;
  for (int d = 0; d < dim; ++d) qn = fmaf(qrow[d], qrow[d], qn);
  int best_label = MODE == kCount ? 0 : nx;
  float best_d2 = CUDART_INF_F;
  int best_j = -1;
  for (int j = c0; j < c1; ++j) {
    const float* xr = packed + (int64_t)j * width;
    float dot = 0.f;
    for (int d = 0; d < dim; ++d) dot = fmaf(qrow[d], __ldg(xr + d), dot);
    if (MODE == kCount) {
      best_label += within(qn, __ldg(xr + dim), dot, eps_sq);
      continue;
    }
    const float d2 = sq_l2(qn, __ldg(xr + dim), dot);
    if (MODE == kMinLabel) {
      if (d2 <= eps_sq) best_label = min(best_label, __float_as_int(__ldg(xr + dim + 1)));
    } else if (d2 < best_d2) {
      best_d2 = d2;
      best_j = j;
    }
  }
  merge_result<MODE>(i, best_label, best_d2, best_j, nx, out_label, out_key);
}

// The pack, then the main kernel over grid (query tiles, column chunks), which
// it writes to grid_used.
template <int MODE>
int launch_core(const float* q, const float* x_core, const int* lab_core, float* packed,
                float eps_sq, int nq, int nx, int n_core, int dim, int chunk,
                int* out_label, unsigned long long* out_key, int* grid_used, cudaStream_t s) {
  const int dc = padded_dim(dim);
  if (n_core > 0) {
    if (MODE == kCount)
      eps_core_pack<false><<<(n_core + 255) / 256, 256, 0, s>>>(x_core, lab_core, n_core, dim,
                                                                dc, packed_width(dc), packed);
    else
      eps_core_pack<true><<<(n_core + 255) / 256, 256, 0, s>>>(x_core, lab_core, n_core, dim,
                                                               dc, packed_width(dc), packed);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int chunks = n_core > 0 ? (n_core + chunk - 1) / chunk : 1;
  const int per_block = kThreads * (dim <= 64 ? queries_per_thread(MODE, dc) : 1);
  const dim3 grid((nq + per_block - 1) / per_block, chunks);
  grid_used[0] = (int)grid.x;
  grid_used[1] = (int)grid.y;
#define EPS_LAUNCH(DC)                                                              \
  eps_core_kernel<MODE, DC><<<grid, kThreads, 0, s>>>(                              \
      q, reinterpret_cast<const float4*>(packed), eps_sq, nq, nx, n_core, dim, chunk, \
      out_label, out_key)
  if (dc == 5) EPS_LAUNCH(5);
  else if (dc == 8) EPS_LAUNCH(8);
  else if (dc == 20) EPS_LAUNCH(20);
  else if (dc == 32) EPS_LAUNCH(32);
  else if (dc == 64) EPS_LAUNCH(64);
  else
    eps_core_kernel_any<MODE><<<grid, kThreads, 0, s>>>(q, packed, eps_sq, nq, nx, n_core,
                                                        dim, chunk, out_label, out_key);
#undef EPS_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// out starts at 0; the wrapper fills it.  All nx rows of x are packed.
extern "C" int eps_count_f32(const float* q, const float* x, float* packed, float eps_sq,
                             int* out, int nq, int nx, int dim, int chunk, int* grid_used,
                             void* stream) {
  return launch_core<kCount>(q, x, nullptr, packed, eps_sq, nq, nx, nx, dim, chunk, out,
                             nullptr, grid_used, (cudaStream_t)stream);
}

// Floats per packed row at width dim (the wrapper allocates the scratch).
extern "C" int eps_packed_width(int dim) { return packed_width(padded_dim(dim)); }

// out starts at nx (the sentinel); the wrapper fills it.
extern "C" int eps_min_label_f32(const float* q, const float* x_core, const int* lab_core,
                                 float* packed, float eps_sq, int* out, int nq, int nx,
                                 int n_core, int dim, int chunk, int* grid_used,
                                 void* stream) {
  return launch_core<kMinLabel>(q, x_core, lab_core, packed, eps_sq, nq, nx, n_core, dim,
                                chunk, out, nullptr, grid_used, (cudaStream_t)stream);
}

// keys start at INT64_MAX; the wrapper fills them and unpacks the result.
extern "C" int eps_nearest_core_f32(const float* q, const float* x_core, const int* lab_core,
                                    float* packed, unsigned long long* keys, int nq, int nx,
                                    int n_core, int dim, int chunk, int* grid_used,
                                    void* stream) {
  return launch_core<kNearestCore>(q, x_core, lab_core, packed, 0.f, nq, nx, n_core, dim,
                                   chunk, nullptr, keys, grid_used, (cudaStream_t)stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
