// K7: squared-L2 distances of f32 queries against an int8 datastore with
// per-row f32 scales, q (Q, D) f32, x_q (N, D) i8, scale (N,) f32 ->
// (Q, N) f32.
//
// Replaces the TPU kernel repro/kernels/pairwise_l2.py::
// pairwise_sq_l2_int8_pallas (body _pairwise_int8_kernel).  The contract is
// the plain version's (repro_torch/kernels/ref.py::pairwise_sq_l2_int8_ref):
// row j dequantizes per element to float(x_q[j, d]) * scale[j] (one
// rounding; never scale^2 * sum x_q^2, which rounds differently), then
// max(||q||^2 + ||x||^2 - 2 q.x, 0).
//
// What bounds it on an H100: bytes, nearly matched by operations.  At decode
// (Q = 8, N = 2^20, D = 896) it reads 0.94 GB of int8 rows (4x fewer bytes
// than the f32 datastore) and writes the 33.5 MB (Q, N) matrix: ~0.29 ms at
// 3.35 TB/s, against 15 GFLOP of f32 work (~0.22 ms at 67 TFLOP/s).  So the
// copies must run while the block computes, and each row-feature must cost
// few issue slots: the distance FFMAs alone are 8 of them.
//
// Design.  ||q||^2 once per call in a pre-pass (rowtile::query_norms).  Then
// blocks of 2 warps over (8 queries, 256 rows), the query tile fastest in
// the grid so the blocks that share rows run together and read them once
// from device memory.  Each warp owns 128 rows (lane l: rows l + 32 r,
// r < 4, the 8 x 4 dot products in registers) and its own ring of kStages
// buffers in shared memory: while it computes stage k (32 features), its
// 16-byte cp.async copies of stage k + 2 (its rows' bytes and the 8
// queries' floats) are in flight.  Copies and reads meet at __syncwarp, so
// no warp waits on a block barrier.  Rows sit 48 bytes apart in a buffer
// (three 16-byte units, odd), so a warp's 16-byte row reads fall in
// distinct banks; the query reads are broadcasts.  A block takes 42 KB of
// shared memory; five fit an SM.
//
// Issue slots per 128 row-features (4 rows x 32 features) of one thread:
//   8 LDS.128 for the row bytes, 64 broadcast LDS.128 for the query slices
//   (each serves all 4 rows); int8 -> f32: one byte of each word by I2F and
//   three by the byte xor 0x80 placed in the mantissa of 2^23 minus
//   2^23 + 128 (exact; 32 LOP3, 96 PRMT, 96 FADD, 32 I2F: I2F runs at a
//   quarter of the rate, so only one byte in four takes it); 128 FMUL (the
//   dequantizing multiply); 128 FFMA (||x||^2); 1,024 FFMA (q.x); 36 FADD to
//   carry the stage's sums; and the copies and the loop: 1,769 in the
//   compiled loop, 13.8 a row-feature, 8 of them the q.x FFMAs.
//
// Arithmetic: f32 FMA products, never tensor cores or TF32; ||x||^2 and q.x
// are separate sums in feature order, in f32 within each 32-feature stage,
// and the stage sums added in f32 in stage order; the epilogue
// rowtile::sq_l2 is the plain version's, uncontracted.  At 2^20 x 896 the
// result stays within ~4 ulp of ||q||^2 + ||x||^2 of the exact value (the
// in-band rule allows 8; an f64 carry of the stage sums would give ~2 ulp
// for one more conversion and an f64 add per sum, ~7% of the time).  On rows where every product and partial sum is
// exact (a 1/8 grid, power-of-two scales) it equals the plain version bit
// for bit.
//
// Ragged shapes: the 16-byte copies need D % 16 == 0 and 16-byte aligned
// x_q and q; otherwise (kVec false) each warp loads its stage with plain
// predicated loads, right for any D, Q and alignment.  Features past D and
// rows past N are zeros (they add nothing) and are not written.  The
// selection of the k nearest that follows in the kNN-LM path is not part of
// this kernel (in JAX it is lax.top_k outside Pallas).
#include <cuda_runtime.h>
#include <stdint.h>

#include "row_tile.cuh"

namespace {

constexpr int kWarps = 2;                          // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kLaneRows = 4;                       // rows per lane: l + 32 r, r < 4
constexpr int kWarpRows = 32 * kLaneRows;          // rows per warp
constexpr int kRows = kWarps * kWarpRows;          // rows per block
constexpr int kQueries = 8;                        // queries per block
constexpr int kDChunk = 32;                        // features per stage
constexpr int kRowStride = kDChunk + 16;           // bytes between rows in a stage
constexpr int kStages = 3;                         // buffers in a warp's ring
constexpr int kStageBytes = kWarpRows * kRowStride + kQueries * kDChunk * 4;
constexpr int kMaxRowTiles = 65535;                // grid.y limit; larger N loops

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Features [d0, d0 + 32) of the warp's rows [r0, r0 + 128) and of queries
// [q0, q0 + 8) into one stage buffer, zeros past nx, nq and dim.  With kVec,
// lane copies the 16-byte unit lane & 1 of rows lane / 2 + 16 j, from
// ``src`` (that unit of its first row, feature 0) on; ``left`` is the number
// of rows from its first row to nx.
template <bool kVec>
__device__ __forceinline__ void load_stage(unsigned char* st, const float* __restrict__ q,
                                           const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ src, int64_t left,
                                           int64_t q0, int nq, int64_t r0, int nx, int dim,
                                           int d0) {
  const int lane = threadIdx.x & 31;
  float* qs = reinterpret_cast<float*>(st + kWarpRows * kRowStride);
  if (kVec) {
    const int r = lane >> 1;
    const int c = (lane & 1) * 16;
    const bool col = d0 + c < dim;
#pragma unroll
    for (int j = 0; j < kWarpRows / 16; ++j) {
      const bool live = col && 16 * j < left;
      rowtile::cp_async16(st + (r + 16 * j) * kRowStride + c,
                          live ? src + static_cast<int64_t>(16 * j) * dim + d0 : xq, live);
    }
    // queries: 8 x 8 units of 4 floats, two a lane
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = lane + 32 * h;
      const int i = u >> 3;
      const int cq = (u & 7) * 4;
      const bool live = q0 + i < nq && d0 + cq < dim;
      rowtile::cp_async16(qs + i * kDChunk + cq, live ? q + (q0 + i) * dim + d0 + cq : q, live);
    }
  } else {
    for (int e = lane; e < kWarpRows * kDChunk; e += 32) {
      const int r = e / kDChunk;
      const int c = e % kDChunk;
      const int64_t row = r0 + r;
      st[r * kRowStride + c] =
          (row < nx && d0 + c < dim) ? static_cast<unsigned char>(xq[row * dim + d0 + c]) : 0;
    }
    for (int e = lane; e < kQueries * kDChunk; e += 32) {
      const int i = e / kDChunk;
      const int c = e % kDChunk;
      qs[e] = (q0 + i < nq && d0 + c < dim) ? q[(q0 + i) * dim + d0 + c] : 0.f;
    }
  }
}

// Four int8 values (one word) to f32, each float(b) * s with one rounding.
// Byte 0 by I2F; bytes 1-3 exactly as (b + 128) in the low mantissa byte of
// 2^23, minus 2^23 + 128.
__device__ __forceinline__ float4 dequant4(uint32_t w, float s) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kBias = 8388736.f;  // 2^23 + 128
  const float b0 = static_cast<float>(static_cast<int8_t>(w & 0xFFu));
  const float b1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)), kBias);
  const float b2 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)), kBias);
  const float b3 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)), kBias);
  return make_float4(__fmul_rn(b0, s), __fmul_rn(b1, s), __fmul_rn(b2, s), __fmul_rn(b3, s));
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
pairwise_int8_warps(const float* __restrict__ q, const float* __restrict__ qnorm,
                    const int8_t* __restrict__ xq, const float* __restrict__ scale,
                    float* __restrict__ out, int nq, int nx, int dim) {
  __shared__ __align__(16) unsigned char smem[kWarps * kStages * kStageBytes];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* ring = smem + warp * kStages * kStageBytes;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kQueries;
  const int n_st = (dim + kDChunk - 1) / kDChunk;

  for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRows + warp * kWarpRows; r0 < nx;
       r0 += static_cast<int64_t>(gridDim.y) * kRows) {
    const int8_t* src = xq + (r0 + (lane >> 1)) * dim + (lane & 1) * 16;
    const int64_t left = nx - r0 - (lane >> 1);
    float s[kLaneRows], xn_total[kLaneRows], dot_total[kLaneRows][kQueries];
#pragma unroll
    for (int r = 0; r < kLaneRows; ++r) {
      const int64_t row = r0 + lane + 32 * r;
      s[r] = row < nx ? scale[row] : 0.f;
      xn_total[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kQueries; ++i) dot_total[r][i] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) {
      if (k < n_st)
        load_stage<kVec>(ring + k * kStageBytes, q, xq, src, left, q0, nq, r0, nx, dim,
                         k * kDChunk);
      commit();
    }
    for (int k = 0; k < n_st; ++k) {
      wait_pending<kStages - 2>();  // this lane's copies of stage k have landed
      __syncwarp();                 // every lane's have; stage k - 1's buffer is free
      const int next = k + kStages - 1;
      if (next < n_st)
        load_stage<kVec>(ring + (next % kStages) * kStageBytes, q, xq, src, left, q0, nq, r0,
                         nx, dim, next * kDChunk);
      commit();

      const unsigned char* st = ring + (k % kStages) * kStageBytes;
      const float* qs = reinterpret_cast<const float*>(st + kWarpRows * kRowStride);
      float dot[kLaneRows][kQueries], xn[kLaneRows];
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) {
        xn[r] = 0.f;
#pragma unroll
        for (int i = 0; i < kQueries; ++i) dot[r][i] = 0.f;
      }
#pragma unroll
      for (int c16 = 0; c16 < kDChunk; c16 += 16) {
        uint4 w[kLaneRows];
#pragma unroll
        for (int r = 0; r < kLaneRows; ++r)
          w[r] = *reinterpret_cast<const uint4*>(st + (lane + 32 * r) * kRowStride + c16);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int c = c16 + 4 * v;
          float4 xv[kLaneRows];
#pragma unroll
          for (int r = 0; r < kLaneRows; ++r) {
            const uint32_t word = v == 0 ? w[r].x : v == 1 ? w[r].y : v == 2 ? w[r].z : w[r].w;
            xv[r] = dequant4(word, s[r]);
            xn[r] = fmaf(xv[r].x, xv[r].x, xn[r]);
            xn[r] = fmaf(xv[r].y, xv[r].y, xn[r]);
            xn[r] = fmaf(xv[r].z, xv[r].z, xn[r]);
            xn[r] = fmaf(xv[r].w, xv[r].w, xn[r]);
          }
          // each broadcast query slice serves every row of the lane
#pragma unroll
          for (int i = 0; i < kQueries; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + i * kDChunk + c);
#pragma unroll
            for (int r = 0; r < kLaneRows; ++r) {
              dot[r][i] = fmaf(qv.x, xv[r].x, dot[r][i]);
              dot[r][i] = fmaf(qv.y, xv[r].y, dot[r][i]);
              dot[r][i] = fmaf(qv.z, xv[r].z, dot[r][i]);
              dot[r][i] = fmaf(qv.w, xv[r].w, dot[r][i]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kLaneRows; ++r) {
        xn_total[r] = __fadd_rn(xn_total[r], xn[r]);
#pragma unroll
        for (int i = 0; i < kQueries; ++i) dot_total[r][i] = __fadd_rn(dot_total[r][i], dot[r][i]);
      }
    }
    wait_pending<0>();
    __syncwarp();  // the ring is free for the warp's next rows

    float qn[kQueries];
    rowtile::load_norms(qnorm, q0, nq, qn);
#pragma unroll
    for (int r = 0; r < kLaneRows; ++r) {
      const int64_t row = r0 + lane + 32 * r;
      if (row >= nx) continue;
#pragma unroll
      for (int i = 0; i < kQueries; ++i)
        if (q0 + i < nq)
          out[(q0 + i) * nx + row] = rowtile::sq_l2(qn[i], xn_total[r], dot_total[r][i]);
    }
  }
}

}  // namespace

// qnorm: (nq,) scratch.  vec: dim % 16 == 0 and x_q, q 16-byte aligned.
extern "C" int pairwise_sq_l2_int8(const float* q, const int8_t* xq, const float* scale,
                                   float* qnorm, float* out, int nq, int nx, int dim, int vec,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rowtile::launch_query_norms(q, nq, dim, qnorm, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_tiles = (nx + kRows - 1) / kRows;
  const dim3 grid((nq + kQueries - 1) / kQueries,
                  row_tiles < kMaxRowTiles ? row_tiles : kMaxRowTiles);
  if (vec) {
    pairwise_int8_warps<true><<<grid, kThreads, 0, s>>>(q, qnorm, xq, scale, out, nq, nx, dim);
  } else {
    pairwise_int8_warps<false><<<grid, kThreads, 0, s>>>(q, qnorm, xq, scale, out, nq, nx, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
