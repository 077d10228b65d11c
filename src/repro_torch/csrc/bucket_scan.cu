// K1: one fused forest-scan step.  For each query, gather its `beam` selected
// buckets, take the squared L2 distance to every live member, and merge the
// candidates into the query's running top-kk (ascending squared distances and
// object ids).
//
// Replaces the TPU kernel repro/kernels/bucket_scan.py::bucket_scan_topk_pallas
// (body _scan_kernel).  The contract is the plain version's
// (repro_torch/kernels/ref.py::bucket_scan_topk_ref): members with id < 0 and
// buckets with act == 0 contribute nothing; the merge is a top-kk of
// [running top-kk | candidates in (bucket, member) order] in which the lower
// position wins a tie; an extraction that finds only +inf emits id -1.
//
// What bounds it on an H100: bytes and latency.  Device memory has to deliver
// each distinct active bucket once per launch (C ids, and the live members'
// D values: 4 bytes each in f32, 1 in int8 plus a 4-byte scale), and each
// query's row, selections and 2*kk words in and out.  The queries of a
// launch share buckets, so the kernel gathers each (query, bucket) pair's
// members but most of those loads hit L2.  At 4*D flops per (query, member)
// pair it stays far below the f32 FMA rate, so memory (3.35 TB/s) is the
// roofline.  In practice the block-wide merge (kk rounds of argmin, two
// barriers each) adds a latency floor per query.
//
// What the design does about it: one block per query, and the TPU grid's
// sequential beam axis becomes a loop inside the block, since blocks run in no
// order.  Threads stride over a bucket's members (neighbouring threads read
// neighbouring rows), so each member row is read once.  Members are handled
// in chunks of kChunk so any bucket capacity fits in shared memory.  Before a
// chunk is merged, every candidate whose distance is not below the current
// k-th best is dropped: it has a later position than all kk running entries,
// so it could never enter; a chunk with no survivor skips the merge, which is
// what keeps the merge off most steps once a query's top-kk has filled.
// Surviving chunks merge by kk rounds of a block-wide lexicographic
// (value, position) argmin, which reproduces lax.top_k's tie order exactly.
// Iterated merges equal one merge over the whole step: positions of a later
// chunk are all larger, so the (value, position) order is preserved.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;

__device__ __forceinline__ bool less_vp(float va, int pa, float vb, int pb) {
  return va < vb || (va == vb && pa < pb);
}

template <typename T>
__device__ __forceinline__ float load_member(const T* row, int d);

template <>
__device__ __forceinline__ float load_member<float>(const float* row, int d) {
  return row[d];
}

template <>
__device__ __forceinline__ float load_member<int8_t>(const int8_t* row, int d) {
  return static_cast<float>(row[d]);
}

size_t smem_bytes(int dim, int kk) {
  // q row, pool (running top-kk + one chunk) values and ids, new top-kk
  // values and ids, per-warp argmin partials, qq + dry flag
  return sizeof(float) * dim + (sizeof(float) + sizeof(int)) * (kk + kChunk) +
         (sizeof(float) + sizeof(int)) * kk + (sizeof(float) + sizeof(int)) * kWarps +
         2 * sizeof(float);
}

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads)
bucket_scan_kernel(const float* __restrict__ q, const T* __restrict__ bx,
                   const float* __restrict__ scale, const int* __restrict__ bids,
                   const int* __restrict__ bsel, const uint8_t* __restrict__ act,
                   const float* __restrict__ top_d_in, const int* __restrict__ top_i_in,
                   float* __restrict__ top_d_out, int* __restrict__ top_i_out,
                   int nb, int cap, int dim, int beam, int kk) {
  extern __shared__ float smem[];
  float* qv = smem;                                   // [dim]
  float* pool_v = qv + dim;                           // [kk + kChunk]
  int* pool_i = reinterpret_cast<int*>(pool_v + kk + kChunk);
  float* new_v = reinterpret_cast<float*>(pool_i + kk + kChunk);  // [kk]
  int* new_i = reinterpret_cast<int*>(new_v + kk);    // [kk]
  float* red_v = reinterpret_cast<float*>(new_i + kk);  // [kWarps]
  int* red_p = reinterpret_cast<int*>(red_v + kWarps);  // [kWarps]
  float* misc = reinterpret_cast<float*>(red_p + kWarps);  // qq, dry flag

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t qi = blockIdx.x;

  for (int d = tid; d < dim; d += kThreads) qv[d] = q[qi * dim + d];
  for (int j = tid; j < kk; j += kThreads) {
    pool_v[j] = top_d_in[qi * kk + j];
    pool_i[j] = top_i_in[qi * kk + j];
  }
  __syncthreads();
  if (tid == 0) {
    float qq = 0.f;
    for (int d = 0; d < dim; ++d) qq = fmaf(qv[d], qv[d], qq);
    misc[0] = qq;
  }
  __syncthreads();
  const float qq = misc[0];

  for (int b = 0; b < beam; ++b) {
    const int64_t slot = qi * beam + b;
    const int bucket = bsel[slot];
    if (act[slot] == 0 || bucket < 0 || bucket >= nb) continue;  // uniform
    const int64_t base = static_cast<int64_t>(bucket) * cap;
    for (int c0 = 0; c0 < cap; c0 += kChunk) {
      const int n = min(kChunk, cap - c0);
      const float kth = pool_v[kk - 1];
      int survivor = 0;
      for (int e = tid; e < n; e += kThreads) {
        const int64_t m = base + c0 + e;
        const int id = bids[m];
        float dv = CUDART_INF_F;
        int iv = -1;
        if (id >= 0) {
          const T* row = bx + m * dim;
          const float s = kScaled ? scale[m] : 1.f;
          float xx = 0.f, cross = 0.f;
          for (int d = 0; d < dim; ++d) {
            const float xd = kScaled ? load_member<T>(row, d) * s : load_member<T>(row, d);
            xx = fmaf(xd, xd, xx);
            cross = fmaf(qv[d], xd, cross);
          }
          const float d2 =
              fmaxf(__fsub_rn(__fadd_rn(qq, xx), __fmul_rn(2.f, cross)), 0.f);
          if (d2 < kth) {
            dv = d2;
            iv = id;
            survivor = 1;
          }
        }
        pool_v[kk + e] = dv;
        pool_i[kk + e] = iv;
      }
      // barrier: the chunk is in shared memory and every thread knows
      // whether any candidate can enter the top-kk
      if (!__syncthreads_or(survivor)) continue;

      const int total = kk + n;
      int r = 0;
      for (; r < kk; ++r) {
        float bv = CUDART_INF_F;
        int bp = 0x7fffffff;
        for (int e = tid; e < total; e += kThreads) {
          const float v = pool_v[e];
          if (less_vp(v, e, bv, bp)) {
            bv = v;
            bp = e;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, bv, off);
          const int op = __shfl_down_sync(0xffffffffu, bp, off);
          if (less_vp(ov, op, bv, bp)) {
            bv = ov;
            bp = op;
          }
        }
        if (lane == 0) {
          red_v[warp] = bv;
          red_p[warp] = bp;
        }
        __syncthreads();
        if (tid == 0) {
          for (int w = 1; w < kWarps; ++w) {
            if (less_vp(red_v[w], red_p[w], bv, bp)) {
              bv = red_v[w];
              bp = red_p[w];
            }
          }
          if (isinf(bv)) {  // pool ran dry: the rest of the top-kk is empty
            new_v[r] = CUDART_INF_F;
            new_i[r] = -1;
            misc[1] = 1.f;
          } else {
            new_v[r] = bv;
            new_i[r] = pool_i[bp];
            pool_v[bp] = CUDART_INF_F;
            misc[1] = 0.f;
          }
        }
        __syncthreads();
        if (misc[1] != 0.f) {
          ++r;
          break;
        }
      }
      for (int j = r + tid; j < kk; j += kThreads) {
        new_v[j] = CUDART_INF_F;
        new_i[j] = -1;
      }
      __syncthreads();
      for (int j = tid; j < kk; j += kThreads) {
        pool_v[j] = new_v[j];
        pool_i[j] = new_i[j];
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < kk; j += kThreads) {
    top_d_out[qi * kk + j] = pool_v[j];
    top_i_out[qi * kk + j] = pool_i[j];
  }
}

template <typename T, bool kScaled>
int launch(const float* q, const T* bx, const float* scale, const int* bids,
           const int* bsel, const uint8_t* act, const float* top_d, const int* top_i,
           float* out_d, int* out_i, int nq, int nb, int cap, int dim, int beam,
           int kk, void* stream) {
  const size_t smem = smem_bytes(dim, kk);
  auto kernel = bucket_scan_kernel<T, kScaled>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<nq, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, bx, scale, bids, bsel, act, top_d, top_i, out_d, out_i, nb, cap, dim, beam, kk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bucket_scan_topk_f32(const float* q, const float* bx, const int* bids,
                                    const int* bsel, const uint8_t* act, const float* top_d,
                                    const int* top_i, float* out_d, int* out_i, int nq,
                                    int nb, int cap, int dim, int beam, int kk,
                                    void* stream) {
  return launch<float, false>(q, bx, nullptr, bids, bsel, act, top_d, top_i, out_d,
                              out_i, nq, nb, cap, dim, beam, kk, stream);
}

extern "C" int bucket_scan_topk_i8(const float* q, const int8_t* bx, const float* scale,
                                   const int* bids, const int* bsel, const uint8_t* act,
                                   const float* top_d, const int* top_i, float* out_d,
                                   int* out_i, int nq, int nb, int cap, int dim, int beam,
                                   int kk, void* stream) {
  return launch<int8_t, true>(q, bx, scale, bids, bsel, act, top_d, top_i, out_d, out_i,
                              nq, nb, cap, dim, beam, kk, stream);
}

extern "C" size_t bucket_scan_smem_bytes(int dim, int kk) { return smem_bytes(dim, kk); }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
