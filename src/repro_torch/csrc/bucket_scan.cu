// K1: one whole forest-scan phase in one launch.  For each query, walk its
// buckets in ascending lower-bound order, `beam` slots a step; at each step
// gather the active buckets, take the squared L2 distance to every live
// member, and merge the candidates into the query's running top-kk
// (ascending squared distances and object ids); stop at the query's first
// step with no active slot.
//
// Replaces the TPU kernel repro/kernels/bucket_scan.py::bucket_scan_topk_pallas
// (body _scan_kernel), one scan step, together with the lax.while_loop that
// the JAX package runs it in (repro/core/knn.py::_scan_phase).  The contract is
// the plain version's (repro_torch/kernels/ref.py::bucket_scan_phase_ref):
// step t makes slot t*beam + b active where lb_sorted <= sqrt(top_d[kk-1]) at
// the step's start (+inf <= +inf: an unfilled top-kk makes every slot
// active); members with id < 0 or at a row >= the bucket's extent (one past
// its last live row) and buckets outside [0, NB) contribute no candidate; the
// merge is a top-kk of [running top-kk | candidates in (slot, member) order]
// in which the lower position wins a tie.  A query's active
// steps are a prefix of the phase (its lb only grows, and its kth changes only
// by its own merges), so walking each query alone until its first inactive
// step gives the lockstep loop's results, and the loop's trip count is the
// most steps any query took (`qsteps`).
//
// What bounds it on an H100: latency.  Device memory has to deliver each
// distinct bucket the phase touches once (C ids, and the live members' D
// values: 4 bytes each in f32, 1 in int8 plus a 4-byte scale) and each
// query's row, visited bounds and 2*kk words in and out: tens of MB for a
// WARD search, microseconds at 3.35 TB/s; its 4*D flops per scored (query,
// member) pair take about as long at the f32 rate.  But a query's steps form
// a chain: the next bucket to read depends on the bound, which depends on
// the merge.  The longest query (165 steps on WARD at beam 1) sets the
// phase's time, and every step of every query copies its bucket's tiles
// through L2 again (the queries share buckets, but not in step).
//
// What the design does about it:
// - one block of 128 threads per query walks its steps in order (the TPU
//   grid's sequential axis becomes this loop); the step loop runs on the card,
//   so a phase is one launch and the host reads nothing until the search
//   returns.  Small blocks keep more queries in flight on an SM;
// - the query's bounds, buckets and the buckets' live counts and extents are
//   staged in a shared-memory window of 256 slots (or two steps, if more), so
//   a step decides what to scan and what to prefetch without a device-memory
//   round trip.  Count and extent share one 32-bit word (16 bits each) while
//   C < 65,536, so the window costs no more shared memory than the counts
//   alone; a larger C reads the extent from device memory;
// - only a bucket's rows [0, extent) are staged and scored: the forests keep
//   a bucket's live members as a prefix, so the padding past them (over half
//   of a visited bucket's capacity on WARD and Tracking) is never copied.  A
//   bucket of extent 0 is visited (and counted) but stages nothing;
// - a step's time is latency (the copy, the barriers, the merge), so what
//   the phase needs is blocks in flight: the tile is the largest (up to a
//   24 KB buffer) with which an SM holds 8 blocks, as many as registers allow,
//   and a tile's survivors are compacted into its own buffer once it is
//   scored.  On WARD (C 1000, D 5) that is 512 rows, on Tracking (C 250,
//   D 20) 147: short buckets lose nothing to the smaller tile;
// - the members of a bucket are staged in tiles of up to kMaxTile rows in
//   shared memory by 16-byte cp.async copies, double-buffered: the next tile
//   (the next chunk, the next active slot, or the first slot of the next step
//   whose bound is within the current kth) is in flight while the current one
//   is scored and merged.  A prefetch of the next step that turns out inactive
//   is only wasted bandwidth;
// - every thread scores up to kMaxRounds members of the tile; a candidate
//   survives only if d2 < the k-th best at the tile's start (a later position
//   than all kk running entries, so it could never enter otherwise).  A tile
//   with no survivor costs two barriers and no merge;
// - survivors are compacted in member order (a warp ballot, then a prefix over
//   the warps' counts) and one warp inserts them in order into the sorted
//   top-kk in shared memory, each after any equal value: lax.top_k's tie
//   order.  Survivors are rejected 32 at a time against the shrinking kth.
// The distance arithmetic is fixed: xx and q.x as separate
// fmaf chains in feature order (an int8 member as float(x) * scale first),
// then the uncontracted epilogue max(qq + xx - 2 q.x, 0).
//
// `staged` (Q ints, or null) adds each query's staged rows, the extents of its
// active in-range slots summed, to what it holds: the counter that shows how
// much of the padded capacity (npad) the extents saved.
//
// `qmask` (Q bytes, or null for all queries) masks whole queries out of the
// phase: a query whose byte is 0 visits nothing, not even the +inf-bound
// slots an unfilled carry would make active, and its block writes the carry
// through with zero counters.  The routed layout uses it so that an island
// a query's host-pruning dropped does no work for that query.
//
// The 16-byte copies fetch the aligned 16-byte blocks that enclose a tile's
// bytes, so a row range at any alignment (int8 rows, a bucket that starts
// mid-block) needs no scalar head or tail.  Those blocks lie within the
// 256-byte-aligned allocations the card's allocator hands out.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRounds = 4;                    // members a thread scores per tile
constexpr int kMaxTile = kThreads * kMaxRounds;  // members per tile
constexpr int kBufBytes = 24 * 1024;             // largest target of one tile buffer
// Blocks an SM is to hold: 64 registers a thread allow 8 (__launch_bounds__
// holds the kernel to that), and make_layout sizes the tile so that shared
// memory allows them too where it can.  An H100 SM has 228 KB of shared
// memory for its blocks, of which the runtime reserves 1 KB a block.
constexpr int kBlocksPerSm = 8;
constexpr int kSmemPerSm = 228 * 1024;
constexpr int kSmemPerBlockReserved = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory bytes of a staged range of `len` bytes: the enclosing
// 16-byte blocks span at most len + 30 bytes.
__host__ __device__ inline int region(int len) { return (len + 30 + 15) / 16 * 16; }

struct Layout {
  int rows;         // members per tile
  int ids_bytes;    // the three regions of a tile buffer
  int x_bytes;
  int scale_bytes;
  __host__ __device__ int buf_bytes() const { return ids_bytes + x_bytes + scale_bytes; }
};

// Slots in a query's window: two steps at least.
int window(int beam) { return beam > 128 ? 2 * beam : 256; }

Layout tile_layout(int rows, int dim, int elt, bool scaled) {
  Layout l;
  l.rows = rows;
  l.ids_bytes = region(rows * 4);
  l.x_bytes = region(rows * dim * elt);
  l.scale_bytes = scaled ? region(rows * 4) : 0;
  return l;
}

size_t smem_bytes(const Layout& l, int dim, int kk, int beam) {
  // two tile buffers (a tile's survivors, 8 bytes a member, are compacted
  // into its own buffer once it is scored: a buffer holds at least 8 bytes a
  // member); running top-kk values and ids; q row; per-(round, warp)
  // survivor counts; the slot window; qq and the tally
  return 2 * static_cast<size_t>(l.buf_bytes()) + 8 * static_cast<size_t>(kk) +
         4 * static_cast<size_t>(dim) + 4 * kMaxRounds * kWarps +
         12 * static_cast<size_t>(window(beam)) + 16;
}

// Members a tile holds: as many as a kBufBytes buffer takes (at most
// kMaxTile, at most C), and fewer where that lets an SM hold kBlocksPerSm
// blocks, as long as the tile keeps a member for every thread.  The scan is
// bound by each step's latency, not by bytes, so blocks in flight are what
// it needs; since a tile stops at the bucket's extent, a smaller tile costs
// a visit to a short bucket nothing.
Layout make_layout(int cap, int dim, int elt, bool scaled, int kk, int beam) {
  const int row_bytes = 4 + dim * elt + (scaled ? 4 : 0);
  int rows = (kBufBytes - 3 * 46) / row_bytes;
  rows = rows < 1 ? 1 : rows;
  rows = rows > kMaxTile ? kMaxTile : rows;
  rows = rows > cap ? cap : rows;
  const size_t budget = kSmemPerSm / kBlocksPerSm - kSmemPerBlockReserved;
  for (int r = rows; r >= kThreads; --r) {
    const Layout l = tile_layout(r, dim, elt, scaled);
    if (smem_bytes(l, dim, kk, beam) <= budget) return l;
  }
  return tile_layout(rows, dim, elt, scaled);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where byte `g` lands in a region staged from the 16-byte block enclosing it.
__device__ __forceinline__ int phase_of(const void* g) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
}

// Start the copy of the 16-byte blocks enclosing [g, g + len) into dst.
__device__ __forceinline__ void stage(char* dst, const void* g, int len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const uintptr_t lo = a & ~static_cast<uintptr_t>(15);
  const int n16 = static_cast<int>(((a + len + 15) & ~static_cast<uintptr_t>(15)) - lo) >> 4;
  for (int p = threadIdx.x; p < n16; p += kThreads)
    cp_async16(dst + 16 * p, reinterpret_cast<const char*>(lo) + 16 * p);
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

template <typename T, bool kScaled>
struct Phase {
  const T* bx;
  const float* scale;
  const int* bids;
  const int* bcount;
  const int* bext;      // one past each bucket's last live row
  const int* order;     // this query's row
  const float* lb;      // this query's row
  int nb, cap, dim, beam, kk, n_steps, n_slots, win;
  bool packed;          // cap < 65,536: the window word holds count | extent << 16
  Layout lay;
  // shared-memory window of slots [w0, w0 + win): bound, bucket and the
  // bucket's live count (and extent, when packed), so a step reads no device
  // memory to decide
  float* w_lb;
  int* w_ord;
  unsigned* w_cnt;
  int w0;

  // Fill the window from slot s0 (every thread takes part; the caller
  // synchronises before and after).
  __device__ void load_window(int s0) {
    w0 = s0;
    for (int j = threadIdx.x; j < win; j += kThreads) {
      const int s = s0 + j;
      float l = CUDART_INF_F;
      int o = -1;
      unsigned c = 0;
      if (s < n_slots) {
        l = lb[s];
        o = order[s];
        if (o >= 0 && o < nb)
          c = packed ? static_cast<unsigned>(bcount[o]) | static_cast<unsigned>(extent(o)) << 16
                     : static_cast<unsigned>(bcount[o]);
      }
      w_lb[j] = l;
      w_ord[j] = o;
      w_cnt[j] = c;
    }
  }

  __device__ float slot_lb(int s) const { return w_lb[s - w0]; }
  __device__ int slot_bucket(int s) const { return w_ord[s - w0]; }
  __device__ int slot_count(int s) const {
    const unsigned w = w_cnt[s - w0];
    return static_cast<int>(packed ? w & 0xffffu : w);
  }
  // bucket o's extent, held to [0, cap]
  __device__ int extent(int o) const { return min(max(bext[o], 0), cap); }
  // rows [0, extent) of the slot's bucket hold all its live members; 0 for a
  // bucket out of range
  __device__ int slot_extent(int s) const {
    if (packed) return static_cast<int>(w_cnt[s - w0] >> 16);
    const int o = slot_bucket(s);
    return o >= 0 && o < nb ? extent(o) : 0;
  }
  __device__ int tiles(int ext) const { return (ext + lay.rows - 1) / lay.rows; }

  // First slot >= `from` of step t that is active at `kth` and has rows to
  // stage (a bucket in range, extent > 0); beam if there is none.
  __device__ int first_tile_slot(int t, int from, float kth) const {
    for (int b = from; b < beam; ++b) {
      const int s = t * beam + b;
      if (slot_lb(s) <= kth && slot_extent(s) > 0) return b;
    }
    return beam;
  }

  // Start the copy of tile c of a bucket with extent `ext`.
  __device__ void issue(char* buf, int bucket, int c, int ext) const {
    const int c0 = c * lay.rows;
    const int n = min(lay.rows, ext - c0);
    const int64_t m0 = static_cast<int64_t>(bucket) * cap + c0;
    stage(buf, bids + m0, n * 4);
    stage(buf + lay.ids_bytes, bx + m0 * dim, n * dim * static_cast<int>(sizeof(T)));
    if (kScaled) stage(buf + lay.ids_bytes + lay.x_bytes, scale + m0, n * 4);
    cp_async_commit();
  }
};

// Insert (v, id) into the sorted top-kk after every entry <= v; the caller
// has checked v < top_v[kk - 1].  Run by one whole warp.
__device__ __forceinline__ void insert_sorted(float* top_v, int* top_i, int kk, float v,
                                              int id, int lane) {
  int p = 0;
  for (int j0 = 0; j0 < kk; j0 += 32) {
    const int j = j0 + lane;
    p += __popc(__ballot_sync(kFull, j < kk && top_v[j] <= v));
  }
  // shift [p, kk - 2] up by one, 32 entries at a time from the top down: a
  // group reads the entry below it before the group below is rewritten
  for (int j0 = (kk - 1) / 32 * 32; j0 >= 0 && j0 + 31 >= p; j0 -= 32) {
    const int j = j0 + lane;
    const bool mv = j > p && j < kk;
    float sv = 0.f;
    int si = 0;
    if (mv) {
      sv = top_v[j - 1];
      si = top_i[j - 1];
    }
    __syncwarp();
    if (mv) {
      top_v[j] = sv;
      top_i[j] = si;
    } else if (j == p) {
      top_v[j] = v;
      top_i[j] = id;
    }
    __syncwarp();
  }
}

template <typename T, bool kScaled>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
scan_phase_kernel(Phase<T, kScaled> ph, const float* __restrict__ q_all,
                  const float* __restrict__ top_d_in, const int* __restrict__ top_i_in,
                  float* __restrict__ top_d_out, int* __restrict__ top_i_out,
                  int* __restrict__ visits_out, int* __restrict__ ndist_out,
                  int* __restrict__ npad_out, int* __restrict__ qsteps_out,
                  int* __restrict__ staged_out, const uint8_t* __restrict__ qmask) {
  if (qmask != nullptr && qmask[blockIdx.x] == 0) {  // the whole block takes this exit
    const int64_t qi = blockIdx.x;
    for (int j = threadIdx.x; j < ph.kk; j += kThreads) {
      top_d_out[qi * ph.kk + j] = top_d_in[qi * ph.kk + j];
      top_i_out[qi * ph.kk + j] = top_i_in[qi * ph.kk + j];
    }
    if (threadIdx.x == 0) {
      visits_out[qi] = 0;
      ndist_out[qi] = 0;
      npad_out[qi] = 0;
      qsteps_out[qi] = 0;
    }
    return;
  }
  extern __shared__ __align__(16) char smem[];
  const int buf_bytes = ph.lay.buf_bytes();
  char* const bufs = smem;
  float* const top_v = reinterpret_cast<float*>(smem + 2 * buf_bytes);
  int* const top_id = reinterpret_cast<int*>(top_v + ph.kk);
  float* const qv = reinterpret_cast<float*>(top_id + ph.kk);
  int* const counts = reinterpret_cast<int*>(qv + ph.dim);  // [kMaxRounds][kWarps]
  ph.w_lb = reinterpret_cast<float*>(counts + kMaxRounds * kWarps);
  ph.w_ord = reinterpret_cast<int*>(ph.w_lb + ph.win);
  ph.w_cnt = reinterpret_cast<unsigned*>(ph.w_ord + ph.win);
  float* const misc = reinterpret_cast<float*>(ph.w_cnt + ph.win);  // qq, then the tally
  // visits, ndist and staged rows, kept by thread 0 in shared memory rather
  // than in every thread's registers
  int* const tally = reinterpret_cast<int*>(misc + 1);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t qi = blockIdx.x;
  const int kk = ph.kk;
  const int dim = ph.dim;
  ph.order += qi * ph.n_slots;
  ph.lb += qi * ph.n_slots;

  for (int d = tid; d < dim; d += kThreads) qv[d] = q_all[qi * dim + d];
  for (int j = tid; j < kk; j += kThreads) {
    top_v[j] = top_d_in[qi * kk + j];
    top_id[j] = top_i_in[qi * kk + j];
  }
  ph.load_window(0);
  __syncthreads();
  if (tid == 0) {
    float qq = 0.f;
    for (int d = 0; d < dim; ++d) qq = fmaf(qv[d], qv[d], qq);
    misc[0] = qq;
    tally[0] = tally[1] = tally[2] = 0;
  }
  __syncthreads();
  const float qq = misc[0];

  int steps = 0;
  // slot pend_s's tile pend_c is in flight into bufs[pend_buf]; -1: none
  int pend_s = -1, pend_c = 0, pend_buf = 0;

  for (int t = 0; t < ph.n_steps; ++t) {
    // the window holds this step's slots and the next one's
    if (min(t + 2, ph.n_steps) * ph.beam > ph.w0 + ph.win) {
      __syncthreads();  // no thread still reads the old window
      ph.load_window(t * ph.beam);
      __syncthreads();
    }
    // every slot's activity is decided at the step's start, before any merge
    const float kth = __fsqrt_rn(top_v[kk - 1]);
    int n_act = 0, n_rows = 0, n_ext = 0;
    for (int b = 0; b < ph.beam; ++b) {
      const int s = t * ph.beam + b;
      if (!(ph.slot_lb(s) <= kth)) continue;
      ++n_act;
      n_rows += ph.slot_count(s);
      n_ext += ph.slot_extent(s);
    }
    if (n_act == 0) break;
    ++steps;
    if (tid == 0) {
      tally[0] += n_act;
      tally[1] += n_rows;
      tally[2] += n_ext;
    }

    for (int b = ph.first_tile_slot(t, 0, kth); b < ph.beam;
         b = ph.first_tile_slot(t, b + 1, kth)) {
      const int bucket = ph.slot_bucket(t * ph.beam + b);
      const int ext = ph.slot_extent(t * ph.beam + b);
      const int n_tiles = ph.tiles(ext);
      for (int c = 0; c < n_tiles; ++c) {
        int cur;
        if (pend_s == t * ph.beam + b && pend_c == c) {
          cur = pend_buf;
        } else {
          if (pend_s >= 0) {  // a prefetch that missed: let it land, then reuse
            cp_async_wait<0>();
            __syncthreads();
          }
          cur = 0;
          ph.issue(bufs + cur * buf_bytes, bucket, c, ext);
        }
        // the tile after this one, prefetched into the other buffer
        int nt = t, nbk = 0, next_ext = ext, nc = c + 1, nb_slot = b;
        bool next = nc < n_tiles;
        if (next) {
          nbk = bucket;
        } else {
          nc = 0;
          nb_slot = ph.first_tile_slot(t, b + 1, kth);
          next = nb_slot < ph.beam;
          if (!next && t + 1 < ph.n_steps) {
            // speculative: the next step's first slot within the current kth
            nt = t + 1;
            nb_slot = ph.first_tile_slot(nt, 0, __fsqrt_rn(top_v[kk - 1]));
            next = nb_slot < ph.beam;
          }
          if (next) {
            nbk = ph.slot_bucket(nt * ph.beam + nb_slot);
            next_ext = ph.slot_extent(nt * ph.beam + nb_slot);
          }
        }
        pend_s = next ? nt * ph.beam + nb_slot : -1;
        if (next) {
          pend_c = nc;
          pend_buf = cur ^ 1;
          ph.issue(bufs + pend_buf * buf_bytes, nbk, nc, next_ext);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // the tile is in shared memory for every thread

        // score: members tid, tid + kThreads, ... of the tile
        const char* buf = bufs + cur * buf_bytes;
        const int c0 = c * ph.lay.rows;
        const int n = min(ph.lay.rows, ext - c0);
        const int64_t m0 = static_cast<int64_t>(bucket) * ph.cap + c0;
        const int* ids_s = reinterpret_cast<const int*>(buf + phase_of(ph.bids + m0));
        const T* xs = reinterpret_cast<const T*>(buf + ph.lay.ids_bytes +
                                                  phase_of(ph.bx + m0 * dim));
        const float* ss = reinterpret_cast<const float*>(
            buf + ph.lay.ids_bytes + ph.lay.x_bytes + (kScaled ? phase_of(ph.scale + m0) : 0));
        const float kth2 = top_v[kk - 1];
        float dv[kMaxRounds];
        int iv[kMaxRounds];
        int rank[kMaxRounds];
        unsigned surv = 0;
#pragma unroll
        for (int r = 0; r < kMaxRounds; ++r) {
          const int e = r * kThreads + tid;
          bool s = false;
          dv[r] = 0.f;
          iv[r] = -1;
          if (e < n) {
            const int id = ids_s[e];
            if (id >= 0) {
              const T* row = xs + static_cast<int64_t>(e) * dim;
              const float sc = kScaled ? ss[e] : 1.f;
              float xx = 0.f, cross = 0.f;
              for (int d = 0; d < dim; ++d) {
                const float xd =
                    kScaled ? load_member<T>(row, d) * sc : load_member<T>(row, d);
                xx = fmaf(xd, xd, xx);
                cross = fmaf(qv[d], xd, cross);
              }
              const float d2 =
                  fmaxf(__fsub_rn(__fadd_rn(qq, xx), __fmul_rn(2.f, cross)), 0.f);
              s = d2 < kth2;
              dv[r] = d2;
              iv[r] = id;
            }
          }
          const unsigned bal = __ballot_sync(kFull, s);
          rank[r] = __popc(bal & ((1u << lane) - 1u));
          if (lane == 0) counts[r * kWarps + warp] = __popc(bal);
          surv |= (s ? 1u : 0u) << r;
        }
        // barrier: the tile is read, the counts are in shared memory
        if (!__syncthreads_or(surv != 0)) continue;

        // the survivors go to the scored tile's own buffer: every thread is
        // past reading it, and the prefetch fills the other one
        float* const cand_v = reinterpret_cast<float*>(bufs + cur * buf_bytes);
        int* const cand_i = reinterpret_cast<int*>(cand_v + ph.lay.rows);
        int before = 0, total = 0;
        for (int w = 0; w < kMaxRounds * kWarps; ++w) total += counts[w];
#pragma unroll
        for (int r = 0; r < kMaxRounds; ++r) {
          int pos = before;
          for (int w = 0; w < warp; ++w) pos += counts[r * kWarps + w];
          if (surv >> r & 1u) {
            cand_v[pos + rank[r]] = dv[r];
            cand_i[pos + rank[r]] = iv[r];
          }
          for (int w = 0; w < kWarps; ++w) before += counts[r * kWarps + w];
        }
        __syncthreads();  // the survivors are in shared memory, in member order
        if (warp == 0) {
          for (int base = 0; base < total; base += 32) {
            const int k = base + lane;
            const float v = k < total ? cand_v[k] : CUDART_INF_F;
            const int id = k < total ? cand_i[k] : -1;
            unsigned todo = __ballot_sync(kFull, v < top_v[kk - 1]);
            while (todo) {
              const int src = __ffs(todo) - 1;
              todo &= todo - 1;
              const float cv = __shfl_sync(kFull, v, src);
              const int ci = __shfl_sync(kFull, id, src);
              if (cv < top_v[kk - 1]) insert_sorted(top_v, top_id, kk, cv, ci, lane);
            }
          }
        }
        __syncthreads();  // the merged top-kk is visible to every thread
      }
    }
  }
  if (pend_s >= 0) cp_async_wait<0>();  // no copy may land after the block exits

  for (int j = tid; j < kk; j += kThreads) {
    top_d_out[qi * kk + j] = top_v[j];
    top_i_out[qi * kk + j] = top_id[j];
  }
  if (tid == 0) {
    visits_out[qi] = tally[0];
    ndist_out[qi] = tally[1];
    npad_out[qi] = tally[0] * ph.cap;
    qsteps_out[qi] = steps;
    if (staged_out != nullptr) staged_out[qi] += tally[2];
  }
}

template <typename T, bool kScaled>
int launch(const float* q, const T* bx, const float* scale, const int* bids,
           const int* bcount, const int* bext, const int* order, const float* lb,
           const float* top_d, const int* top_i, float* out_d, int* out_i, int* visits,
           int* ndist, int* npad, int* qsteps, int* staged, const uint8_t* qmask, int nq,
           int nb, int cap, int dim, int beam, int kk, int n_slots, void* stream) {
  Phase<T, kScaled> ph;
  ph.bx = bx;
  ph.scale = scale;
  ph.bids = bids;
  ph.bcount = bcount;
  ph.bext = bext;
  ph.order = order;
  ph.lb = lb;
  ph.nb = nb;
  ph.cap = cap;
  ph.dim = dim;
  ph.beam = beam;
  ph.kk = kk;
  ph.n_steps = n_slots / beam;
  ph.n_slots = n_slots;
  ph.win = window(beam);
  ph.packed = cap < 65536;
  ph.lay = make_layout(cap, dim, static_cast<int>(sizeof(T)), kScaled, kk, beam);
  const size_t smem = smem_bytes(ph.lay, dim, kk, beam);
  auto kernel = scan_phase_kernel<T, kScaled>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nq, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ph, q, top_d, top_i, out_d, out_i, visits, ndist, npad, qsteps, staged, qmask);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kScaled>
int blocks_per_sm(int cap, int dim, int kk, int beam) {
  const size_t smem =
      smem_bytes(make_layout(cap, dim, static_cast<int>(sizeof(T)), kScaled, kk, beam), dim,
                 kk, beam);
  auto kernel = scan_phase_kernel<T, kScaled>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

extern "C" int bucket_scan_phase_f32(const float* q, const float* bx, const int* bids,
                                     const int* bcount, const int* bext, const int* order,
                                     const float* lb, const float* top_d, const int* top_i,
                                     float* out_d, int* out_i, int* visits, int* ndist,
                                     int* npad, int* qsteps, int* staged, const uint8_t* qmask,
                                     int nq, int nb, int cap, int dim, int beam, int kk,
                                     int n_slots, void* stream) {
  return launch<float, false>(q, bx, nullptr, bids, bcount, bext, order, lb, top_d, top_i,
                              out_d, out_i, visits, ndist, npad, qsteps, staged, qmask, nq,
                              nb, cap, dim, beam, kk, n_slots, stream);
}

extern "C" int bucket_scan_phase_i8(const float* q, const int8_t* bx, const float* scale,
                                    const int* bids, const int* bcount, const int* bext,
                                    const int* order, const float* lb, const float* top_d,
                                    const int* top_i, float* out_d, int* out_i, int* visits,
                                    int* ndist, int* npad, int* qsteps, int* staged,
                                    const uint8_t* qmask, int nq, int nb, int cap, int dim,
                                    int beam, int kk, int n_slots, void* stream) {
  return launch<int8_t, true>(q, bx, scale, bids, bcount, bext, order, lb, top_d, top_i,
                              out_d, out_i, visits, ndist, npad, qsteps, staged, qmask, nq,
                              nb, cap, dim, beam, kk, n_slots, stream);
}

// Dynamic shared memory of one block (elt: 4 for f32 members, 1 for int8).
extern "C" size_t bucket_scan_smem_bytes(int cap, int dim, int elt, int kk, int beam) {
  return smem_bytes(make_layout(cap, dim, elt, elt == 1, kk, beam), dim, kk, beam);
}

// Blocks of the phase kernel one SM holds at once at this shape (elt as
// above), as the occupancy calculator counts registers and shared memory;
// -1 if the runtime refuses the query.
extern "C" int bucket_scan_blocks_per_sm(int cap, int dim, int elt, int kk, int beam) {
  return elt == 1 ? blocks_per_sm<int8_t, true>(cap, dim, kk, beam)
                  : blocks_per_sm<float, false>(cap, dim, kk, beam);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
