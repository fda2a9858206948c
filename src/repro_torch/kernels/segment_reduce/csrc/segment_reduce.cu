// Blocked segment reductions for Hopper (sm_90a): the DeNovo analogue.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/segment_reduce/kernel.py:
//   seg_sum_{f32,i32}      <- seg_sum_pallas     (_sum_kernel, line 80)
//   seg_minmax_{f32,i32}   <- seg_minmax_pallas  (_minmax_kernel, line 132)
// and, replacing no TPU kernel, the gathered push reduce of sparse.py:
//   gathered_reduce_{f32,i32} (its own comment, below the blocked kernel)
//
// What it computes.  Edges arrive binned by destination block:
// block_ptr[b] .. block_ptr[b+1] are the edges whose segment id lies in
// [b*block_size, (b+1)*block_size).  For every block b the result rows
// out[b*block_size + l, :] are the sum (or min, or max) of vals[e, :]
// over the block's edges e with ids[e] - b*block_size == l; an id that
// falls outside its block's range is dropped, as the TPU kernel's one-hot
// drops it.  A row no edge reaches holds the identity (0, +-inf, or the
// int32 extrema), also for a block that has no edges at all.
//
// Design.  A chunk plan made once on the host (plan_chunks in kernel.py)
// cuts every block's edge range into chunks of at most chunk_e edges; an
// empty block keeps one empty chunk so that its rows are written.  One
// CTA reduces one chunk into a [block_size, D] accumulator in shared
// memory, so a hub block of a degree-sorted graph is spread over many
// CTAs instead of being walked by one.  Inside the CTA, each warp takes
// 32/L consecutive edges per step, L lanes per edge (L, a power of two,
// is D rounded up, at most 32; a lane loops over the features f = s,
// s+L, ..), so a warp's loads cover consecutive words.  Consecutive
// edges with the same segment id (a hub's run in the CSC order) are
// first combined by a segmented scan over the warp's lanes (shuffles),
// and only the last lane of a run applies a shared-memory atomic: a run
// of 32 edges into one word costs one atomic, not 32 serialised ones.
// No integer division runs per value: offsets inside a chunk are 32-bit
// and incremental, on a 64-bit chunk base.
//
// Merging a split block.  A block of one chunk is written from shared
// memory straight to out.  Each chunk of a split block writes its partial
// to its slot of a scratch buffer, fences, and counts itself in the
// block's counter; the CTA that counts last reads the block's partials
// in chunk order (through L2), combines them, writes the rows once, and
// resets the counter to 0 for the next call.  So every output row is
// written exactly once, and partials are combined in a fixed order.
//
// What bounds it.  The call must read vals (E*D*4) and ids (E*4) and
// write out (V*D*4) once, about E*(4+4) + V*4 bytes at D=1; split blocks
// add their partials (slots * block_size * D * 4, written and read once,
// mostly in L2).  The arithmetic is one add or compare per value.  Every
// input is read once, coalesced, with the ids and first values of four
// warp steps in flight per thread.  What bounds it is memory-level
// parallelism, not bytes: a chunk takes a few dependent trips to memory
// (its plan entry, then its loads), and at 50-56 registers a thread two
// CTAs of 512 threads fit on an SM, so the kernel stays well under the
// HBM rate (PERF.md gives its share of the bound); the merge of the
// largest split block by one CTA runs beside the other chunks.
//
// Exactness.  min and max are independent of the order of the updates,
// so both are bit-exact.  Floats are ordered through an order-preserving
// map onto int32 (atomicMin/atomicMax on the key) in which -0.0 sorts
// below +0.0.  A NaN, whatever its sign bit, takes the extreme key of the
// reduction (INT_MAX for max, INT_MIN for min), so a row that holds a NaN
// comes out NaN, as jax.ops.segment_min/max give it.  The int32 sum is
// exact (it wraps as two's complement does, in any order).  The float
// sum is not order independent: the scan's order is fixed, but the
// shared-memory atomics of the warps land in an order that changes from
// run to run, so the f32 sum is run-dependent.
//
// Each entry point launches on the caller's stream, allocates nothing
// (out, the partials and the counters come from the caller), and returns
// cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// warp steps whose loads a thread issues before it reduces them
constexpr int kUnroll = 4;

// The key of a float for a min (IS_MIN) or a max: a NaN wins either.
template <bool IS_MIN>
__device__ __forceinline__ int float_key(float f) {
  if (f != f) return IS_MIN ? INT_MIN : INT_MAX;  // a NaN
  const int bits = __float_as_int(f);
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// A reduction: In is the element type of vals and out, Acc the word the
// accumulator holds.
struct SumF32 {
  using In = float;
  using Acc = float;
  static __device__ __forceinline__ Acc ident() { return 0.0f; }
  static __device__ __forceinline__ Acc from(In v) { return v; }
  static __device__ __forceinline__ In to(Acc a) { return a; }
  static __device__ __forceinline__ Acc combine(Acc a, Acc b) { return a + b; }
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) {
    atomicAdd(p, v);
  }
};

struct SumI32 {
  using In = int;
  using Acc = int;
  static __device__ __forceinline__ Acc ident() { return 0; }
  static __device__ __forceinline__ Acc from(In v) { return v; }
  static __device__ __forceinline__ In to(Acc a) { return a; }
  static __device__ __forceinline__ Acc combine(Acc a, Acc b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) {
    atomicAdd(p, v);
  }
};

// Min or max over int32 keys.  For int32 values the key is the value;
// for float32 values (passed as their bits) it is float_key(value).  The
// keys of a NaN map back to a NaN: INT_MAX to 0x7fffffff, INT_MIN to
// 0xffffffff.
template <bool IS_FLOAT, bool IS_MIN>
struct MinMax {
  using In = int;
  using Acc = int;
  static __device__ __forceinline__ Acc ident() {
    // float_key(+inf) = 0x7f800000; float_key(-inf) = 0xff800000 ^ 0x7fffffff
    if (IS_FLOAT) return IS_MIN ? 0x7f800000 : static_cast<int>(0x807fffffu);
    return IS_MIN ? INT_MAX : INT_MIN;
  }
  static __device__ __forceinline__ Acc from(In v) {
    return IS_FLOAT ? float_key<IS_MIN>(__int_as_float(v)) : v;
  }
  static __device__ __forceinline__ In to(Acc a) {
    return IS_FLOAT ? __float_as_int(key_float(a)) : a;
  }
  static __device__ __forceinline__ Acc combine(Acc a, Acc b) {
    return IS_MIN ? min(a, b) : max(a, b);
  }
  static __device__ __forceinline__ void atomic(Acc* p, Acc v) {
    if (IS_MIN) {
      atomicMin(p, v);
    } else {
      atomicMax(p, v);
    }
  }
};

// Four words of partials at once, read through L2 (another CTA wrote
// them).
template <class Acc>
struct Quad {
  Acc w[4];
};

__device__ __forceinline__ float from_bits(int b, float) {
  return __int_as_float(b);
}
__device__ __forceinline__ int from_bits(int b, int) { return b; }

template <class Acc>
__device__ __forceinline__ Quad<Acc> load_quad(const Acc* p) {
  const int4 q = __ldcg(reinterpret_cast<const int4*>(p));
  return Quad<Acc>{{from_bits(q.x, Acc()), from_bits(q.y, Acc()),
                    from_bits(q.z, Acc()), from_bits(q.w, Acc())}};
}

// One CTA per chunk.  plan is [5, n_chunks] int32: block, start, end,
// index among its block's chunks, slot in partials (-1: the block has one
// chunk).  lanes = 1 << log2_lanes lanes share an edge.
template <class Op>
__global__ void __launch_bounds__(1024)
seg_reduce_kernel(const typename Op::In* __restrict__ vals,
                  const int* __restrict__ ids,
                  const int* __restrict__ block_ptr,
                  const int* __restrict__ plan, int n_chunks, int chunk_e,
                  typename Op::In* __restrict__ out,
                  typename Op::Acc* __restrict__ partials,
                  int* __restrict__ counters, int block_size,
                  int num_segments, int d, int log2_lanes) {
  using Acc = typename Op::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* acc = reinterpret_cast<Acc*>(smem);
  const int c = blockIdx.x;
  const int b = plan[c];
  const int lo = plan[n_chunks + c];
  const int n_edges = plan[2 * n_chunks + c] - lo;
  const int index = plan[3 * n_chunks + c];
  const int slot = plan[4 * n_chunks + c];
  const int n_acc = block_size * d;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = Op::ident();
  __syncthreads();

  const int lanes = 1 << log2_lanes;   // lanes per edge
  const int group = 32 >> log2_lanes;  // edges per warp step
  const int lane = threadIdx.x & 31;
  const int g = lane >> log2_lanes;    // the lane's edge within the step
  const int s = lane & (lanes - 1);    // its first feature
  const int n_feat = (d + lanes - 1) >> log2_lanes;
  unsigned leaders = 0;                // the first lane of every edge
  for (int k = 0; k < 32; k += lanes) leaders |= 1u << k;
  const unsigned upto = (2u << lane) - 1u;  // lanes 0 .. lane
  const int next = lane - s + lanes;        // first lane of the next edge
  const long long base = static_cast<long long>(b) * block_size;
  const int* __restrict__ chunk_ids = ids + lo;
  const typename Op::In* __restrict__ chunk_vals =
      vals + static_cast<long long>(lo) * d;

  const int step = group * kUnroll;
  for (int k0 = (threadIdx.x >> 5) * step; k0 < n_edges;
       k0 += (blockDim.x >> 5) * step) {
    int lid[kUnroll], start[kUnroll];
    bool tail[kUnroll], scan[kUnroll];
    Acc v[kUnroll];
    // the ids and the first feature's values, all loads in flight at once
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u * group + g;
      lid[u] = k < n_edges ? chunk_ids[k] : 0;
      v[u] = (k < n_edges && s < d) ? Op::from(chunk_vals[k * d + s])
                                    : Op::ident();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long l = lid[u] - base;
      // -1: no edge, or an id outside the block
      lid[u] = (k0 + u * group + g < n_edges && l >= 0 && l < block_size)
                   ? static_cast<int>(l)
                   : -1;
      const int prev =
          group > 1 ? __shfl_up_sync(kFull, lid[u], lanes) : lid[u];
      const bool head = g == 0 || prev != lid[u];
      const unsigned heads = __ballot_sync(kFull, head && s == 0);
      start[u] = 31 - __clz(heads & upto);  // first lane of the lane's run
      tail[u] = next >= 32 || ((heads >> next) & 1u);
      scan[u] = heads != leaders;  // some run spans two edges
    }
    for (int j = 0; j < n_feat; ++j) {
      const int f = s + (j << log2_lanes);
      if (j > 0) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + u * group + g;
          v[u] = (k < n_edges && f < d) ? Op::from(chunk_vals[k * d + f])
                                        : Op::ident();
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (scan[u]) {  // warp-uniform
          for (int off = lanes; off < 32; off <<= 1) {
            const Acc o = __shfl_up_sync(kFull, v[u], off);
            if (lane - off >= start[u]) v[u] = Op::combine(v[u], o);
          }
        }
        if (tail[u] && lid[u] >= 0 && f < d) {
          Op::atomic(&acc[lid[u] * d + f], v[u]);
        }
      }
    }
  }
  __syncthreads();

  // rows of this block that exist: the last block may be cut short
  typename Op::In* __restrict__ out_block = out + base * d;
  const long long left = static_cast<long long>(num_segments) * d - base * d;
  const int n_out = left < n_acc ? static_cast<int>(left) : n_acc;
  if (slot < 0) {
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
      out_block[i] = Op::to(acc[i]);
    }
    return;
  }

  Acc* __restrict__ part = partials + static_cast<long long>(slot) * n_acc;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) part[i] = acc[i];
  __threadfence();
  __syncthreads();
  const int n_parts =
      (block_ptr[b + 1] - block_ptr[b] + chunk_e - 1) / chunk_e;
  int ticket = 0;
  if (threadIdx.x == 0) ticket = atomicAdd(&counters[b], 1);
  if (!__syncthreads_or(threadIdx.x == 0 && ticket == n_parts - 1)) return;
  // the last chunk of the block: combine the partials in chunk order
  __threadfence();
  if (threadIdx.x == 0) counters[b] = 0;
  const Acc* first = partials + static_cast<long long>(slot - index) * n_acc;
  if ((n_acc & 3) == 0) {  // 16-byte loads: every slot starts aligned
    for (int i = 4 * threadIdx.x; i < n_out; i += 4 * blockDim.x) {
      Quad<Acc> r = load_quad(first + i);
#pragma unroll 8
      for (int p = 1; p < n_parts; ++p) {
        const Quad<Acc> q =
            load_quad(first + static_cast<long long>(p) * n_acc + i);
#pragma unroll
        for (int w = 0; w < 4; ++w) r.w[w] = Op::combine(r.w[w], q.w[w]);
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        if (i + w < n_out) out_block[i + w] = Op::to(r.w[w]);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    Acc r = __ldcg(first + i);
#pragma unroll 8
    for (int p = 1; p < n_parts; ++p) {
      r = Op::combine(
          r, __ldcg(first + static_cast<long long>(p) * n_acc + i));
    }
    out_block[i] = Op::to(r);
  }
}

template <class Op>
int launch(const void* vals, const int* ids, const int* block_ptr,
           const int* plan, int n_chunks, int chunk_e, void* out,
           void* partials, int* counters, int block_size, int num_segments,
           int d, int threads, cudaStream_t stream) {
  int log2_lanes = 0;
  while (log2_lanes < 5 && (1 << log2_lanes) < d) ++log2_lanes;
  const size_t smem =
      static_cast<size_t>(block_size) * d * sizeof(typename Op::Acc);
  seg_reduce_kernel<Op><<<n_chunks, threads, smem, stream>>>(
      static_cast<const typename Op::In*>(vals), ids, block_ptr, plan,
      n_chunks, chunk_e, static_cast<typename Op::In*>(out),
      static_cast<typename Op::Acc*>(partials), counters, block_size,
      num_segments, d, log2_lanes);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The gathered push reduce: gathered_reduce_{f32,i32}.
//
// Replaces no TPU kernel: the reference reduces the gathered slice with a
// plain XLA scatter (src/repro/kernels/segment_reduce/sparse.py).  It
// backs gathered_segment_reduce (sparse.py) on the card, because a
// library scatter that sends the dead slots to one trash row serialises
// on that row (see Design).
//
// What it computes.  vals[s, :] (D = 1 or more words a slot) is reduced
// into out[ids[s], :] for every slot s whose id lies in [0, num_segments);
// any other id (-1 for padding past the frontier's edges and for edges
// whose predicate failed) marks a dead slot.  out comes from the caller,
// filled with the identity: the value for a sum and for int32 min/max,
// the key of +-inf for a float min/max (see below).
//
// Design.  Most slots of a sparse iteration are dead: the gather fills
// every slot past the frontier's edge count with -1.  A scatter that
// sends them to one trash row serialises a million atomic updates on one
// address.  Here a dead slot makes no atomic and no store, and its value
// is never loaded: there is no trash row.  One launch covers the whole
// slice.  At D = 1 each thread reads 4 consecutive slots' ids with one
// 16-byte load; a warp whose 128 slots are all dead (__ballot_sync == 0)
// goes on to the next without loading a value.  A live slot's thread
// loads its values (16 bytes at once where all 4 slots exist) and applies
// one global atomic per live slot: atomicAdd for a sum, atomicMin/Max on
// int32 for a min/max.  At D > 1, L lanes (D rounded up to a power of
// two, at most 32) share a slot as in the blocked kernel, and a dead slot
// skips its row.  A float min/max runs on K2's order-preserving int32
// keys; a second small launch decodes the [num_segments, D] keys back to
// floats in place.
//
// What bounds it.  The ids are read once (4 bytes a slot) and the values
// of live slots once (4*D bytes each): at most 8 bytes a slot at D = 1,
// about 9.6 MB over urand19's 1,198,333 slots; the atomics land in out,
// which (2 MB at V = 524,288) stays in L2.  The caller's fill of out and
// the decode read and write V*D words once each.  With few live slots the
// launch is bounded by reading the ids and by the fill.
//
// Exactness.  min and max are exact in any order of the atomics; floats
// order -0.0 below +0.0, and a row that receives a NaN comes out NaN, as
// K2 gives them.  The int32 sum is exact (it wraps as two's complement
// does, in any order).  The float sum is not: the atomics land in an
// order that changes from run to run.

constexpr int kGatherThreads = 256;
// consecutive slots a thread reads at D = 1 (one 16-byte load of ids)
constexpr int kGatherSlots = 4;
constexpr long long kMaxBlocks = 1 << 20;

template <class Op>
__global__ void __launch_bounds__(kGatherThreads)
gathered_reduce_kernel(const typename Op::In* __restrict__ vals,
                       const int* __restrict__ ids, long long n_slots,
                       typename Op::Acc* __restrict__ out,
                       int num_segments) {
  using In = typename Op::In;
  const int lane = threadIdx.x & 31;
  // 16-byte loads need both arrays aligned; a slice may start anywhere
  const bool aligned = ((reinterpret_cast<unsigned long long>(vals) |
                         reinterpret_cast<unsigned long long>(ids)) &
                        15) == 0;
  const long long stride =
      static_cast<long long>(gridDim.x) * blockDim.x * kGatherSlots;
  // warp-uniform: every lane of a warp runs the same iterations
  for (long long w0 = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       (threadIdx.x & ~31)) *
                      kGatherSlots;
       w0 < n_slots; w0 += stride) {
    const long long s0 = w0 + lane * kGatherSlots;
    const bool whole = aligned && s0 + kGatherSlots <= n_slots;
    int id[kGatherSlots];
    if (whole) {
      const int4 q = *reinterpret_cast<const int4*>(ids + s0);
      id[0] = q.x;
      id[1] = q.y;
      id[2] = q.z;
      id[3] = q.w;
    } else {
#pragma unroll
      for (int u = 0; u < kGatherSlots; ++u) {
        id[u] = s0 + u < n_slots ? ids[s0 + u] : -1;
      }
    }
    unsigned live = 0;
#pragma unroll
    for (int u = 0; u < kGatherSlots; ++u) {
      // one compare drops both id < 0 and id >= num_segments
      live |= (static_cast<unsigned>(id[u]) <
               static_cast<unsigned>(num_segments))
              << u;
    }
    if (__ballot_sync(kFull, live != 0) == 0) continue;  // a dead warp
    if (live == 0) continue;
    In v[kGatherSlots];
    if (whole) {
      const Quad<In> q = load_quad(vals + s0);
#pragma unroll
      for (int u = 0; u < kGatherSlots; ++u) v[u] = q.w[u];
    } else {
#pragma unroll
      for (int u = 0; u < kGatherSlots; ++u) {
        v[u] = (live >> u) & 1u ? vals[s0 + u] : In();
      }
    }
#pragma unroll
    for (int u = 0; u < kGatherSlots; ++u) {
      if ((live >> u) & 1u) Op::atomic(&out[id[u]], Op::from(v[u]));
    }
  }
}

// D > 1: lanes = 1 << log2_lanes lanes share a slot, 32 / lanes slots a
// warp step; a lane loops over the features f = s, s + lanes, ..
template <class Op>
__global__ void __launch_bounds__(kGatherThreads)
gathered_reduce_rows_kernel(const typename Op::In* __restrict__ vals,
                            const int* __restrict__ ids, long long n_slots,
                            int d, typename Op::Acc* __restrict__ out,
                            int num_segments, int log2_lanes) {
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << log2_lanes;
  const int group = 32 >> log2_lanes;
  const int s = lane & (lanes - 1);
  const long long stride =
      static_cast<long long>(gridDim.x) * (blockDim.x >> 5) * group;
  for (long long slot = (static_cast<long long>(blockIdx.x) *
                             (blockDim.x >> 5) +
                         (threadIdx.x >> 5)) *
                            group +
                        (lane >> log2_lanes);
       slot < n_slots; slot += stride) {
    const int id = ids[slot];
    if (static_cast<unsigned>(id) >= static_cast<unsigned>(num_segments)) {
      continue;  // a dead slot: no value load, no atomic
    }
    const typename Op::In* __restrict__ row = vals + slot * d;
    typename Op::Acc* __restrict__ dst = out + static_cast<long long>(id) * d;
    for (int f = s; f < d; f += lanes) Op::atomic(&dst[f], Op::from(row[f]));
  }
}

// float min/max: out's int32 keys back to float bits, in place
__global__ void __launch_bounds__(kGatherThreads)
key_decode_kernel(int* __restrict__ out, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[i] = __float_as_int(key_float(out[i]));
  }
}

// a grid of at most kMaxBlocks blocks; the kernels stride over the rest
unsigned blocks_for(long long items, long long per_block) {
  const long long b = (items + per_block - 1) / per_block;
  return static_cast<unsigned>(b < kMaxBlocks ? b : kMaxBlocks);
}

template <class Op>
int launch_gathered(const void* vals, const int* ids, long long n_slots,
                    int d, void* out, int num_segments, bool decode,
                    cudaStream_t stream) {
  using In = typename Op::In;
  using Acc = typename Op::Acc;
  if (n_slots > 0 && num_segments > 0 && d > 0) {
    if (d == 1) {
      gathered_reduce_kernel<Op>
          <<<blocks_for(n_slots, kGatherThreads * kGatherSlots),
             kGatherThreads, 0, stream>>>(static_cast<const In*>(vals), ids,
                                          n_slots, static_cast<Acc*>(out),
                                          num_segments);
    } else {
      int log2_lanes = 0;
      while (log2_lanes < 5 && (1 << log2_lanes) < d) ++log2_lanes;
      const long long per_block = (kGatherThreads / 32) * (32 >> log2_lanes);
      gathered_reduce_rows_kernel<Op>
          <<<blocks_for(n_slots, per_block), kGatherThreads, 0, stream>>>(
              static_cast<const In*>(vals), ids, n_slots, d,
              static_cast<Acc*>(out), num_segments, log2_lanes);
    }
  }
  const long long n_out = static_cast<long long>(num_segments) * d;
  if (decode && n_out > 0) {
    key_decode_kernel<<<blocks_for(n_out, kGatherThreads), kGatherThreads,
                        0, stream>>>(static_cast<int*>(out), n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// kind: 0 sum, 1 min, 2 max
template <bool IS_FLOAT, class Sum>
int gathered(const void* vals, const int* ids, long long n_slots, int d,
             void* out, int num_segments, int kind, cudaStream_t stream) {
  switch (kind) {
    case 0:
      return launch_gathered<Sum>(vals, ids, n_slots, d, out, num_segments,
                                  false, stream);
    case 1:
      return launch_gathered<MinMax<IS_FLOAT, true>>(
          vals, ids, n_slots, d, out, num_segments, IS_FLOAT, stream);
    case 2:
      return launch_gathered<MinMax<IS_FLOAT, false>>(
          vals, ids, n_slots, d, out, num_segments, IS_FLOAT, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int seg_sum_f32(const float* vals, const int* ids, const int* block_ptr,
                const int* plan, int n_chunks, int chunk_e, float* out,
                float* partials, int* counters, int block_size,
                int num_segments, int d, int threads, void* stream) {
  return launch<SumF32>(vals, ids, block_ptr, plan, n_chunks, chunk_e, out,
                        partials, counters, block_size, num_segments, d,
                        threads, static_cast<cudaStream_t>(stream));
}

int seg_sum_i32(const int* vals, const int* ids, const int* block_ptr,
                const int* plan, int n_chunks, int chunk_e, int* out,
                int* partials, int* counters, int block_size,
                int num_segments, int d, int threads, void* stream) {
  return launch<SumI32>(vals, ids, block_ptr, plan, n_chunks, chunk_e, out,
                        partials, counters, block_size, num_segments, d,
                        threads, static_cast<cudaStream_t>(stream));
}

// float32 values pass as their bits; partials hold int32 keys
int seg_minmax_f32(const float* vals, const int* ids, const int* block_ptr,
                   const int* plan, int n_chunks, int chunk_e, float* out,
                   int* partials, int* counters, int block_size,
                   int num_segments, int d, int is_min, int threads,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_min
             ? launch<MinMax<true, true>>(vals, ids, block_ptr, plan,
                                          n_chunks, chunk_e, out, partials,
                                          counters, block_size, num_segments,
                                          d, threads, st)
             : launch<MinMax<true, false>>(vals, ids, block_ptr, plan,
                                           n_chunks, chunk_e, out, partials,
                                           counters, block_size,
                                           num_segments, d, threads, st);
}

int seg_minmax_i32(const int* vals, const int* ids, const int* block_ptr,
                   const int* plan, int n_chunks, int chunk_e, int* out,
                   int* partials, int* counters, int block_size,
                   int num_segments, int d, int is_min, int threads,
                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_min
             ? launch<MinMax<false, true>>(vals, ids, block_ptr, plan,
                                           n_chunks, chunk_e, out, partials,
                                           counters, block_size,
                                           num_segments, d, threads, st)
             : launch<MinMax<false, false>>(vals, ids, block_ptr, plan,
                                            n_chunks, chunk_e, out, partials,
                                            counters, block_size,
                                            num_segments, d, threads, st);
}

// The gathered push reduce.  out is [num_segments, d], filled by the
// caller with the identity (for a float min/max: the identity's int32
// key, decoded to float bits in place before the call returns).
int gathered_reduce_f32(const float* vals, const int* ids, long long n_slots,
                        int d, void* out, int num_segments, int kind,
                        void* stream) {
  return gathered<true, SumF32>(vals, ids, n_slots, d, out, num_segments,
                                kind, static_cast<cudaStream_t>(stream));
}

int gathered_reduce_i32(const int* vals, const int* ids, long long n_slots,
                        int d, void* out, int num_segments, int kind,
                        void* stream) {
  return gathered<false, SumI32>(vals, ids, n_slots, d, out, num_segments,
                                 kind, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
