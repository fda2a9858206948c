// Table-batched embedding-bag gather and pool for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/embedding_bag/kernel.py:
//   embag_tables_f32  <- embedding_bag_pallas (_embag_kernel, line 26)
//
// What it computes.  F tables, table f float32 [R_f, D]; idx int32
// [B, F, P] (bag stride idx_bs, table stride idx_ts, the P entries of a
// bag contiguous) -> out [B, F, D] (bag stride out_bs, table stride
// out_ts, the D values of a row contiguous):
//   out[b, f, :] = sum over p = 0..P-1, in order, of table_f[idx[b, f, p], :]
// and, for mean, that sum divided by P (a true division, as the TPU
// kernel's `pooled / pool`).  Indices follow jnp.take against each
// table's own row count: an index in [-R_f, 0) wraps to index + R_f; an
// index >= R_f or < -R_f is never read and gives a row of NaN.  The
// single-table call of the TPU kernel is the case F = 1.  The strides
// let a caller write the pooled rows straight into a slice of a larger
// tensor (DLRM's interaction input z[:, 1:, :]).
//
// Design.  The TPU kernel scalar-prefetches a tile's indices and issues
// every row DMA of the tile before it awaits any.  Here:
// - One grid covers the B*F (bag, table) items.  A warp pools G
//   neighbouring items w (b = w / F, f = w % F), so a warp and its CTA
//   write neighbouring rows of out.  A whole DLRM forward is one launch,
//   whatever F.
// - The F table pointers and row counts go by value, in a
//   __grid_constant__ struct of at most kMaxTables entries (1 KB of the
//   4 KB of kernel parameters): no device array of pointers, no copy
//   from the host per call.
// - Bags of one index (DLRM's): lane i loads item i's index (one
//   coalesced load for the warp), and the warp issues the rows of all G
//   items, 16-byte float4 loads when D % 4 == 0 and every row is 16-byte
//   aligned (512 contiguous bytes of a row per load at D = 128), before
//   it stores any.  A warp of one item had its index load and its row
//   load in series and nothing else in flight, and at 48 registers fewer
//   warps per SM: 46 % of the byte bound at serve_bulk's shape, against
//   75 % at G = 4 (PERF.md).
// - Longer bags: a warp pools its G items one after another; a bag's
//   indices come 32 at a time in one coalesced load, handed to every lane
//   with __shfl_sync, and the rows of 4 indices are loaded back to back
//   before they are added.
// - L2.  Row loads skip L1 (ld.global.nc.L1::no_allocate: no row is read
//   twice by a warp) and carry an L2 policy: evict_last for the smallest
//   tables, as many as fit kKeepBytes together (chosen on the host per
//   call), whose rows repeat across the batch; evict_first for the large
//   ones, whose random rows seldom do.  Stores stream (st.global.cs), so
//   3.5 GB of output at serve_bulk's batch does not push the small
//   tables out of L2.  Without the policies, one launch over all 26
//   tables was slower than 26 launches of one table each (2.06 against
//   1.88 ms, PERF.md), each of which had L2 to one table.
// - The first row initialises the accumulator, so a bag of one row is
//   copied bit for bit, and the sum runs over p in order: the batched
//   call and F single-table calls give the same bits.
// - Row offsets are 64-bit: idx * D passes 2^31 in the large tables.
//
// What bounds it.  Bytes: the rows it gathers (each distinct row once at
// best: a small table's rows stay in L2), the indices (B*F*P*4) and the
// output (B*F*D*4), written once; one add per gathered value.  Rows are
// random, so the rate depends on how many independent loads are in
// flight and on L2 keeping the rows that repeat.  A small batch is
// latency: one index load, then one row load, per warp.
//
// Each entry point launches on the caller's stream, allocates nothing,
// and returns a cudaError_t: cudaErrorInvalidValue for arguments the
// kernel does not take, else cudaGetLastError(), so that a refused
// launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTables = 64;
constexpr int kUnroll = 4;
constexpr unsigned kAll = 0xffffffffu;
// Bytes of the smallest tables whose rows are loaded to stay in L2
// (evict_last), of the card's 50 MB
constexpr long long kKeepBytes = 40LL << 20;

struct Tables {
  const float* ptr[kMaxTables];
  long long rows[kMaxTables];
  unsigned long long keep;  // bit f: table f's rows stay in L2
};

// W floats per lane: a float4 (W = 4) or one float (W = 1).
template <int W>
struct Vec;

template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T load(const float* p,
                                           unsigned long long policy) {
    T v;
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 "
        "{%0, %1, %2, %3}, [%4], %5;"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p), "l"(policy));
    return v;
  }
  static __device__ __forceinline__ T fill(float x) {
    return make_float4(x, x, x, x);
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ void div(T& a, float n) {
    a.x /= n;
    a.y /= n;
    a.z /= n;
    a.w /= n;
  }
  static __device__ __forceinline__ void store(float* p, const T& v) {
    asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
                 "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
  }
};

template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T load(const float* p,
                                           unsigned long long policy) {
    T v;
    asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
        : "=f"(v)
        : "l"(p), "l"(policy));
    return v;
  }
  static __device__ __forceinline__ T fill(float x) { return x; }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
  static __device__ __forceinline__ void div(T& a, float n) { a /= n; }
  static __device__ __forceinline__ void store(float* p, const T& v) {
    asm volatile("st.global.cs.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");
  }
};

// One bag of P > 1 rows, pooled by a whole warp: its indices 32 at a
// time in one coalesced load, handed to every lane by __shfl_sync, then
// the rows of 4 indices loaded back to back before they are added in p
// order.  Every lane runs every step (the shuffles need all 32); a lane
// past the row's end loads and stores nothing.
// The L2 policy of table f's row loads: evict_last for a kept table,
// evict_first for the others, whose rows are seldom read twice.
__device__ __forceinline__ unsigned long long row_policy(
    const Tables& tables, int f) {
  unsigned long long policy;
  if ((tables.keep >> f) & 1ull) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
        : "=l"(policy));
  } else {
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
        : "=l"(policy));
  }
  return policy;
}

template <int W>
__device__ __forceinline__ void pool_bag(const float* table, long long n_rows,
                                         unsigned long long policy,
                                         const int* bag_idx, float* out_row,
                                         int pool, int d, bool mean,
                                         int lane) {
  using V = Vec<W>;
  using T = typename V::T;
  const float qnan = __int_as_float(0x7fc00000);
  for (int c0 = 0; c0 < d; c0 += 32 * W) {
    const int c = c0 + lane * W;
    const bool col = c < d;
    T acc = V::fill(0.0f);  // set from the row of p = 0
    for (int p0 = 0; p0 < pool; p0 += 32) {
      const int np = min(32, pool - p0);
      const int mine = lane < np ? __ldg(bag_idx + p0 + lane) : 0;
      for (int q = 0; q < np; q += kUnroll) {
        T v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long raw = __shfl_sync(kAll, mine, min(q + u, np - 1));
          v[u] = V::fill(qnan);
          if (raw >= -n_rows && raw < n_rows && col && q + u < np) {
            v[u] = V::load(table + (raw < 0 ? raw + n_rows : raw) * d + c,
                           policy);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (q + u < np) {
            if (p0 + q + u == 0) {
              acc = v[u];
            } else {
              V::add(acc, v[u]);
            }
          }
        }
      }
    }
    if (col) {
      if (mean) V::div(acc, static_cast<float>(pool));
      V::store(out_row + c, acc);
    }
  }
}

// A warp pools the G items first .. first+G-1 (fewer at the grid's end).
// Item w is (b, f) = (w / F, w % F), so the next item is the next table
// of the same bag, or table 0 of the next bag.
template <int G, int W>
__global__ void embag_tables_kernel(const __grid_constant__ Tables tables,
                                    const int* __restrict__ idx,
                                    float* __restrict__ out,
                                    long long items, int n_tables, int pool,
                                    long long idx_bs, long long idx_ts,
                                    long long out_bs, long long out_ts, int d,
                                    bool mean) {
  using V = Vec<W>;
  using T = typename V::T;
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) *
                             (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long first = warp * G;
  if (first >= items) return;  // whole warps leave together
  const int live = static_cast<int>(min(static_cast<long long>(G),
                                        items - first));
  const long long b0 = first / n_tables;
  const int f0 = static_cast<int>(first - b0 * n_tables);

  if (pool > 1) {
    long long b = b0;
    int f = f0;
    for (int i = 0; i < live; ++i) {
      pool_bag<W>(tables.ptr[f], tables.rows[f], row_policy(tables, f),
                  idx + b * idx_bs + f * idx_ts, out + b * out_bs + f * out_ts,
                  pool, d, mean, lane);
      if (++f == n_tables) {
        f = 0;
        ++b;
      }
    }
    return;
  }

  // P = 1, a copy of one row per item (the mean divides by 1, which
  // changes no bit): lane i loads item i's index, then the warp issues the
  // rows of all G items before it stores any.
  int mine = 0;
  if (lane < live) {
    const int g = f0 + lane;
    mine = __ldg(idx + (b0 + g / n_tables) * idx_bs + (g % n_tables) * idx_ts);
  }
  const float qnan = __int_as_float(0x7fc00000);
  for (int c0 = 0; c0 < d; c0 += 32 * W) {
    const int c = c0 + lane * W;
    const bool col = c < d;
    T v[G];
    int f = f0;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const long long raw = __shfl_sync(kAll, mine, i);
      const long long n_rows = tables.rows[f];
      v[i] = V::fill(qnan);
      if (raw >= -n_rows && raw < n_rows && col && i < live) {
        v[i] = V::load(tables.ptr[f] + (raw < 0 ? raw + n_rows : raw) * d + c,
                       row_policy(tables, f));
      }
      if (++f == n_tables) f = 0;
    }
    long long b = b0;
    f = f0;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (col && i < live) V::store(out + b * out_bs + f * out_ts + c, v[i]);
      if (++f == n_tables) {
        f = 0;
        ++b;
      }
    }
  }
}

template <int G, int W>
void launch(const Tables& t, const int* idx, float* out, long long items,
            int n_tables, int pool, long long idx_bs, long long idx_ts,
            long long out_bs, long long out_ts, int d, bool mean,
            unsigned blocks, int threads, cudaStream_t s) {
  embag_tables_kernel<G, W><<<blocks, threads, 0, s>>>(
      t, idx, out, items, n_tables, pool, idx_bs, idx_ts, out_bs, out_ts, d,
      mean);
}

template <int W>
void launch_g(int g, const Tables& t, const int* idx, float* out,
              long long items, int n_tables, int pool, long long idx_bs,
              long long idx_ts, long long out_bs, long long out_ts, int d,
              bool mean, unsigned blocks, int threads, cudaStream_t s) {
  switch (g) {
    case 1:
      return launch<1, W>(t, idx, out, items, n_tables, pool, idx_bs, idx_ts,
                          out_bs, out_ts, d, mean, blocks, threads, s);
    case 2:
      return launch<2, W>(t, idx, out, items, n_tables, pool, idx_bs, idx_ts,
                          out_bs, out_ts, d, mean, blocks, threads, s);
    default:
      return launch<4, W>(t, idx, out, items, n_tables, pool, idx_bs, idx_ts,
                          out_bs, out_ts, d, mean, blocks, threads, s);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

extern "C" {

int embag_max_tables() { return kMaxTables; }

// tables: n_tables device pointers; rows: their row counts (host arrays,
// read during the call).  items_per_warp in {1, 2, 4} and threads
// a multiple of 32 in [32, 1024], or both 0 to let the call choose: 4
// items and 256 threads for bags of one index, 2 and 128 for longer bags
// (the fastest at the DLRM serving shapes, PERF.md), then fewer threads
// and items while the grid has fewer CTAs than the card has SMs (a small
// batch is latency: it wants every SM).
int embag_tables_f32(const void* const* tables, const long long* rows,
                     int n_tables, const int* idx, long long idx_bs,
                     long long idx_ts, float* out, long long out_bs,
                     long long out_ts, long long bags, int pool, int d,
                     int mean, int items_per_warp, int threads,
                     void* stream) {
  int g = items_per_warp;
  const long long items = bags * n_tables;
  auto ctas = [&]() {
    return ((items + g - 1) / g + threads / 32 - 1) / (threads / 32);
  };
  if (g == 0 && threads == 0) {
    g = pool == 1 ? 4 : 2;
    threads = pool == 1 ? 256 : 128;
    int device = 0, sms = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess) {
      return static_cast<int>(cudaGetLastError());
    }
    while (ctas() < sms && (threads > 128 || g > 1)) {
      if (threads > 128) {
        threads = 128;
      } else {
        g /= 2;
      }
    }
  }
  if (n_tables < 1 || n_tables > kMaxTables || pool < 1 || d < 1 ||
      bags < 0 || (g != 1 && g != 2 && g != 4) ||
      threads % 32 != 0 || threads < 32 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = ctas();
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (items == 0) return static_cast<int>(cudaSuccess);
  Tables t = {};
  bool vec4 = d % 4 == 0 && out_bs % 4 == 0 && out_ts % 4 == 0 &&
              aligned16(out);
  for (int f = 0; f < n_tables; ++f) {
    t.ptr[f] = static_cast<const float*>(tables[f]);
    t.rows[f] = rows[f];
    vec4 = vec4 && aligned16(tables[f]);
  }
  // keep the smallest tables in L2 while they fit kKeepBytes together
  for (long long kept = 0;;) {
    int next = -1;
    for (int f = 0; f < n_tables; ++f) {
      if (!((t.keep >> f) & 1ull) && (next < 0 || rows[f] < rows[next])) {
        next = f;
      }
    }
    if (next < 0) break;
    kept += rows[next] * d * 4LL;
    if (kept > kKeepBytes) break;
    t.keep |= 1ull << next;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned n_blocks = static_cast<unsigned>(blocks);
  if (vec4) {
    launch_g<4>(g, t, idx, out, items, n_tables, pool, idx_bs, idx_ts, out_bs,
                out_ts, d, mean != 0, n_blocks, threads, s);
  } else {
    launch_g<1>(g, t, idx, out, items, n_tables, pool, idx_bs, idx_ts, out_bs,
                out_ts, d, mean != 0, n_blocks, threads, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
