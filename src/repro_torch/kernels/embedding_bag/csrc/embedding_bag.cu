// Embedding-bag gather and pool for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/embedding_bag/kernel.py:
//   embag_f32  <- embedding_bag_pallas (_embag_kernel, line 26)
//
// What it computes.  table [R, D] float32, idx [B, P] int32 (row stride
// idx_stride, the P entries of a bag contiguous) -> out [B, D]:
//   out[b, :] = sum over p = 0..P-1, in order, of table[idx[b, p], :]
// and, for mean, that sum divided by P (a true division, as the TPU
// kernel's `pooled / pool`).  Indices follow jnp.take: an index in
// [-R, 0) wraps to index + R; an index >= R or < -R is never read and
// gives a row of NaN.
//
// Design.  The TPU kernel scalar-prefetches the indices and DMAs each row
// into VMEM, padding B to its bags per step.  Here one warp pools one
// bag: its lanes cover the row, with 16-byte float4 loads when D % 4 == 0
// and the table is 16-byte aligned, so a warp moves 512 contiguous bytes
// of a row per load.  All lanes read the same index word (a broadcast).
// The first row initialises the accumulator, so a bag of one row is
// copied bit for bit.  Nothing is padded: the grid covers exactly B bags.
// Row offsets are 64-bit: idx * D passes 2^31 in the large tables.
//
// What bounds it.  Bytes: the rows it gathers (B*P*D*4), the indices
// (B*P*4) and the output (B*D*4); one add per gathered value.  Each row
// is read once with full 32-byte sectors, and each output written once,
// so the traffic is that minimum.  Rows are random, so the rate depends
// on how many independent loads are in flight: 8 warps per CTA and many
// CTAs per SM keep them there.
//
// Each entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ long long resolve_row(long long r,
                                                 long long n_rows,
                                                 bool* ok) {
  *ok = r >= -n_rows && r < n_rows;
  return r < 0 ? r + n_rows : r;
}

template <bool VEC4>
__global__ void embag_kernel(const float* __restrict__ table,
                             const int* __restrict__ idx,
                             float* __restrict__ out, long long n_rows,
                             int d, int bags, int pool, long long idx_stride,
                             bool mean) {
  const int lane = threadIdx.x & 31;
  const long long bag = static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  if (bag >= bags) return;
  const int* bag_idx = idx + bag * idx_stride;
  float* out_row = out + bag * static_cast<long long>(d);
  const float qnan = __int_as_float(0x7fc00000);
  const float n = static_cast<float>(pool);

  if (VEC4) {
    for (int c = lane * 4; c < d; c += 128) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int p = 0; p < pool; ++p) {
        bool ok;
        const long long r = resolve_row(bag_idx[p], n_rows, &ok);
        float4 v = make_float4(qnan, qnan, qnan, qnan);
        if (ok) {
          v = __ldg(reinterpret_cast<const float4*>(
              table + r * static_cast<long long>(d) + c));
        }
        if (p == 0) {
          acc = v;
        } else {
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
      }
      if (mean) {
        acc.x /= n;
        acc.y /= n;
        acc.z /= n;
        acc.w /= n;
      }
      *reinterpret_cast<float4*>(out_row + c) = acc;
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float acc = 0.0f;
      for (int p = 0; p < pool; ++p) {
        bool ok;
        const long long r = resolve_row(bag_idx[p], n_rows, &ok);
        const float v =
            ok ? __ldg(table + r * static_cast<long long>(d) + c) : qnan;
        acc = p == 0 ? v : acc + v;
      }
      out_row[c] = mean ? acc / n : acc;
    }
  }
}

}  // namespace

extern "C" {

int embag_f32(const float* table, const int* idx, float* out,
              long long n_rows, int d, int bags, int pool,
              long long idx_stride, int mean, void* stream) {
  const int blocks = (bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = 32 * kWarpsPerBlock;
  const bool vec4 =
      d % 4 == 0 && reinterpret_cast<unsigned long long>(table) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    embag_kernel<true><<<blocks, threads, 0, s>>>(
        table, idx, out, n_rows, d, bags, pool, idx_stride, mean != 0);
  } else {
    embag_kernel<false><<<blocks, threads, 0, s>>>(
        table, idx, out, n_rows, d, bags, pool, idx_stride, mean != 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
