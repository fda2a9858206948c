// Blocked segment reductions for Hopper (sm_90a): the DeNovo analogue.
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/segment_reduce/kernel.py:
//   seg_sum_{f32,i32}      <- seg_sum_pallas     (_sum_kernel, line 80)
//   seg_minmax_{f32,i32}   <- seg_minmax_pallas  (_minmax_kernel, line 132)
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
// Design.  One CTA owns one output block.  It keeps the block's
// [block_size, D] accumulator in shared memory (the SM's L1), walks the
// block's edge range with a stride of blockDim.x (the TPU plan's tile_e),
// applies every update with a shared-memory atomic, and writes the block
// back to device memory once.  The TPU kernel kept the block resident in
// VMEM across the sequential grid steps of its tiles; here the loop
// inside the CTA takes the place of that sequential grid dimension, and
// blocks run in parallel because no two CTAs share an output row.
//
// What bounds it.  Bytes: each call reads vals (E*D*4), ids (E*4) and
// block_ptr, and writes the output (V*D*4) once, about E*(4+4) + V*4
// bytes at D=1; the arithmetic is one add or compare per value.  The
// design reads each input exactly once, coalesced (consecutive threads
// take consecutive (edge, feature) slots), keeps every partial result in
// shared memory, and never resolves an update in device memory, so its
// device-memory traffic is that minimum.  Contention on a hub vertex's
// shared-memory word is the cost it pays instead.
//
// Exactness.  min and max are independent of the order of the updates,
// so both are bit-exact.  Floats are ordered through an order-preserving
// map onto int32 (atomicMin/atomicMax on the key): a total order in which
// -0.0 sorts below +0.0 and a NaN with the sign bit clear sorts above
// +inf.  The int32 sum is exact (it wraps as two's complement does, in
// any order).  The float sum is not order independent: shared-memory
// atomics land in an order that changes from run to run.
//
// Each entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() so that a refused launch is reported.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int float_key(float f) {
  const int bits = __float_as_int(f);
  return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int key) {
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

// Sum of float32 or int32 values (T), one shared-memory atomicAdd per
// value.
template <typename T>
__global__ void seg_sum_kernel(const T* __restrict__ vals,
                               const int* __restrict__ ids,
                               const int* __restrict__ block_ptr,
                               T* __restrict__ out,
                               int block_size, int num_segments, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem);
  const int n_acc = block_size * d;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = T(0);
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * block_size;
  const long long lo = static_cast<long long>(block_ptr[blockIdx.x]) * d;
  const long long hi = static_cast<long long>(block_ptr[blockIdx.x + 1]) * d;
  for (long long k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    const long long e = k / d;
    const long long lid = ids[e] - base;
    if (lid >= 0 && lid < block_size) {
      atomicAdd(&acc[lid * d + (k - e * d)], vals[k]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const long long row = base + i / d;
    if (row < num_segments) out[row * d + i % d] = acc[i];
  }
}

// Min or max over int32 keys.  For int32 values the key is the value;
// for float32 values it is float_key(value).
template <bool IS_FLOAT, bool IS_MIN>
__global__ void seg_minmax_kernel(const int* __restrict__ vals,
                                  const int* __restrict__ ids,
                                  const int* __restrict__ block_ptr,
                                  int* __restrict__ out,
                                  int block_size, int num_segments, int d,
                                  int ident_key) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* acc = reinterpret_cast<int*>(smem);
  const int n_acc = block_size * d;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = ident_key;
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * block_size;
  const long long lo = static_cast<long long>(block_ptr[blockIdx.x]) * d;
  const long long hi = static_cast<long long>(block_ptr[blockIdx.x + 1]) * d;
  for (long long k = lo + threadIdx.x; k < hi; k += blockDim.x) {
    const long long e = k / d;
    const long long lid = ids[e] - base;
    if (lid >= 0 && lid < block_size) {
      const int v = vals[k];
      const int key = IS_FLOAT ? float_key(__int_as_float(v)) : v;
      int* slot = &acc[lid * d + (k - e * d)];
      if (IS_MIN) {
        atomicMin(slot, key);
      } else {
        atomicMax(slot, key);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const long long row = base + i / d;
    if (row < num_segments) {
      const int key = acc[i];
      out[row * d + i % d] = IS_FLOAT ? __float_as_int(key_float(key)) : key;
    }
  }
}

template <typename T>
int launch_sum(const T* vals, const int* ids, const int* block_ptr, T* out,
               int n_blocks, int block_size, int num_segments, int d,
               int threads, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_size) * d * sizeof(T);
  seg_sum_kernel<T><<<n_blocks, threads, smem, stream>>>(
      vals, ids, block_ptr, out, block_size, num_segments, d);
  return static_cast<int>(cudaGetLastError());
}

template <bool IS_FLOAT>
int launch_minmax(const int* vals, const int* ids, const int* block_ptr,
                  int* out, int n_blocks, int block_size, int num_segments,
                  int d, int is_min, int ident_key, int threads,
                  cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(block_size) * d * sizeof(int);
  if (is_min) {
    seg_minmax_kernel<IS_FLOAT, true><<<n_blocks, threads, smem, stream>>>(
        vals, ids, block_ptr, out, block_size, num_segments, d, ident_key);
  } else {
    seg_minmax_kernel<IS_FLOAT, false><<<n_blocks, threads, smem, stream>>>(
        vals, ids, block_ptr, out, block_size, num_segments, d, ident_key);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int seg_sum_f32(const float* vals, const int* ids, const int* block_ptr,
                float* out, int n_blocks, int block_size, int num_segments,
                int d, int threads, void* stream) {
  return launch_sum<float>(vals, ids, block_ptr, out, n_blocks, block_size,
                           num_segments, d, threads,
                           static_cast<cudaStream_t>(stream));
}

int seg_sum_i32(const int* vals, const int* ids, const int* block_ptr,
                int* out, int n_blocks, int block_size, int num_segments,
                int d, int threads, void* stream) {
  return launch_sum<int>(vals, ids, block_ptr, out, n_blocks, block_size,
                         num_segments, d, threads,
                         static_cast<cudaStream_t>(stream));
}

int seg_minmax_f32(const float* vals, const int* ids, const int* block_ptr,
                   float* out, int n_blocks, int block_size,
                   int num_segments, int d, int is_min, int threads,
                   void* stream) {
  // float_key(+inf) = 0x7f800000; float_key(-inf) = 0xff800000 ^ 0x7fffffff
  const int ident_key = is_min ? 0x7f800000 : static_cast<int>(0x807fffffu);
  return launch_minmax<true>(reinterpret_cast<const int*>(vals), ids,
                             block_ptr, reinterpret_cast<int*>(out), n_blocks,
                             block_size, num_segments, d, is_min, ident_key,
                             threads, static_cast<cudaStream_t>(stream));
}

int seg_minmax_i32(const int* vals, const int* ids, const int* block_ptr,
                   int* out, int n_blocks, int block_size, int num_segments,
                   int d, int is_min, int threads, void* stream) {
  const int ident_key = is_min ? 0x7fffffff : static_cast<int>(0x80000000u);
  return launch_minmax<false>(vals, ids, block_ptr, out, n_blocks, block_size,
                              num_segments, d, is_min, ident_key, threads,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
