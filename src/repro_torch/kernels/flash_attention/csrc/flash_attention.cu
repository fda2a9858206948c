// Flash attention forward (GQA, causal or full) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py:
//   flash_attention_fwd  <- flash_attention (_flash_kernel, line 27)
//
// What it computes.  q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], float32 or
// bfloat16, contiguous; q head h reads kv head h / (Hq / Hkv).  For every
// query row, softmax(q . k^T * scale) . v with scale = 1 / sqrt(D), the
// scores in float32, and with the TPU kernel's rules:
//   - a causal mask aligned to the end (row i sees keys <= i + Sk - Sq),
//     whose masked scores are -1e30, not -inf: a row that sees no key
//     averages V uniformly, as on the TPU;
//   - p is rounded to V's type before the P.V product, which accumulates
//     in float32; the output is acc / max(l, 1e-30) in q's type.
// Unlike the TPU kernel, the ragged edge is masked: key columns >= Sk
// count for nothing (p = 0) and query rows >= Sq are not written.
//
// Two kernels, chosen by the inputs' type.  bfloat16 inputs go to the
// tensor-core kernel of flash_attention_sm90.cuh (wgmma for both
// products, TMA loads into a ring of K/V stages, warp-specialised); its
// header gives its design.  float32 inputs go to the kernel below, on the
// CUDA cores: Hopper's tensor cores take float32 only as TF32, which
// would change the numbers.
//
// Design of the float32 kernel.  One CTA of 256 threads per (q tile of
// 64 rows, q head, batch).  The Q tile stays in shared memory.  The CTA
// walks the k tiles of 64 keys in order; each is staged in shared
// memory, first as K for the scores and then, in the same buffer, as V.
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows 4 ty .. 4 ty + 3 of
// the tile: the score columns tx + 16 j (j < 4) and the output columns
// tx + 16 j (j < D / 16).  The online softmax keeps m, l and the
// accumulator in registers; a row's max and sum are reduced over the 16
// threads of a half-warp with shuffles.  The probabilities go through
// shared memory to the P.V product.  A causal tile whose first row sees
// key 0 stops at its last visible key tile: every later tile is fully
// masked and adds exactly nothing (p = exp(-1e30 - m) = 0 with m
// finite).  Tiles of a q tile whose first row sees no key are all
// visited, as on the TPU.
//
// What bounds it.  At the sequence lengths of a language model,
// operations: 4 B Hq Sq Sk D, half that for causal attention at Sq = Sk,
// against reading q, k, v and writing the output once; for this kernel,
// the float32 rate of the CUDA cores and the shared-memory loads that
// feed them (one per two to three FMAs).
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns the first CUDA error (or cudaErrorInvalidValue for a head size
// it was not compiled for, or for a tensor map the driver refuses).

#include <cuda_runtime.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per k tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kLP = kBK + 1;     // padded row stride of the P tile
constexpr float kMasked = -1e30f;
static_assert(kBQ == kBK, "load_tile stages kBQ rows for Q, K and V alike");

// Copy rows [r0, r0 + 64) of a [rows, D] matrix into a float32 tile of
// row stride D + 1, with zeros past the last row.
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          int r0, int rows) {
  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    const int c = i % D;
    tile[r * (D + 1) + c] =
        r0 + r < rows ? src[static_cast<long long>(r0 + r) * D + c] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int hq, int hkv, int sq, int sk, bool causal,
                     float scale) {
  constexpr int LD = D + 1;  // padded row stride of the Q and K/V tiles
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][LD]
  float* kv = qs + kBQ * LD;    // [kBK][LD]: the K tile, then the V tile
  float* ps = kv + kBK * LD;    // [kBQ][kLP]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int seq_off = sk - sq;
  const long long q_base = (static_cast<long long>(b) * hq + h) * sq * D;
  const long long kv_base = (static_cast<long long>(b) * hkv + hk) * sk * D;
  const float neg_inf = -__int_as_float(0x7f800000);

  load_tile<D>(qs, q + q_base, q0, sq);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  int n_k = (sk + kBK - 1) / kBK;
  if (causal && q0 + seq_off >= 0) {
    n_k = min(n_k, (q0 + kBQ - 1 + seq_off) / kBK + 1);
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous V tile (and, at kt = 0, Q) is done
    load_tile<D>(kv, k + kv_base, k0, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = kv[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = neg_inf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= sk) {
          x = neg_inf;  // past the last key: p = 0
        } else if (causal && col > row + seq_off) {
          x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty * 4 + i) * kLP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }

    __syncthreads();  // every thread is done with the K tile
    load_tile<D>(kv, v + kv_base, k0, sk);
    __syncthreads();  // the V tile and the P tile are in place

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kLP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float x = kv[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      o[q_base + static_cast<long long>(row) * D + tx + 16 * j] =
          acc[i][j] / denom;
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  return static_cast<int>(((kBQ + kBK) * (D + 1) + kBQ * kLP) *
                          sizeof(float));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int causal, float scale,
           cudaStream_t stream) {
  const int smem = smem_bytes<D>();
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, sk,
      causal != 0, scale);
  return static_cast<int>(cudaGetLastError());
}

// The launch for head size D: the tensor-core kernel for bf16, the
// float32 kernel above otherwise.
template <int D>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int b, int hq, int hkv, int sq, int sk, int causal,
                 int is_bf16, float scale, cudaStream_t stream) {
  if (is_bf16) {
    return sm90::launch<D>(q, k, v, o, b, hq, hkv, sq, sk, causal, scale,
                           stream);
  }
  return launch<D>(q, k, v, o, b, hq, hkv, sq, sk, causal, scale, stream);
}

// The kernel of head size D and type: its registers per thread at launch
// and its shared memory per CTA.
template <int D>
int info_typed(int is_bf16, int* regs, int* smem) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      is_bf16 ? cudaFuncGetAttributes(&attr, sm90::flash_fwd_sm90<D>)
              : cudaFuncGetAttributes(&attr, flash_fwd_kernel<D>);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes) +
          (is_bf16 ? sm90::Tile<D>::kSmem : smem_bytes<D>());
  return 0;
}

}  // namespace

extern "C" {

int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int b, int hq, int hkv, int sq, int sk, int d,
                        int causal, int is_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch_typed<16>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                              is_bf16, scale, s);
    case 32:
      return launch_typed<32>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                              is_bf16, scale, s);
    case 64:
      return launch_typed<64>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                              is_bf16, scale, s);
    case 128:
      return launch_typed<128>(q, k, v, o, b, hq, hkv, sq, sk, causal,
                               is_bf16, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_kernel_info(int d, int is_bf16, int* regs, int* smem) {
  switch (d) {
    case 16:
      return info_typed<16>(is_bf16, regs, smem);
    case 32:
      return info_typed<32>(is_bf16, regs, smem);
    case 64:
      return info_typed<64>(is_bf16, regs, smem);
    case 128:
      return info_typed<128>(is_bf16, regs, smem);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
