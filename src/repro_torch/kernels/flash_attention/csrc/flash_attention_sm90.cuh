// Flash attention forward in bf16 for Hopper (sm_90a): both products on
// the tensor cores through wgmma, Q, K and V tiles brought by TMA.
// Included by flash_attention.cu, whose entry point flash_attention_fwd
// launches it for bf16 inputs (f32 inputs keep the CUDA-core kernel
// there).  It computes what that file's header states, with the same
// rules: the end-aligned causal mask and its optional sliding window,
// masked scores of -1e30 (a row that sees no key averages V), key
// columns >= Sk with p = 0, rows >= Sq not written, p rounded to bf16
// before P.V, f32 sums, and the output acc / max(l, 1e-30) rounded to
// bf16.
//
// Design.  One CTA of 384 threads per (128 query rows, q head, batch),
// the q tiles with the most k tiles first.  Warpgroups 0 and 1 consume,
// 64 rows each; one thread of warpgroup 2 is the producer: it loads the
// Q tile once and then K and V tiles of 128 keys into a ring of kStages
// stages in shared memory, each by TMA (cp.async.bulk.tensor) onto an
// mbarrier that completes with the byte count ("full"); the consumers
// arrive on the stage's "empty" barrier when they are done with it.
// setmaxnreg leaves the producer 40 registers and gives each consumer
// 232.  A consumer computes S = Q.K^T (m64n128k16, A and B from shared
// memory, both K-major), the online softmax in registers (a row lives in
// 4 threads of the accumulator layout: two shuffles reduce it; the mask
// is applied only on the tiles that cross the diagonal, the lower edge of
// the window or the ragged end), rescales its output accumulator,
// converts P to bf16 in place as the A operand from registers, and adds
// P.V (m64nDk16, B = V from shared memory, MN-major, so with the
// transpose bit).
//
// Tiles visited.  Under the causal mask a CTA stops at the last tile its
// last row sees and, under a window, starts at the first tile its first
// row sees (the tiles before it are masked for every row of the CTA; see
// flash_attention.cu).  The ring counts from that first tile: visit i
// (tile kt0 + i) uses stage i % kStages at parity (i / kStages) & 1, in
// the producer and the consumers alike.
//
// Overlap.  A consumer issues S of tile t + 1 and P.V of tile t together
// and runs the softmax of tile t + 1 while P.V is on the tensor cores.
// The two consumers take turns to issue (two named barriers), so that
// one's softmax runs beside the other's products.  The output is
// normalised in registers, written in bf16 over the warpgroup's rows of
// the Q tile and stored by TMA, which clips it at Sq.
//
// Shared memory.  Each tile is 128 rows of D bf16 values, stored by TMA
// with the widest swizzle its rows allow (128 bytes for D >= 64, else
// 2 D bytes) in column blocks of one swizzle width (two for D = 128);
// the wgmma descriptors name the same swizzle.  For D = 128: Q 32 KB,
// three stages of K and V 192 KB, of the 227 KB a CTA may have.
//
// TMA descriptors are rank 3, [B * H, S, D], built on the host in each
// call: rows past S of a head are zero-filled on load, never read from
// the next head (a zero V row adds exactly 0; a row of another head
// could hold inf and make 0 * inf = NaN).  cuTensorMapEncodeTiled comes
// from the driver through cudaGetDriverEntryPoint, so nothing links
// -lcuda.
//
// What bounds it: operations, 4 B Hq Sq Sk D for full attention (about
// half of it under the causal mask at Sq = Sk), on the bf16 tensor cores.
// Beside them each score takes an exp2 on the special-function units (a
// quarter of the tensor cores' rate per score at D = 128) and about five
// float32 instructions; what is not overlapped of these, and each CTA's
// start (Q and the first K tile) and end (the last P.V, the store), keep
// it from the tensor-core bound (PERF.md gives its share).

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kRows = 128;       // query rows per CTA
constexpr int kKeys = 128;       // keys per k tile
constexpr int kStages = 3;       // K/V tiles in flight
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = 384;    // and the producer's warpgroup
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kRows == kKeys, "one tile shape for Q, K and V");

// The shared-memory tiles of head size D.
template <int D>
struct Tile {
  static constexpr int kSwizzle = D >= 64 ? 128 : 2 * D;  // bytes
  static constexpr int kBox = kSwizzle / 2;  // columns per TMA box
  static constexpr int kBlocks = D / kBox;   // column blocks of a tile
  static constexpr int kBlockBytes = kRows * kSwizzle;
  static constexpr int kBytes = kRows * D * 2;
  // wgmma's swizzle code: 1 = 128 bytes, 2 = 64, 3 = 32
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1
                                      : kSwizzle == 64 ? 2 : 3;
  // K steps of 16 values per column block
  static constexpr int kStepsPerBlock = kSwizzle / 32;
  // Q, the K and V stages, the barriers, and room to align to 1024
  static constexpr int kSmem = (1 + 2 * kStages) * kBytes + 128 + 1024;
  static_assert(kBytes % 1024 == 0, "tiles start on a swizzle atom");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (in 16-byte units), swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// K-major (Q and K): rows of one swizzle width, 8-row groups 8 rows
// apart; the leading offset is not used with a swizzle.
template <int D>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  using T = Tile<D>;
  return make_desc(addr, 16, 8 * T::kSwizzle, T::kLayout);
}

// MN-major (V in P.V): the leading offset steps over the column blocks
// (N), the stride offset over 8 key rows (K).
template <int D>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  using T = Tile<D>;
  return make_desc(addr, T::kBlockBytes, 8 * T::kSwizzle, T::kLayout);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a rank-3 map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// One TMA box from shared memory to a rank-3 map (rows past the map's
// end are not written), in the thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving a register that an asynchronous wgmma
// reads or writes across the wait for it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two wgmma shapes, bf16 inputs and f32 accumulators.  The
// accumulator of a 64 x N product lives in d[0 .. N/2) of the 128 threads
// of a warpgroup: thread t of warp w holds rows 16 w + t / 4 (d[4 j],
// d[4 j + 1]) and 16 w + t / 4 + 8 (d[4 j + 2], d[4 j + 3]) at columns
// 8 j + 2 (t % 4) + {0, 1}.

// d[0..64) (+)= A . B for m64n128k16; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[0..8) += A . B for m64n16k16; A in registers (four bf16x2 per
// thread), B MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[8], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..16) += A . B for m64n32k16; A in registers (four bf16x2 per
// thread), B MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[16], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..32) += A . B for m64n64k16; A in registers (four bf16x2 per
// thread), B MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..64) += A . B for m64n128k16; A in registers (four bf16x2 per
// thread), B MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Issue S = Q . K^T for this warpgroup's 64 rows and a K tile, over D in
// steps of 16 values (asynchronous: wait for it with wgmma_wait).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_wg,
                                         uint32_t k_tile) {
  using T = Tile<D>;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / T::kStepsPerBlock) * T::kBlockBytes +
                         (kk % T::kStepsPerBlock) * 32;
    wgmma_qk(sc, desc_k_major<D>(q_wg + off), desc_k_major<D>(k_tile + off),
             kk > 0);
  }
  wgmma_commit();
}

// Issue O += P . V over a V tile's 128 keys in steps of 16 (asynchronous).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pa)[32],
                                         uint32_t v_tile) {
  using T = Tile<D>;
  fence_regs(acc);
  fence_regs(pa);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    wgmma_pv(acc, &pa[4 * kk],
             desc_mn_major<D>(v_tile + kk * 16 * T::kSwizzle));
  }
  wgmma_commit();
}

// The online softmax of one tile of scores, in place: sc becomes p
// (scores in log2 units, exp2), m the new running max of rows 0 and 1 of
// this thread, l its share of the running sum; returns in alpha the
// factor that rescales the output accumulator.  `edge` tiles mask keys
// past the last (p = 0) and, under the causal mask, past a row's
// diagonal or, with a window, at or below row + seq_off - window (-1e30);
// the others fold the scale into the exponent's FMA.
// Maxima and sums go through four partials a row, so that the chains of
// dependent instructions are short (two warpgroups leave an SM little
// else to switch to).
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int k0, int c_lane,
                                             const int (&rows)[2], int sk,
                                             int seq_off, int causal,
                                             int window, float scale_log2) {
  const float neg_inf = -__int_as_float(0x7f800000);
  float part[2][4];
  if (edge) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + c_lane + e;
          float x = sc[4 * j + 2 * i + e] * scale_log2;
          if (col >= sk) {
            x = neg_inf;  // past the last key: p = 0
          } else if (causal &&
                     (col > rows[i] + seq_off ||
                      (window > 0 && col <= rows[i] + seq_off - window))) {
            x = kMasked;
          }
          sc[4 * j + 2 * i + e] = x;
          const int pp = (2 * j + e) % 4;
          part[i][pp] = j < 2 ? x : fmaxf(part[i][pp], x);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = sc[4 * j + 2 * i + e];
          const int pp = (2 * j + e) % 4;
          part[i][pp] = j < 2 ? x : fmaxf(part[i][pp], x);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = fmaxf(fmaxf(part[i][0], part[i][1]),
                     fmaxf(part[i][2], part[i][3]));
    if (!edge) mx *= scale_log2;
    mx = fmaxf(m[i], mx);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[i] = ex2(m[i] - mx);
    m[i] = mx;
  }
  if (edge) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = ex2(sc[i] - m[(i / 2) % 2]);
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = ex2(fmaf(sc[i], scale_log2, -m[(i / 2) % 2]));
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = sc[4 * j + 2 * i + e];
        const int pp = (2 * j + e) % 4;
        part[i][pp] = j < 2 ? x : part[i][pp] + x;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = l[i] * alpha[i] +
           ((part[i][0] + part[i][1]) + (part[i][2] + part[i][3]));
  }
}

// P in bf16 as wgmma's A fragment: for each 16 keys, four registers
// (rows r0 and r0 + 8, columns c and c + 8 of the step).
__device__ __forceinline__ void pack_p(uint32_t (&pa)[32],
                                       const float (&sc)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[4 * kk + r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to, int batch, int hq,
                   int hkv, int sq, int sk, int causal, int window,
                   float scale_log2) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;  // swizzle atoms start here
  const uint32_t k_s = q_s + T::kBytes;        // + stage * T::kBytes
  const uint32_t v_s = k_s + kStages * T::kBytes;
  const uint32_t bars = v_s + kStages * T::kBytes;
  const uint32_t bar_q = bars;
  const uint32_t bar_k = bars + 8;                 // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * kStages;      // + 8 * stage
  const uint32_t bar_empty = bar_v + 8 * kStages;  // + 8 * stage

  // q tiles with the most k tiles first: the q tile is the slowest index
  // of the one-dimensional grid, counted backwards
  const int n_q = (sq + kRows - 1) / kRows;
  const int heads = batch * hq;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x) / heads;
  const int bh = static_cast<int>(blockIdx.x) % heads;  // b * hq + h
  const int bkv = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = qt * kRows;
  const int seq_off = sk - sq;
  int n_k = (sk + kKeys - 1) / kKeys;  // one past the last tile visited
  int kt0 = 0;                         // the first tile visited
  if (causal && q0 + seq_off >= 0) {
    // every row sees a key, and no row sees past this tile
    n_k = min(n_k, (q0 + kRows - 1 + seq_off) / kKeys + 1);
    // nor, under a window, before the first row's first key
    if (window > 0) kt0 = max(0, q0 + seq_off - window + 1) / kKeys;
  }
  const int visits = n_k - kt0;  // >= 1: the first row's diagonal tile

  if (threadIdx.x == kConsumers) {
    // the descriptors' first use need not wait for their fetch
    for (const CUtensorMap* map : {&tq, &tk, &tv, &to}) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(map))
                   : "memory");
    }
  }
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, T::kBytes);
#pragma unroll
      for (int cb = 0; cb < T::kBlocks; ++cb) {
        tma_load(q_s + cb * T::kBlockBytes, &tq, bar_q, cb * T::kBox, q0, bh);
      }
      for (int i = 0; i < visits; ++i) {
        const int s = i % kStages;
        const int kt = kt0 + i;
        mbar_wait(bar_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, T::kBytes);
#pragma unroll
        for (int cb = 0; cb < T::kBlocks; ++cb) {
          tma_load(k_s + s * T::kBytes + cb * T::kBlockBytes, &tk,
                   bar_k + 8 * s, cb * T::kBox, kt * kKeys, bkv);
        }
        mbar_expect_tx(bar_v + 8 * s, T::kBytes);
#pragma unroll
        for (int cb = 0; cb < T::kBlocks; ++cb) {
          tma_load(v_s + s * T::kBytes + cb * T::kBlockBytes, &tv,
                   bar_v + 8 * s, cb * T::kBox, kt * kKeys, bkv);
        }
      }
    }
  } else {
    // a consumer: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile;
    // this thread holds rows r0 and r0 + 8, and in each 8-column block j
    // of a 64 x N accumulator the columns 8 j + 2 (lane % 4) + {0, 1}.
    // S of tile t + 1 and P.V of tile t are issued together, and the
    // softmax of tile t + 1 runs while P.V is on the tensor cores.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
    const int rows[2] = {r0, r0 + 8};
    const int c_lane = 2 * (lane % 4);
    const uint32_t q_wg = q_s + wg * 64 * T::kSwizzle;
    // a tile past the diagonal of some row of the CTA, at or below the
    // lower edge of some row's window, or past the last key
    auto edge = [&](int k0) {
      return k0 + kKeys > sk ||
             (causal && (k0 + kKeys - 1 > q0 + seq_off ||
                         (window > 0 &&
                          k0 <= q0 + kRows - 1 + seq_off - window)));
    };

    float acc[D / 2], sc[64], alpha[2];
    uint32_t pa[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.0f;
    // running max (scores in log2 units) and this thread's share of the sum
    float m[2] = {kMasked, kMasked};
    float l[2] = {0.0f, 0.0f};

    // the two warpgroups take turns to issue their products (named
    // barriers 1 + wg), so that one's softmax runs beside the other's
    // products; warpgroup 1 lets warpgroup 0 go first
    const int turns = visits + 1;
    int turn = 0;
    auto my_turn = [&]() { named_sync(1 + wg, kConsumers); };
    auto end_turn = [&]() {
      // warpgroup 1's last arrive would have no wait to meet
      if (!(wg == 1 && turn == turns - 1)) {
        named_arrive(2 - wg, kConsumers);
      }
      ++turn;
    };
    if (wg == 1) named_arrive(1, kConsumers);

    mbar_wait(bar_q, 0);
    mbar_wait(bar_k, 0);
    my_turn();
    issue_qk<D>(sc, q_wg, k_s);
    end_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m, l, alpha, edge(kt0 * kKeys), kt0 * kKeys, c_lane,
                 rows, sk, seq_off, causal, window, scale_log2);
    pack_p(pa, sc);
    for (int i = 1; i < visits; ++i) {
      const int kt = kt0 + i;
      const int s = i % kStages;
      const int sp = (i - 1) % kStages;  // the stage of P's tile
      mbar_wait(bar_k + 8 * s, (i / kStages) & 1);
      mbar_wait(bar_v + 8 * sp, ((i - 1) / kStages) & 1);
      my_turn();
      issue_qk<D>(sc, q_wg, k_s + s * T::kBytes);
      issue_pv<D>(acc, pa, v_s + sp * T::kBytes);
      end_turn();
      wgmma_wait<1>();  // S is in, P.V may still run
      fence_regs(sc);
      softmax_tile(sc, m, l, alpha, edge(kt * kKeys), kt * kKeys, c_lane,
                   rows, sk, seq_off, causal, window, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(bar_empty + 8 * sp);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[4 * j + 2 * i] *= alpha[i];
          acc[4 * j + 2 * i + 1] *= alpha[i];
        }
      }
      pack_p(pa, sc);
    }
    const int sp = (visits - 1) % kStages;
    mbar_wait(bar_v + 8 * sp, ((visits - 1) / kStages) & 1);
    my_turn();
    issue_pv<D>(acc, pa, v_s + sp * T::kBytes);
    end_turn();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(bar_empty + 8 * sp);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    // The output, in bf16, goes to this warpgroup's rows of the Q tile
    // (its last S = Q.K^T is done), in the layout and swizzle the TMA
    // map of O reads; one thread then stores the 64 rows, which TMA
    // clips at Sq.
    uint8_t* q_gen = smem_raw + (q_s - raw);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float denom = fmaxf(l[i], 1e-30f);
      const int r = rows[i] - q0;  // row of the tile
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + c_lane;
        uint32_t off = r * T::kSwizzle + (col % T::kBox) * 2;
        off ^= ((off >> 7) & (T::kSwizzle / 16 - 1)) << 4;
        *reinterpret_cast<__nv_bfloat162*>(
            q_gen + (col / T::kBox) * T::kBlockBytes + off) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / denom,
                                  acc[4 * j + 2 * i + 1] / denom);
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(3 + wg, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int cb = 0; cb < T::kBlocks; ++cb) {
        tma_store(&to, q_wg + cb * T::kBlockBytes, cb * T::kBox,
                  q0 + wg * 64, bh);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      // the CTA's shared memory must outlive the store's reads
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-3 map over [heads, rows, D] bf16 values, in boxes of box_rows rows of
// one column block.
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base,
              int heads, int rows, int box_rows) {
  using T = Tile<D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::kBox),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kSwizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int sk, int causal, int window,
           float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tq, tk, tv, to;
  if (!make_map<D>(encode, &tq, q, b * hq, sq, kRows) ||
      !make_map<D>(encode, &tk, k, b * hkv, sk, kKeys) ||
      !make_map<D>(encode, &tv, v, b * hkv, sk, kKeys) ||
      !make_map<D>(encode, &to, o, b * hq, sq, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_sm90<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (sq + kRows - 1) / kRows * hq * b;
  kernel<<<grid, kThreads, Tile<D>::kSmem, stream>>>(
      tq, tk, tv, to, b, hq, hkv, sq, sk, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
