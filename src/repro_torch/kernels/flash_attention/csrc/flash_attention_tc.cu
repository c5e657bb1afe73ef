// Forward GQA flash attention for Hopper (sm_90a) on the tensor cores: bf16
// in and out, float32 scores, softmax statistics and accumulators.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_bh, _flash_kernel) for bf16 inputs of head dim 64 or 128:
// q (BH, g, Sq, D), k/v (BH, Sk, D) -> o (BH, g, Sq, D), causal or not, with
// the q_offset / sk_valid masks.  Other types and head dims take the CUDA-core
// kernel (flash_attention.cu); the wrapper (flash_attention.py::route)
// chooses.  The semantics are the TPU kernel's: KV is visited from key 0 up
// to the end of the caller's last visible KV tile (causal: the tiles with
// k_first <= q_first + bq - 1), m starts at -1e30, masked scores are -1e30
// (not -inf), l is clamped at 1e-30, so a row whose first keys are all
// masked behaves as on the TPU.  Keys at or past the visited range (the
// zero rows that TMA fills past Sk included) are excluded outright (p = 0).
// The one rounding the CUDA-core kernel does not make: P is rounded to bf16
// before P.V, as every tensor-core attention does (l sums the float32 P).
//
// What bounds it on this card: 4*g*D operations a visible query-key pair
// against q, k, v and o moved once; at the serving shapes that is the bf16
// tensor-core rate (989 TFLOP/s), not HBM.
//
// Design (FlashAttention-3's shape).  One block per (128 query rows of one
// caller Q tile's g*bq rows, bh), the heaviest causal Q tiles launched
// first.  Three warpgroups:
//  - the producer: one thread keeps a ring of kStages K/V tiles (128 keys x
//    D, bf16) in flight with TMA (cp.async.bulk.tensor, a 3-D map (D, Sk,
//    BH), so a tile past Sk reads zeros, never the next head), each tile as
//    64-column boxes in the 128-byte swizzle wgmma reads, and mbarriers:
//    full_k / full_v (the bytes have landed), empty_k / empty_v (every
//    consumer warp is done with them);
//  - two consumers of 64 query rows each (wgmma's M): Q is loaded once with
//    16-byte loads into the same swizzled layout; a KV tile is S = Q.K^T
//    (wgmma m64n128k16, both operands from shared memory, D/16 steps), the
//    online softmax on the accumulator fragment in registers (a row's 32
//    values a thread, max and sum over the 4 threads sharing the row, exp2
//    of scores scaled by log2(e)/sqrt(D)), P rounded to bf16 in registers
//    and fed to O += P.V as wgmma's register A operand (V read from shared
//    memory as [key][d], the MN-major B operand: the transpose bit), O (64
//    x D float32) in registers.
// What keeps the tensor cores busy: each consumer issues tile j's S with
// tile j - 1's P.V and runs tile j's softmax while that P.V runs (a software
// pipeline), and the two consumers issue their products in turns (named
// barriers), so one's softmax overlaps the other's products.  ptxas
// serialises wgmma when a branch sits between a product's issue and its
// wait, so the masked tiles (the diagonal, sk_valid, the visited range's
// end: always the last ones) have a loop of their own, and both K and V are
// waited for before a tile's products are issued.  S, P and O (160
// registers at D 128) fit because the producer gives its registers to the
// consumers (setmaxnreg).  Shared memory at D 128: Q 32 KB and two stages
// of K and V, 160 KB; one block an SM.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 128;             // query rows a block
constexpr int kKeys = 128;             // keys a KV tile
constexpr int kStages = 2;             // KV tiles in flight
constexpr int kConsumers = 256;        // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// registers a thread: the launch gives each of the 384 threads 168; the
// producer warpgroup gives back all but 24 and the consumers take 240
// (2 x 128 x 240 + 128 x 24 = 384 x 168)
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kBoxCols = 64;           // bf16 columns of a 128-byte row
// a wait that outlasts this many clock cycles (~10 s) is a fault: trap
// rather than hang the card
constexpr long long kWatchdogCycles = 1ll << 34;

struct TcArgs {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  int bh, g, sq, sk, bq, bk, causal, q_offset, sk_valid;
  int n_groups, n_qtiles;  // row groups of 128 a Q tile, Q tiles
  float scale_log2;        // log2(e) / sqrt(D)
};

// shared memory of one block, in bytes from a 1024-byte aligned base (the
// 128-byte swizzle repeats every 1024 bytes, and TMA and wgmma agree on it
// only from such a base)
template <int D>
struct Smem {
  static constexpr int kTile = kKeys * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kRows * D * 2;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + 4 * kStages * 8;  // 4 barriers a stage
  static constexpr int kAlloc = kBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the completion of the barrier's phase of parity ``parity``
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWatchdogCycles) __trap();
  }
}

// one box of a 3-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// the compiler must not move reads or writes of an accumulator across the
// asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma's shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (bytes, multiples of 16)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x by the special-function unit alone (relative error ~2^-22, results
// below 2^-126 flushed to 0): exp2f's extra scaling for denormal results
// costs three instructions an exponent in the softmax, whose probabilities
// are rounded to bf16 next anyway
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 128, float32) += A (64 x 16) * B (16 x 128), A and B from shared memory
// (both K-major); d is overwritten where scale_d is 0
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, float32) += A (64 x 16, bf16 in registers) * B (16 x 128), B
// from shared memory, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float32) += A (64 x 16, bf16 in registers) * B (16 x 64), B
// from shared memory, MN-major (the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// row r's 16-byte chunk c of a tile of 128-byte rows (a Q tile's rows, a
// K/V tile's keys) split into 64-column boxes of ``rows`` rows: the
// 128-byte swizzle puts chunk c of a row at chunk c ^ (row % 8)
__device__ __forceinline__ uint32_t swizzled(uint32_t tile, int rows, int r,
                                             int c) {
  return tile + (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r & 7)) << 4);
}

// issue S (64 x kKeys) = Q rows (64 x D, at q_rows) . K tile^T, both
// operands K-major in shared memory: D/16 steps of 16 columns, 32 bytes
// into a 128-byte row, the next 64 columns a box further
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[kKeys / 2],
                                             uint32_t q_rows,
                                             uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = smem_desc(q_rows + (kk / 4) * kRows * 128 + col, 16,
                                  1024);
    const uint64_t db = smem_desc(k_tile + (kk / 4) * kKeys * 128 + col, 16,
                                  1024);
    wgmma_ss(s, da, db, kk > 0);  // m64n{kKeys}k16
  }
  wgmma_commit();
}

// issue O (64 x D) += P (64 x kKeys, bf16 A fragments) . V tile: V is
// [key][d] in shared memory, MN-major for wgmma (8-key groups 1024 bytes
// apart, the next 64 columns a box further); 16 keys a step
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[kKeys / 16][4],
                                         uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    const uint64_t db = smem_desc(v_tile + kk * 16 * 128, kKeys * 128, 1024);
    wgmma_rs(o, p[kk], db);  // m64n{D}k16
  }
  wgmma_commit();
}

// lane 0 of each warp arrives on ``bar``; predicated, not branched, since
// no branch may sit between a wgmma and its wait
__device__ __forceinline__ void warp_arrive(uint32_t bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lane)
      : "memory");
}

// the two consumer warpgroups issue their products in turns (named
// barriers 3 and 4, one each), so that one's softmax runs while the
// other's products hold the tensor cores
__device__ __forceinline__ void turn_wait(int wg) { named_sync(3 + wg, 256); }
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;" ::"r"(3 + (1 - wg)), "r"(256)
               : "memory");
}

// one warpgroup's online softmax over one tile of its scores, in the
// accumulator fragment: value i of a thread sits at row r_lo + 8 *
// ((i >> 1) & 1) and key k0 + 8 * (i / 4) + col + (i & 1)
struct Softmax {
  static constexpr int kVals = kKeys / 2;  // a thread's scores of a tile
  int col, qpos[2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // scale s by log2(e)/sqrt(D), mask it (kMasked: keys past the visited
  // range to -inf, masked keys to -1e30) and turn it into exp2(s - m) with
  // m the new running max; corr gets the factor by which the rows'
  // earlier sums shrink
  template <bool kMasked>
  __device__ __forceinline__ void step(float (&s)[kVals], const TcArgs& a,
                                       int k0, int n_keys,
                                       float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < kVals; ++i) {
      s[i] *= a.scale_log2;
      if constexpr (kMasked) {
        const int key = k0 + 8 * (i / 4) + col + (i & 1);
        const bool masked = key >= a.sk_valid ||
                            (a.causal && key > qpos[(i >> 1) & 1]);
        // not visited: no part even of a fully masked row
        s[i] = key >= n_keys ? -INFINITY : masked ? kNegInf : s[i];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[4 * n + 2 * h], s[4 * n + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[h] = exp2_approx(m[h] - mx);
      m[h] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        s[4 * n + 2 * h] = exp2_approx(s[4 * n + 2 * h] - mx);
        s[4 * n + 2 * h + 1] = exp2_approx(s[4 * n + 2 * h + 1] - mx);
        sum += s[4 * n + 2 * h] + s[4 * n + 2 * h + 1];
      }
      l[h] = l[h] * corr[h] + sum;  // the thread's share of the row sum
    }
  }
};

// P in bf16 as wgmma's A fragments: step kk takes key chunks 2kk and
// 2kk + 1, rows r_lo and r_lo + 8
__device__ __forceinline__ void pack_p(const float (&s)[kKeys / 2],
                                       uint32_t (&p)[kKeys / 16][4]) {
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      p[n / 2][2 * (n % 2) + h] = pack_bf16(s[4 * n + 2 * h],
                                            s[4 * n + 2 * h + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&c)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= c[(i >> 1) & 1];
}

// global row of the block's row r (0..127): row0 + r = gi * bq + qi of the
// caller's Q tile qt
__device__ __forceinline__ size_t q_row(const TcArgs& a, int bh, int qt,
                                        int row0, int r) {
  const int gr = row0 + r, gi = gr / a.bq;
  return (static_cast<size_t>(bh) * a.g + gi) * a.sq +
         static_cast<size_t>(qt) * a.bq + (gr - gi * a.bq);
}

// the 64 rows of warpgroup wg into the swizzled Q tile (zeros past nrows)
template <int D>
__device__ __forceinline__ void load_q(const TcArgs& a, uint32_t q_s, int bh,
                                       int qt, int row0, int nrows, int wg,
                                       int t) {
  for (int idx = t; idx < 64 * (D / 8); idx += 128) {
    const int r = wg * 64 + idx / (D / 8), c = idx % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nrows)
      val = *reinterpret_cast<const uint4*>(
          a.q + q_row(a, bh, qt, row0, r) * D + c * 8);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                     swizzled(q_s, kRows, r, c)),
                 "r"(val.x), "r"(val.y), "r"(val.z), "r"(val.w)
                 : "memory");
  }
  // the generic-proxy stores, visible to wgmma's reads (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// O / l of the thread's two rows (l: the thread's share of each row sum)
// in bf16, rows past nrows skipped
template <int D>
__device__ __forceinline__ void store_rows(const TcArgs& a, const float (&o)[D / 2],
                                           const float (&l_share)[2], int bh,
                                           int qt, int row0, int nrows,
                                           int r_lo, int col) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_share[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = r_lo + 8 * h;
    if (r >= nrows) continue;
    const float lc = fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = a.o + q_row(a, bh, qt, row0, r) * D + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(
          o[4 * n + 2 * h] / lc, o[4 * n + 2 * h + 1] / lc);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const TcArgs a) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  // full_k[s], full_v[s] (the tile's bytes have landed), empty_k[s],
  // empty_v[s] (every consumer warp is done with them): 8 bytes each
  const uint32_t full_k = base + L::kBars, full_v = full_k + 8 * kStages,
                 empty_k = full_v + 8 * kStages,
                 empty_v = empty_k + 8 * kStages;

  // the block: heaviest Q tiles first, every head's before the next tile's
  int id = blockIdx.x;
  const int bh = id % a.bh;
  id /= a.bh;
  const int row0 = (id % a.n_groups) * kRows;
  const int qt = a.n_qtiles - 1 - id / a.n_groups;
  const int nrows = min(kRows, a.g * a.bq - row0);
  const int q_first = a.q_offset + qt * a.bq;

  // keys visited: the caller's KV tiles, all or (causal) those with
  // k_first <= q_first + bq - 1; walked in tiles of kKeys
  const int nk = a.sk / a.bk;
  int n_tiles = nk;
  if (a.causal) {
    const int last = q_first + a.bq - 1;
    n_tiles = last < 0 ? 0 : min(nk, last / a.bk + 1);
  }
  const int n_keys = n_tiles * a.bk;
  const int n_kv = (n_keys + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, kConsumers / 32);
      mbar_init(empty_v + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers) {
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % kStages;
        const uint32_t free = ((j / kStages) & 1) ^ 1;  // round 0 passes
        mbar_wait(empty_k + 8 * s, free);
        mbar_expect_tx(full_k + 8 * s, L::kTile);
#pragma unroll
        for (int h = 0; h < D / kBoxCols; ++h)
          tma_load_3d(k_s + s * L::kTile + h * kKeys * 128, &tm_k,
                      full_k + 8 * s, h * kBoxCols, j * kKeys, bh);
        mbar_wait(empty_v + 8 * s, free);
        mbar_expect_tx(full_v + 8 * s, L::kTile);
#pragma unroll
        for (int h = 0; h < D / kBoxCols; ++h)
          tma_load_3d(v_s + s * L::kTile + h * kKeys * 128, &tm_v,
                      full_v + 8 * s, h * kBoxCols, j * kKeys, bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r_lo = wg * 64 + (t / 32) * 16 + lane / 4;
  Softmax sm;
  sm.col = (lane % 4) * 2;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  if (n_kv == 0) {  // no key visible (causal, q_offset < 0): zeros
    store_rows<D>(a, o, sm.l, bh, qt, row0, nrows, r_lo, sm.col);
    return;
  }
  load_q<D>(a, q_s, bh, qt, row0, nrows, wg, t);
  named_sync(1 + wg, 128);

#pragma unroll
  for (int h = 0; h < 2; ++h)
    sm.qpos[h] = q_first + (row0 + r_lo + 8 * h) % a.bq;
  // tiles from j_mask on need masks: they reach past the visited keys,
  // sk_valid, or (causal) the block's smallest query position; each of the
  // three only grows with the tile, so the unmasked tiles come first
  const bool wraps = row0 / a.bq != (row0 + nrows - 1) / a.bq;
  const int q_min = q_first + (wraps ? 0 : row0 % a.bq);
  int j_mask = n_kv;
  while (j_mask > 0) {
    const int k_end = j_mask * kKeys;  // one past the tile before
    if (k_end > n_keys || k_end > a.sk_valid ||
        (a.causal && k_end - 1 > q_min))
      --j_mask;
    else
      break;
  }

  float s[kKeys / 2], corr[2];
  uint32_t p[kKeys / 16][4];
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
  const uint32_t q_rows = q_s + wg * 64 * 128;
  auto k_tile = [&](int j) { return k_s + (j % kStages) * L::kTile; };
  auto v_tile = [&](int j) { return v_s + (j % kStages) * L::kTile; };
  auto parity = [](int j) { return static_cast<uint32_t>(j / kStages) & 1; };

  // tile 0 alone: its scores, its softmax, its P
  if (wg == 1) turn_pass(wg);  // the first turn is warpgroup 0's
  mbar_wait(full_k, 0);
  turn_wait(wg);
  issue_scores<D>(s, q_rows, k_tile(0));
  turn_pass(wg);
  wgmma_wait<0>();
  fence_regs(s);
  warp_arrive(empty_k, lane);
  if (j_mask == 0)
    sm.step<true>(s, a, 0, n_keys, corr);
  else
    sm.step<false>(s, a, 0, n_keys, corr);
  pack_p(s, p);

  // then a software pipeline: tile j's scores are issued with tile j - 1's
  // P.V, and tile j's softmax runs while that P.V is on the tensor cores.
  // Nothing branches between a product's issue and its wait: both K and V
  // are waited for before the issue, and the masked tiles have a loop of
  // their own
  auto tile = [&](int j, auto masked) {
    mbar_wait(full_k + 8 * (j % kStages), parity(j));
    mbar_wait(full_v + 8 * ((j - 1) % kStages), parity(j - 1));
    turn_wait(wg);
    issue_scores<D>(s, q_rows, k_tile(j));
    rescale(o, corr);
    issue_pv<D>(o, p, v_tile(j - 1));
    turn_pass(wg);
    wgmma_wait<1>();  // the scores; P.V goes on
    fence_regs(s);
    warp_arrive(empty_k + 8 * (j % kStages), lane);
    sm.step<decltype(masked)::value>(s, a, j * kKeys, n_keys, corr);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    warp_arrive(empty_v + 8 * ((j - 1) % kStages), lane);
    pack_p(s, p);
  };
  for (int j = 1; j < j_mask; ++j) tile(j, std::false_type{});
  for (int j = max(j_mask, 1); j < n_kv; ++j) tile(j, std::true_type{});

  // the last tile's P.V
  mbar_wait(full_v + 8 * ((n_kv - 1) % kStages), parity(n_kv - 1));
  rescale(o, corr);
  issue_pv<D>(o, p, v_tile(n_kv - 1));
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(p);
  if (wg == 0) turn_wait(wg);  // warpgroup 1's last pass
  store_rows<D>(a, o, sm.l, bh, qt, row0, nrows, r_lo, sm.col);
}


using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// the driver's tensor-map encoder, through the runtime (no -lcuda)
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// a K or V tensor (BH, Sk, D) as a 3-D map (D, Sk, BH) of 64 x 128 x 1
// boxes, 128-byte swizzle; rows past Sk read as zeros
CUresult kv_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int d,
                int sk, int bh) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(sk),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(sk) * d * 2};
  const cuuint32_t box[3] = {kBoxCols, kKeys, 1};
  const cuuint32_t elems[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elems,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// an encoder failure is reported as kEncodeError + its CUresult
constexpr int kEncodeError = 100000;

template <int D>
int launch(const TcArgs& a, const void* k, const void* v, cudaStream_t stream) {
  EncodeTiled encode;
  cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_k, tm_v;
  CUresult res = kv_map(encode, &tm_k, k, D, a.sk, a.bh);
  if (res == CUDA_SUCCESS) res = kv_map(encode, &tm_v, v, D, a.sk, a.bh);
  if (res != CUDA_SUCCESS) return kEncodeError + static_cast<int>(res);
  err = cudaFuncSetAttribute(flash_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<D>::kAlloc);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(a.bh) * a.n_groups * a.n_qtiles;
  flash_tc_kernel<D><<<blocks, kThreads, Smem<D>::kAlloc, stream>>>(tm_k, tm_v,
                                                                     a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q (BH, g, Sq, D), k/v (BH, Sk, D), o like q; D 64 or 128.  The
// caller checks shapes (Sq % bq == 0, Sk % bk == 0, 16-byte aligned
// contiguous tensors, BH * groups * Q tiles < 2^31); returns a cudaError_t,
// or kEncodeError + the CUresult of a tensor map the driver refused.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, int bh, int g, int sq, int sk, int d,
                              int bq, int bk, int causal, int q_offset,
                              int sk_valid, float scale, void* stream) {
  TcArgs a{static_cast<const __nv_bfloat16*>(q),
           static_cast<__nv_bfloat16*>(o),
           bh, g, sq, sk, bq, bk, causal, q_offset, sk_valid,
           (g * bq + kRows - 1) / kRows, sq / bq, scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return launch<128>(a, k, v, s);
  if (d == 64) return launch<64>(a, k, v, s);
  return cudaErrorInvalidValue;
}

// dynamic shared memory of one block, in bytes
int flash_attention_tc_smem_bytes(int d) {
  return d == 128 ? Smem<128>::kAlloc : d == 64 ? Smem<64>::kAlloc : 0;
}

const char* flash_attention_tc_error_string(int err) {
  if (err >= kEncodeError) return "cuTensorMapEncodeTiled refused a K/V map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
