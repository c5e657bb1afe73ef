// Mamba2 SSD chunked scan for Hopper (sm_90a) on the tensor cores, bf16.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py (ssd_pallas,
// _ssd_kernel) for bf16 inputs with P, N and Q multiples of 16 (P <= 64,
// N <= 128, Q <= 256); csrc/ssd.cu keeps float32 and every other shape.
// x (B, L, H, P) bf16, dt (B, L, H) float32, a_log and D (H,) float32, B/C
// (B, L, N) bf16 -> y (B, L, H, P) bf16.  For each (b, h), chunk by chunk
// of Q steps, with cum the inclusive running sum of dt·A (A = -exp(a_log)):
//   y_q = Σ_{s<=q} W[q,s] x_s + exp(cum_q) (C_q · h_prev) + D x_q,
//         W[q,s] = (C_q·B_s) exp(cum_q - cum_s) dt_s
//   h   = exp(cum_{Q-1}) h_prev + Σ_s (x_s exp(cum_{Q-1} - cum_s) dt_s) ⊗ B_s
// with h (P x N, float32) carried from chunk to chunk.
//
// What bounds it on this card: bytes (x, B, C, dt read once, y written
// once: 0.127 ms at the scoring layer, B 8, L 4,096, H 48, P 64, N 128),
// with the operations at the bf16 tensor-core rate a little under that
// once C·Bᵀ is shared by the heads.  The CUDA-core kernel does the same
// ~12M multiply-adds a (b, h, chunk) in float32, which can never go under
// ~2.2 ms a layer; here all four products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, float32 accumulate), so the float32 floor
// is gone.  C·Bᵀ is still formed once a head (sharing it is later work).
//
// The three bf16 roundings the tensor cores force are the rounding twin's
// (ref.py::ssd_tc_twin), and nothing else is rounded:
//   1. W, masked (s <= q) and then rounded, as the A operand of W·x;
//   2. h_prev, a bf16 copy in shared memory for C·h_prev; the float32
//      master stays in registers;
//   3. the update's operand x_s·exp(cum_last - cum_s)·dt_s.
//
// Design.
// - Grid (H, B): one block a (b, h), walking its chunks in order with the
//   state carried across them; the heads of one b are adjacent in launch
//   order, so B and C come from L2.  16 warps (4 a scheduler: the products
//   are bound by the latency of their mma chains, and warps are what hides
//   it) and ~193 KB of shared memory, one block an SM: the scoring layer's
//   384 blocks make 3 waves on 132 SMs.  16 warps leave 128 registers a
//   thread (ptxas must not spill).
// - A chunk's C, B and x (Q rows each, padded 16 bytes so that ldmatrix's
//   eight row addresses fall in eight bank groups) and dt are staged whole
//   by cp.async and read from shared memory by every query strip and by
//   the update, never re-staged.  The next chunk's C and dt are fetched
//   while the update runs (C is no longer read then), its B and x while
//   its C·h_prev runs.
// - The chunk's S = Q/16 query strips of 16 rows are split so that every
//   warp has the same number of 16-key tiles (the causal triangle gives
//   strip i i+1 of them): warps 2j and 2j+1 share strips j and S-1-j, warp
//   2j taking all of j and the first tiles of S-1-j, warp 2j+1 the rest;
//   warp 2j's partial sum of S-1-j is handed over through shared memory
//   and a named barrier of the two warps.  For a strip: C's A fragments
//   stay in registers; y = exp(cum_q)·(C·h_prevᵀ), then for each key tile
//   the scores C·Bᵀ (16 x 16, float32), W formed from them in registers
//   (the accumulator layout of two n8 tiles is the A layout of one k16
//   step: FA2's register reuse, no trip through shared memory), and y +=
//   W·x; y + D·x is written as bf16.
// - The update: warp w owns h rows 16(w%4).. and columns 32(w/4)..,
//   float32 in registers (16 a thread).  It reads x with ldmatrix.trans as
//   the A operand (16 p x 16 s), scales it by exp(cum_last - cum_s)·dt_s
//   in registers and rounds it, and multiplies by B (ldmatrix.trans).  At
//   the chunk's end the bf16 copy of h goes to shared memory.
// - exp(cum_q - cum_s) is taken of the difference (ex2.approx of it times
//   log2 e), never as exp(cum_q)·exp(-cum_s): |cum| reaches hundreds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;       // 4 a scheduler
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 256;        // 16 strips of 16 rows
constexpr int kMaxP = 64;         // four 16-row strips of h
constexpr int kMaxN = 128;        // four 32-column quarters of h
constexpr int kLdN = kMaxN + 8;   // bf16 row of B, C and h: 272 bytes
constexpr int kLdP = kMaxP + 8;   // bf16 row of x: 144 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

struct Args {
  const bf16* x;
  const float* dt;
  const float* a_log;
  const float* d;
  const bf16* b;
  const bf16* c;
  bf16* y;
  int L, H, P, N, Q;
  int ldbc;  // elements from one row (token) of B or C to the next
};

// shared memory: C, B (Q x kLdN), x (Q x kLdP), h's bf16 copy (kMaxP x
// kLdN), then float32 dt, cum, exp(cum), the update's weights (kMaxQ
// each) and the scan's warp sums
size_t smem_bytes(int q) {
  return (2 * (size_t)q * kLdN + (size_t)q * kLdP + (size_t)kMaxP * kLdN) *
             sizeof(bf16) +
         (4 * (size_t)kMaxQ + kWarps) * sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a·b, m16n8k16, bf16 in, float32 accumulate.  With g = lane / 4 and
// t = lane % 4: a = {(g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)},
// b = {(k 2t.., n g), (k 2t+8.., n g)}, d = {(g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a named barrier of n threads: bar_arrive hands over (the shared memory
// written before it), bar_sync waits for the hand-over
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t scale2(uint32_t v, float lo, float hi) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const bf162*>(&v));
  return pack(f.x * lo, f.y * hi);
}

__global__ void __launch_bounds__(kThreads, 1) ssd_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = a.P, N = a.N, Q = a.Q, L = a.L, H = a.H;
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // [q][n]
  bf16* bs = cs + (size_t)Q * kLdN;              // [s][n]
  bf16* xs = bs + (size_t)Q * kLdN;              // [s][p]
  bf16* hs = xs + (size_t)Q * kLdP;              // [p][n], h before the chunk
  float* dts = reinterpret_cast<float*>(hs + kMaxP * kLdN);
  float* cums = dts + kMaxQ;
  float* ein = cums + kMaxQ;   // exp(cum_q)
  float* wu = ein + kMaxQ;     // exp(cum_last - cum_s)·dt_s
  float* wsum = wu + kMaxQ;    // the scan's warp totals

  const int h = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float A = -expf(a.a_log[h]);
  const float D = a.d[h];
  const size_t row0 = (size_t)bb * L;  // this b's first token
  const int nq = N / 8, pq = P / 8;    // 16-byte pieces a row

  auto fetch_c_dt = [&](int l0) {
    for (int i = tid; i < Q * nq; i += kThreads) {
      const int r = i / nq, k = i - r * nq;
      cp_async16(cs + r * kLdN + 8 * k, a.c + (row0 + l0 + r) * a.ldbc + 8 * k);
    }
    if (tid < Q) cp_async4(dts + tid, a.dt + (row0 + l0 + tid) * H + h);
    cp_async_commit();
  };
  auto fetch_b_x = [&](int l0) {
    for (int i = tid; i < Q * nq; i += kThreads) {
      const int r = i / nq, k = i - r * nq;
      cp_async16(bs + r * kLdN + 8 * k, a.b + (row0 + l0 + r) * a.ldbc + 8 * k);
    }
    for (int i = tid; i < Q * pq; i += kThreads) {
      const int r = i / pq, k = i - r * pq;
      cp_async16(xs + r * kLdP + 8 * k,
                 a.x + ((row0 + l0 + r) * H + h) * P + 8 * k);
    }
    cp_async_commit();
  };

  fetch_c_dt(0);
  fetch_b_x(0);
  for (int i = tid; i < kMaxP * kLdN / 2; i += kThreads)
    reinterpret_cast<uint32_t*>(hs)[i] = 0u;

  // the update's slice of h: rows 16 mw + (g, g+8), columns 32 nw + 8 j +
  // (2t, 2t+1); float32 across the whole sequence
  const int mw = warp & 3, nw = warp >> 2;
  const bool owns_h = 16 * mw < P && 32 * nw < N;
  float hacc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[j][e] = 0.f;

  const int n_strips = Q / 16, ksteps = N / 16;
  for (int l0 = 0; l0 < L; l0 += Q) {
    cp_async_wait<1>();  // this chunk's C and dt (B and x may be in flight)
    __syncthreads();
    {  // cum: a block scan of dt·A, one step a thread
      float v = tid < Q ? dts[tid] * A : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(kFull, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) wsum[warp] = v;
      __syncthreads();
      for (int w = 0; w < warp; ++w) v += wsum[w];
      if (tid < Q) {
        cums[tid] = v;
        ein[tid] = expf(v);
      }
      __syncthreads();
      if (tid < Q) wu[tid] = expf(cums[Q - 1] - v) * dts[tid];
    }

    // y.  Strips lo = j and hi = S-1-j (j = w / 2) go to warps 2j and
    // 2j+1: warp 2j takes all of lo and hi's first m key tiles, warp 2j+1
    // the rest of hi, and adds warp 2j's partial sum, handed over in hi's
    // rows of C (dead by then: both warps hold them in registers); each
    // warp gets (S+1)/2 tiles or one fewer.  With S odd, the middle strip
    // goes whole to warp S-1.
    {
      const int j = warp >> 1, role = warp & 1;
      const int lo = j, hi = n_strips - 1 - j;
      const bool active = warp < n_strips;
      const int m = (n_strips + 1) / 2 - 1 - j;  // hi's tiles on warp 2j
      const int own = role ? hi : lo;  // C·h_prev, D·x and y's store
      uint32_t ca[8][4];
      float acc[8][4];
      auto load_c = [&](int strip) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          if (kk < ksteps)
            ldsm_x4(ca[kk], cs + (16 * strip + (lane & 15)) * kLdN + 16 * kk +
                                8 * (lane >> 4));
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
      };
      if (active) {
        load_c(own);
        // exp(cum_q)·(C_q · h_prev): h's bf16 copy [p][n] is the B operand
        if (l0 > 0) {
          const int q0 = 16 * own;
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk >= ksteps) break;
#pragma unroll
            for (int jp = 0; jp < 4; ++jp) {
              if (16 * jp >= P) break;
              uint32_t hb[4];
              ldsm_x4(hb, hs + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * kLdN +
                              16 * kk + 8 * ((lane >> 3) & 1));
              mma(acc[2 * jp], ca[kk], hb[0], hb[1]);
              mma(acc[2 * jp + 1], ca[kk], hb[2], hb[3]);
            }
          }
          const float e0 = ein[q0 + g], e1 = ein[q0 + g + 8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][0] *= e0;
            acc[i][1] *= e0;
            acc[i][2] *= e1;
            acc[i][3] *= e1;
          }
        }
      }
      cp_async_wait<0>();  // this chunk's B and x
      __syncthreads();

      // acc += W·x over key tiles [t0, t1) of the strip at q0, with C's
      // fragments of that strip in ca
      auto key_tiles = [&](int q0, int t0, int t1) {
        const float cq0 = cums[q0 + g] * kLog2e;
        const float cq1 = cums[q0 + g + 8] * kLog2e;
        for (int s0 = 16 * t0; s0 < 16 * t1; s0 += 16) {
          // scores C·Bᵀ of 16 queries x 16 keys; B [s][n] is the B operand
          float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            if (kk >= ksteps) break;
            uint32_t bf[4];
            ldsm_x4(bf, bs + (s0 + (lane & 7) + 8 * (lane >> 4)) * kLdN +
                            16 * kk + 8 * ((lane >> 3) & 1));
            mma(sc[0], ca[kk], bf[0], bf[1]);
            mma(sc[1], ca[kk], bf[2], bf[3]);
          }
          // W = scores·exp(cum_q - cum_s)·dt_s where s <= q, else 0, rounded
          // to bf16 in the A layout of one k16 step
          uint32_t wa[4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int s = s0 + 8 * i + 2 * t;
            const float c0 = cums[s] * kLog2e, c1 = cums[s + 1] * kLog2e;
            const float d0 = dts[s], d1 = dts[s + 1];
            const int qa = q0 + g, qb = q0 + g + 8;
            const float w00 = s <= qa ? sc[i][0] * ex2(cq0 - c0) * d0 : 0.f;
            const float w01 =
                s + 1 <= qa ? sc[i][1] * ex2(cq0 - c1) * d1 : 0.f;
            const float w10 = s <= qb ? sc[i][2] * ex2(cq1 - c0) * d0 : 0.f;
            const float w11 =
                s + 1 <= qb ? sc[i][3] * ex2(cq1 - c1) * d1 : 0.f;
            wa[2 * i] = pack(w00, w01);
            wa[2 * i + 1] = pack(w10, w11);
          }
          // y += W·x; x [s][p] is the B operand, transposed by ldmatrix
#pragma unroll
          for (int jp = 0; jp < 4; ++jp) {
            if (16 * jp >= P) break;
            uint32_t xb[4];
            ldsm_x4_t(xb, xs + (s0 + (lane & 15)) * kLdP + 16 * jp +
                              8 * (lane >> 4));
            mma(acc[2 * jp], wa, xb[0], xb[1]);
            mma(acc[2 * jp + 1], wa, xb[2], xb[3]);
          }
        }
      };
      // y = acc + D·x of the strip at q0, as bf16
      auto store_y = [&](int q0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (8 * i >= P) break;
          const int p = 8 * i + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int q = q0 + g + 8 * r;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const bf162*>(xs + q * kLdP + p));
            *reinterpret_cast<uint32_t*>(
                a.y + ((row0 + l0 + q) * H + h) * P + p) =
                pack(acc[i][2 * r] + D * xv.x, acc[i][2 * r + 1] + D * xv.y);
          }
        }
      };
      // warp 2j's partial sum of hi: float32 in hi's rows of C, each lane
      // reading back what the same lane wrote
      float* part = reinterpret_cast<float*>(cs + 16 * hi * kLdN);
      auto part_at = [&](int i, int r) {
        return reinterpret_cast<float2*>(part + (g + 8 * r) * (kLdN / 2) +
                                         8 * i + 2 * t);
      };
      if (active && role == 0) {
        key_tiles(16 * lo, 0, lo + 1);
        store_y(16 * lo);
        if (lo != hi && m > 0) {
          load_c(hi);
          key_tiles(16 * hi, 0, m);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (8 * i >= P) break;
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *part_at(i, r) = make_float2(acc[i][2 * r], acc[i][2 * r + 1]);
          }
          bar_arrive(1 + j, 64);
        }
      } else if (active) {
        key_tiles(16 * hi, m, hi + 1);
        if (m > 0) {
          bar_sync(1 + j, 64);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (8 * i >= P) break;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 v = *part_at(i, r);
              acc[i][2 * r] += v.x;
              acc[i][2 * r + 1] += v.y;
            }
          }
        }
        store_y(16 * hi);
      }
    }
    __syncthreads();  // C, dt and h's copy are read; B and x stay
    const bool more = l0 + Q < L;
    if (more) fetch_c_dt(l0 + Q);

    // h = exp(cum_last)·h + Σ_s (x_s·w_s)ᵀ B_s, in float32 registers
    if (owns_h) {
      const float total = ein[Q - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[j][e] *= total;
      for (int s0 = 0; s0 < Q; s0 += 16) {
        // A = (x·w)ᵀ: 16 p x 16 s, x [s][p] transposed by ldmatrix
        uint32_t xa[4];
        ldsm_x4_t(xa, xs + (s0 + (lane & 7) + 8 * (lane >> 4)) * kLdP +
                          16 * mw + 8 * ((lane >> 3) & 1));
        const float w0 = wu[s0 + 2 * t], w1 = wu[s0 + 2 * t + 1];
        const float w2 = wu[s0 + 2 * t + 8], w3 = wu[s0 + 2 * t + 9];
        xa[0] = scale2(xa[0], w0, w1);
        xa[1] = scale2(xa[1], w0, w1);
        xa[2] = scale2(xa[2], w2, w3);
        xa[3] = scale2(xa[3], w2, w3);
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          const int n0 = 32 * nw + 16 * jn;
          if (n0 >= N) break;
          uint32_t bf[4];
          ldsm_x4_t(bf, bs + (s0 + (lane & 15)) * kLdN + n0 + 8 * (lane >> 4));
          mma(hacc[2 * jn], xa, bf[0], bf[1]);
          mma(hacc[2 * jn + 1], xa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // B and x are read
    if (owns_h) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 32 * nw + 8 * j + 2 * t;
        if (n >= N) break;
        const int p = 16 * mw + g;
        *reinterpret_cast<uint32_t*>(hs + p * kLdN + n) =
            pack(hacc[j][0], hacc[j][1]);
        *reinterpret_cast<uint32_t*>(hs + (p + 8) * kLdN + n) =
            pack(hacc[j][2], hacc[j][3]);
      }
    }
    if (more) fetch_b_x(l0 + Q);
  }
}

}  // namespace

extern "C" {

// bf16 x, B, C and y; float32 dt, a_log and D.  x, dt and y are
// contiguous; B and C are rows of N elements ldbc apart (ldbc >= N, a
// multiple of 8), so both may be column slices of one [B, C] tensor; x,
// B, C and y are 16-byte aligned.  The caller checks shapes (P, N and Q
// multiples of 16, P <= 64, N <= 128, Q <= 256, L % Q == 0, batch <=
// 65535); returns a cudaError_t.
int ssd_tc_launch(const void* x, const void* dt, const void* a_log,
                  const void* d, const void* b, const void* c, void* y,
                  int batch, int L, int H, int P, int N, int Q, int ldbc,
                  void* stream) {
  const Args a{static_cast<const bf16*>(x), static_cast<const float*>(dt),
               static_cast<const float*>(a_log), static_cast<const float*>(d),
               static_cast<const bf16*>(b), static_cast<const bf16*>(c),
               static_cast<bf16*>(y), L, H, P, N, Q, ldbc};
  const size_t smem = smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_tc_kernel<<<dim3(H, batch), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// dynamic shared memory of one block, in bytes (laid out at the largest P
// and N)
int ssd_tc_smem_bytes(int q) { return (int)smem_bytes(q); }

const char* ssd_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
