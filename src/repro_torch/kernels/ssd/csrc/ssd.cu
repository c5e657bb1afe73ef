// Mamba2 SSD chunked scan for Hopper (sm_90a), CUDA cores, float32 math.
//
// Replaces the TPU kernel src/repro/kernels/ssd/ssd.py (ssd_pallas,
// _ssd_kernel): x (B, L, H, P), dt (B, L, H) float32, a_log and D (H,)
// float32, B/C (B, L, N) -> y (B, L, H, P), float32 or bfloat16 in and out.
// For each (b, h), chunk by chunk of Q steps, with cum the inclusive
// running sum of dt·A over the chunk (A = -exp(a_log)):
//   y_q = Σ_{s<=q} (C_q·B_s) exp(cum_q - cum_s) x_s dt_s
//         + exp(cum_q) (C_q · h_prev) + D x_q
//   h   = exp(cum_{Q-1}) h_prev + Σ_s exp(cum_{Q-1} - cum_s) x_s dt_s ⊗ B_s
// with h (P x N, float32) carried from chunk to chunk.
//
// What bounds it on this card: at the model's shapes (Q 256, N 128, P 64,
// 48 heads sharing B and C) the function needs ~6.4M multiply-adds a
// (b, head, chunk) tile once the C·Bᵀ scores are formed once for all heads,
// and reads x, B, C and dt and writes y once: the bytes at HBM rate take
// longer than the operations at the bf16 tensor-core rate, so it is
// bound by bytes.  This first version runs on the CUDA cores in float32,
// forms the scores again for every head and reads B and C once a head
// (from L2), and sits far below that bound; it is right and simple, and
// the redesign (scores shared by the heads, wgmma for the products) is
// later work.
//
// Design.  The TPU grid is (B, H, chunks) with the chunks innermost and h
// in VMEM scratch; here blocks run in no order, so one block takes a whole
// (b, h) pair and loops over its chunks, with h in shared memory for the
// whole sequence.  A Q x Q score matrix (256 KB in float32 at Q 256) does
// not fit a block's shared memory, so each chunk is cut into tiles of 64
// rows: for each query tile the block computes exp(cum_q)·C·h_prev from
// the state before the chunk, then walks the key tiles s <= q, staging B
// and x·dt in shared memory as float32, forming the masked, decayed
// 64 x 64 scores (exp(cum_q - cum_s) only where q >= s) and adding their
// product with x·dt.  After every query tile has read h (a barrier), the
// block walks the key tiles once more for the state update.  Warp 0 forms
// cum with shuffle scans of 32 steps.
//
// Every product is register-tiled: the 256 threads form a 16 x 16 grid
// and each owns a 4 x 4 block of a 64 x 64 output (8 x 4 of the 128 x 64
// state), so one step of a product reads two float4s from shared memory
// for 16 (32) multiply-adds.  The tiles are staged in the layout each
// product reads along its sum: C, B (for the scores) and h with the sum
// index outermost (n-major), the scores s-major, x·dt s-major.  Shapes
// below the maxima (P < 64, N < 128, a last tile of fewer than 64 rows)
// are padded with zeros in shared memory, and the padded outputs are not
// written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // rows of a query or key tile
constexpr int kMaxP = 64;   // head dim: 16 threads x 4 columns
constexpr int kMaxN = 128;  // state: 16 threads x 8 rows in the update
constexpr int kLd = 68;     // row of a 64-wide tile, padded (float4 rows)
constexpr int kLdN = kMaxN + 4;  // row of a 128-wide tile, padded
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

struct SsdArgs {
  const void* x;
  const float* dt;
  const float* a_log;
  const float* d;
  const void* b;
  const void* c;
  void* y;
  int L, H, P, N, Q;
  int ldbc;  // elements from one row (token) of B or C to the next
};

// floats of dynamic shared memory: h (n-major), the C tile (n-major), the
// key buffer (B n-major, or weighted B s-major), x·dt, the scores
// (s-major), dt and cum of a chunk
constexpr int kTileN = kMaxN * kLd;  // >= kRows * kLdN
constexpr int kTile64 = kRows * kLd;
static_assert(kTileN >= kRows * kLdN, "the key buffer holds both layouts");
size_t smem_floats(int q) {
  return 3 * (size_t)kTileN + 2 * (size_t)kTile64 + 2 * (size_t)q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(SsdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int P = a.P, N = a.N, Q = a.Q, L = a.L, H = a.H;
  float* hT = smem;            // [n][p], kLd
  float* cT = hT + kTileN;     // [n][r], kLd
  float* kb = cT + kTileN;     // [n][s] kLd, or [s][n] kLdN
  float* xs = kb + kTileN;     // [s][p], kLd
  float* sT = xs + kTile64;    // [s][r], kLd
  float* dt_s = sT + kTile64;  // Q
  float* cum_s = dt_s + Q;     // Q

  const int h = blockIdx.x, bb = blockIdx.y, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const T* x = static_cast<const T*>(a.x);
  const T* bin = static_cast<const T*>(a.b);
  const T* cin = static_cast<const T*>(a.c);
  T* y = static_cast<T*>(a.y);
  const float A = -expf(a.a_log[h]);
  const float D = a.d[h];
  auto xy_at = [&](int l, int p) -> size_t {
    return (((size_t)bb * L + l) * H + h) * P + p;
  };
  auto bc_at = [&](int l, int n) -> size_t {
    return ((size_t)bb * L + l) * a.ldbc + n;
  };
  // x·dt of the key tile at chunk row s0, zero past nk rows or P columns
  auto stage_x = [&](int l0, int s0, int nk) {
    for (int i = tid; i < kRows * kMaxP; i += kThreads) {
      const int r = i / kMaxP, p = i - r * kMaxP;
      xs[r * kLd + p] = r < nk && p < P
          ? to_f32(x[xy_at(l0 + s0 + r, p)]) * dt_s[s0 + r] : 0.f;
    }
  };

  for (int i = tid; i < kTileN; i += kThreads) hT[i] = 0.f;
  const int n_tiles = (Q + kRows - 1) / kRows;

  for (int l0 = 0; l0 < L; l0 += Q) {
    __syncthreads();  // the previous chunk is done with dt_s, cum_s and hT
    for (int i = tid; i < Q; i += kThreads)
      dt_s[i] = a.dt[((size_t)bb * L + l0 + i) * H + h];
    __syncthreads();
    if (tid < 32) {  // cum: inclusive running sum of dt·A, 32 steps a scan
      float carry = 0.f;
      for (int i0 = 0; i0 < Q; i0 += 32) {
        const int i = i0 + tid;
        float v = i < Q ? dt_s[i] * A : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(kFull, v, o);
          if (tid >= o) v += u;
        }
        v += carry;
        if (i < Q) cum_s[i] = v;
        carry = __shfl_sync(kFull, v, 31);
      }
    }
    __syncthreads();

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kRows, nq = min(kRows, Q - q0);
      for (int i = tid; i < kRows * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        cT[n * kLd + r] = r < nq ? to_f32(cin[bc_at(l0 + q0 + r, n)]) : 0.f;
      }
      __syncthreads();
      // rows 4ty+i, columns 4tx+j: exp(cum_q)·(C_q · h_prev) first
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 c4 = ld4(cT + n * kLd + 4 * ty);
        const float4 h4 = ld4(hT + n * kLd + 4 * tx);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * hv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        const float e = r < nq ? expf(cum_s[q0 + r]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      for (int kt = 0; kt <= qt; ++kt) {
        const int s0 = kt * kRows, nk = min(kRows, Q - s0);
        __syncthreads();  // the previous key tile and scores are consumed
        for (int i = tid; i < kRows * N; i += kThreads) {
          const int r = i / N, n = i - r * N;
          kb[n * kLd + r] = r < nk ? to_f32(bin[bc_at(l0 + s0 + r, n)]) : 0.f;
        }
        stage_x(l0, s0, nk);
        __syncthreads();
        // scores C_q·B_s, decayed by exp(cum_q - cum_s) where q >= s
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          const float4 c4 = ld4(cT + n * kLd + 4 * ty);
          const float4 b4 = ld4(kb + n * kLd + 4 * tx);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = 4 * tx + j, sk = s0 + s;
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 4 * ty + i, q = q0 + r;
            v[i] = r < nq && s < nk && sk <= q
                ? sc[i][j] * expf(cum_s[q] - cum_s[sk]) : 0.f;
          }
          *reinterpret_cast<float4*>(sT + s * kLd + 4 * ty) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncthreads();
        for (int s = 0; s < nk; ++s) {
          const float4 s4 = ld4(sT + s * kLd + 4 * ty);
          const float4 x4 = ld4(xs + s * kLd + 4 * tx);
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += sv[i] * xv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = 4 * tx + j;
          if (r < nq && p < P) {
            const size_t o = xy_at(l0 + q0 + r, p);
            y[o] = from_f32<T>(acc[i][j] + D * to_f32(x[o]));
          }
        }
      }
      __syncthreads();  // cT, the key tiles and hT's readers are done
    }

    // h = exp(cum_last)·h_prev + Σ_s (x_s dt_s) ⊗ (B_s exp(cum_last - cum_s)),
    // kept as hT[n][p]: rows n = 8ty+i, columns p = 4tx+j
    const float last = cum_s[Q - 1];
    float sacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int s0 = kt * kRows, nk = min(kRows, Q - s0);
      __syncthreads();
      for (int i = tid; i < kRows * kMaxN; i += kThreads) {
        const int r = i / kMaxN, n = i - r * kMaxN;
        kb[r * kLdN + n] = r < nk && n < N
            ? to_f32(bin[bc_at(l0 + s0 + r, n)]) * expf(last - cum_s[s0 + r])
            : 0.f;
      }
      stage_x(l0, s0, nk);
      __syncthreads();
      for (int s = 0; s < nk; ++s) {
        const float4 b0 = ld4(kb + s * kLdN + 8 * ty);
        const float4 b1 = ld4(kb + s * kLdN + 8 * ty + 4);
        const float4 x4 = ld4(xs + s * kLd + 4 * tx);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] += bv[i] * xv[j];
      }
    }
    const float total = expf(last);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = 8 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * tx + j;
        if (n < N && p < P)
          hT[n * kLd + p] = hT[n * kLd + p] * total + sacc[i][j];
      }
    }
  }
}

template <typename T>
cudaError_t launch_typed(const SsdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_floats(a.Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, batch);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (x, B, C and y).  x, dt and y are
// contiguous; B and C are rows of N elements ldbc apart (ldbc >= N), so
// both may be column slices of one [B, C] tensor.  The caller checks shapes
// (P <= 64, N <= 128, L % Q == 0, batch <= 65535, the shared memory);
// returns a cudaError_t.
int ssd_launch(const void* x, const void* dt, const void* a_log,
               const void* d, const void* b, const void* c, void* y,
               int dtype, int batch, int L, int H, int P, int N, int Q,
               int ldbc, void* stream) {
  const SsdArgs a{x, static_cast<const float*>(dt),
                  static_cast<const float*>(a_log),
                  static_cast<const float*>(d), b, c, y, L, H, P, N, Q,
                  ldbc};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_typed<float>(a, batch, s)
                    : launch_typed<__nv_bfloat16>(a, batch, s);
}

// dynamic shared memory of one block, in bytes
// (the tiles are laid out at the largest P and N)
int ssd_smem_bytes(int q) { return (int)(smem_floats(q) * sizeof(float)); }

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
