// Single-token GQA decode attention for Hopper (sm_90a), float32 math,
// split over the cache (flash-decoding).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py (decode_attention_bh,
// _decode_kernel): q (BH, g, D), k/v (BH, S, D), kv_len an int32 on the
// device -> o (BH, g, D), float32 or bfloat16 in and out.  The cache's fill
// level is read at run time, so one build serves every kv_len; KV tiles of
// bk keys at or past kv_len are skipped (k_first < kv_len is visited), keys
// past kv_len inside the last visited tile are masked to -1e30, m and l
// start at -1e30 and 0, and l is clamped at 1e-30, so kv_len = 0 gives
// zeros as on the TPU.
//
// What bounds it on this card: bytes.  K and V up to kv_len are read once;
// the work is 4*g*D operations a key against 4*D bytes of bf16 K and V, at
// most 8 operations a byte (g <= 8): below the ~20 a byte at which the
// float32 CUDA cores would be the limit, and far below the ~295 of the
// tensor cores.  So no wgmma: with g <= 8 query rows a 64-row product would
// leave the tensor cores idle, and the CUDA cores keep up with the bytes.
//
// Design, to keep enough bytes in flight to reach the HBM rate:
// - The grid is (B*KH, n_split).  Each block takes one split of the cache:
//   a run of whole 32-key chunks (ref.py::split_keys).  The wrapper picks
//   n_split from S and B*KH so that the grid covers the 132 SMs several
//   times over.  A block whose split starts at or past kv_len writes the
//   empty partial (-1e30, 0, 0) and exits, so one build serves every fill.
// - The block's two warps each stream their own chunks (warp w takes
//   chunks w, w + 2, ...) through a ring of three stages in shared memory:
//   K and V of a chunk arrive by 16-byte cp.async copies, two chunks ahead
//   of the one being scored, so ~2 x 16 KB a warp (bf16, D 128) are in
//   flight while it computes.
// - Scores: lane j takes key j of the staged chunk for all g query rows
//   (q in shared memory as float32, read by broadcast).  Each warp keeps
//   an online softmax (m, l, acc) a row; P goes through shared memory and
//   P.V reads V from the staged chunk, lane c owning D/32 adjacent columns.
// - The warps' states merge in shared memory into one float32 partial
//   (m, l, acc[D]) a row, written to the scratch buffer the wrapper
//   allocates.  Then each block takes a ticket of its bh (an atomic add on
//   an int32 the wrapper keeps zeroed); the block that takes the last one
//   merges the splits' partials (each rescaled by exp(m - max m)), casts
//   the output once and sets the ticket back to 0.  So a call is one
//   launch: at a small cache its host time, not the device, sets its pace.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr int kKeys = 32;          // keys a chunk: one a lane
constexpr int kWarps = 2;          // warps a split block, each its own ring
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;         // chunks a warp's ring holds
constexpr int kMaxGroup = 8;       // query rows a KV head (g)
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

// eight consecutive elements, 16-byte aligned, as float32
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// DPL adjacent elements (DPL in 1, 2, 4), aligned to their size, as float32
template <int DPL>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (DPL == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else if constexpr (DPL == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = *p;
  }
}
template <int DPL>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float* out) {
  if constexpr (DPL == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (DPL == 2) {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// 16 bytes global -> shared, asynchronous; zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct SplitArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;  // BH x n_split x g x (D + 2): m, l, acc[D] a row
  int* tickets;  // BH, zero between launches
  const int* kv_len;
  int g, s, d, bk, n_split, split_keys;
  float scale;
};

// a staged row: D elements and 16 bytes of padding, so that lane j's
// 16-byte reads of row j fall in other banks than lane j+1's
template <typename T> __host__ __device__ constexpr int k_pad() {
  return 16 / sizeof(T);
}

// a warp's shared memory: its ring of K and V chunks and its P rows, or at
// the end its merged (m, l, acc) rows; rounded up to 16 bytes
template <typename T> __host__ __device__ size_t warp_bytes(int g, int d) {
  const size_t ring =
      sizeof(T) * kStages * 2 * kKeys * (d + k_pad<T>()) +
      sizeof(float) * kMaxGroup * kKeys;
  const size_t merge = sizeof(float) * g * (d + 2);
  return ((ring > merge ? ring : merge) + 15) / 16 * 16;
}

// q rows as float32, then the warps' areas
template <typename T> size_t smem_bytes(int g, int d) {
  return sizeof(float) * g * (d + 4) + kWarps * warp_bytes<T>(g, d);
}

// chunk of `n_valid` keys (rows past it zero-filled) at kg/vg -> ks/vs.
// Row r's 16-byte piece c is piece i = r * per_row + c of the chunk both
// in device memory (i * E elements on) and in shared memory (i * E + r *
// pad on); r = i / per_row by a multiply (exact for i < 1,024, per_row <=
// 32).
template <typename T>
__device__ __forceinline__ void load_chunk(T* ks, T* vs, const T* kg,
                                           const T* vg, int n_valid,
                                           int per_row, unsigned inv_row,
                                           int lane) {
  constexpr int E = 16 / sizeof(T);
  for (int i = lane; i < kKeys * per_row; i += 32) {
    const int r = static_cast<int>((static_cast<unsigned>(i) * inv_row) >> 16);
    const bool ok = r < n_valid;
    const int so = i * E + r * k_pad<T>();
    const int go = ok ? i * E : 0;
    cp_async16(ks + so, kg + go, ok);
    cp_async16(vs + so, vg + go, ok);
  }
}

// the partial of this block's split, start < kv_len, into part
template <typename T, int DPL>
__device__ __forceinline__ void score_split(const SplitArgs& a, float* part,
                                            int start, int kv_len,
                                            unsigned char* smem_raw) {
  const int g = a.g, d = a.d, qd = d + 4, kd = d + k_pad<T>();
  const int bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // keys of the tiles visited (k_first < kv_len), and this split's share
  const int n_keys = min(a.s, (kv_len + a.bk - 1) / a.bk * a.bk);
  const int end = min(start + a.split_keys, n_keys);
  const int n_chunks = (end - start + kKeys - 1) / kKeys;
  const int mine = n_chunks > warp ? (n_chunks - warp + kWarps - 1) / kWarps
                                   : 0;

  const size_t per_warp = warp_bytes<T>(g, d);
  float* q_s = reinterpret_cast<float*>(smem_raw);  // g x qd
  unsigned char* warp_area =
      smem_raw + (sizeof(float) * g * qd + 15) / 16 * 16;
  T* ring = reinterpret_cast<T*>(warp_area + warp * per_warp);
  float* p_s = reinterpret_cast<float*>(ring + kStages * 2 * kKeys * kd);
  const int stage_elems = 2 * kKeys * kd;  // K then V of one chunk

  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.s * d;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.s * d;
  const int per_row = d * (int)sizeof(T) / 16;
  const unsigned inv_row = (65536u + per_row - 1) / per_row;
  auto issue = [&](int i) {  // this warp's i-th chunk into stage i % kStages
    const int k0 = start + (warp + i * kWarps) * kKeys;
    T* st = ring + (i % kStages) * stage_elems;
    load_chunk<T>(st, st + kKeys * kd, kb + (size_t)k0 * d,
                  vb + (size_t)k0 * d, min(kKeys, end - k0), per_row,
                  inv_row, lane);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }

  const T* q = static_cast<const T*>(a.q) + (size_t)bh * g * d;
  for (int idx = tid; idx < g * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    q_s[r * qd + c] = to_f32(q[idx]);
  }
  __syncthreads();

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][DPL];
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;  // this lane's share of l; summed over the warp at the end
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }
  const int col0 = lane * DPL;  // this lane's P.V columns
  const bool has_cols = col0 < d;

  for (int i = 0; i < mine; ++i) {
    if (i + kStages - 1 < mine) issue(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk i has landed (this lane's part)
    __syncwarp();                  // ... and every lane's

    const T* ks = ring + (i % kStages) * stage_elems;
    const T* vs = ks + kKeys * kd;
    const int k0 = start + (warp + i * kWarps) * kKeys;
    const int n = min(kKeys, end - k0);
    const int kpos = k0 + lane;

    // lane's key against every row: two partial sums a row for ILP
    float dot0[kMaxGroup], dot1[kMaxGroup];
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) dot0[r] = dot1[r] = 0.f;
    const T* kr = ks + lane * kd;
    for (int c = 0; c < d; c += 8) {
      float kk[8];
      load8(kr + c, kk);
#pragma unroll
      for (int r = 0; r < kMaxGroup; ++r) {
        if (r >= g) break;
        const float* qr = q_s + r * qd + c;
        const float4 q0 = *reinterpret_cast<const float4*>(qr);
        const float4 q1 = *reinterpret_cast<const float4*>(qr + 4);
        dot0[r] += q0.x * kk[0]; dot1[r] += q0.y * kk[1];
        dot0[r] += q0.z * kk[2]; dot1[r] += q0.w * kk[3];
        dot0[r] += q1.x * kk[4]; dot1[r] += q1.y * kk[5];
        dot0[r] += q1.z * kk[6]; dot1[r] += q1.w * kk[7];
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) {
      if (r >= g) break;
      // lanes past the chunk hold no key; keys past kv_len are masked
      const float s = lane >= n ? -INFINITY
                    : kpos < kv_len ? (dot0[r] + dot1[r]) * a.scale
                                    : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + p;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      p_s[r * kKeys + lane] = p;
    }
    __syncwarp();

    if (has_cols) {
      for (int j = 0; j < n; ++j) {
        float vv[DPL];
        load_cols<DPL>(vs + j * kd + col0, vv);
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r) {
          if (r >= g) break;
          const float pj = p_s[r * kKeys + j];
#pragma unroll
          for (int c = 0; c < DPL; ++c) acc[r][c] += pj * vv[c];
        }
      }
    }
    __syncwarp();  // stage i % kStages and p_s are free again
  }
  cp_async_wait<0>();  // no copy may land in the merge area below

  // merge the warps' states into the split's partial
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    if (r >= g) break;
    l[r] = warp_sum(l[r]);
  }
  __syncthreads();  // every warp is done with its ring
  float* mine_row = reinterpret_cast<float*>(warp_area + warp * per_warp);
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    if (r >= g) break;
    float* row = mine_row + r * (d + 2);
    if (lane == 0) {
      row[0] = m[r];
      row[1] = l[r];
    }
    if (has_cols) {
#pragma unroll
      for (int c = 0; c < DPL; ++c) row[2 + col0 + c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * (d + 2); idx += kThreads) {
    const int r = idx / (d + 2), c = idx - r * (d + 2);
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, reinterpret_cast<const float*>(
                         warp_area + w * per_warp)[r * (d + 2)]);
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = reinterpret_cast<const float*>(
          warp_area + w * per_warp) + r * (d + 2);
      const float f = expf(row[0] - mx);
      sum += (c == 0 ? 0.f : row[c]) * f;
    }
    part[idx] = c == 0 ? mx : sum;
  }
}

// o[bh] from the n_split partials of bh: each split's (l, acc) rescaled by
// exp(m - max m), acc / max(l, 1e-30), cast once.  The partials of other
// blocks are read from L2 (ld.global.cg): this SM's L1 may hold a stale
// copy of a line shared with the next bh's partials.
template <typename T>
__device__ __forceinline__ void combine(const SplitArgs& a, int bh) {
  const int g = a.g, d = a.d, n_split = a.n_split, row_len = d + 2;
  const float* base = a.part + (size_t)bh * n_split * g * row_len;
  T* o = static_cast<T*>(a.o) + (size_t)bh * g * d;
  for (int idx = threadIdx.x; idx < g * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    float mx = kNegInf;
    for (int i = 0; i < n_split; ++i)
      mx = fmaxf(mx, __ldcg(base + (i * g + r) * row_len));
    float lsum = 0.f, asum = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float* row = base + (i * g + r) * row_len;
      const float f = expf(__ldcg(row) - mx);
      lsum += __ldcg(row + 1) * f;
      asum += __ldcg(row + 2 + c) * f;
    }
    o[idx] = from_f32<T>(asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
split_kernel(SplitArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last;
  const int bh = blockIdx.x, split = blockIdx.y, tid = threadIdx.x;
  const int row_len = a.d + 2;
  float* part = a.part + ((size_t)bh * a.n_split + split) * a.g * row_len;
  const int kv_len = *a.kv_len;
  const int start = split * a.split_keys;
  if (start < kv_len) {
    score_split<T, DPL>(a, part, start, kv_len, smem_raw);
  } else {  // the empty partial (also every split at kv_len 0)
    for (int idx = tid; idx < a.g * row_len; idx += kThreads)
      part[idx] = idx % row_len == 0 ? kNegInf : 0.f;
  }

  // the block that takes the last ticket of bh merges its partials; the
  // barrier orders every thread's partial before thread 0's fence, as in a
  // grid-wide sync
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // this block's partial is visible before its ticket
    last = atomicAdd(a.tickets + bh, 1) == a.n_split - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // ... and every other block's before the reads
  combine<T>(a, bh);
  if (tid == 0) a.tickets[bh] = 0;  // ready for the next launch
}

template <typename T, int DPL>
cudaError_t launch_typed(const SplitArgs& a, int bh, cudaStream_t stream) {
  // the shared-memory limit each device has been given for this kernel,
  // so that a call pays for cudaFuncSetAttribute only when it must raise it
  constexpr int kDevices = 64;
  static size_t granted[kDevices] = {};
  const size_t smem = smem_bytes<T>(a.g, a.d);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices || smem > granted[dev]) {
    err = cudaFuncSetAttribute(split_kernel<T, DPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < kDevices) granted[dev] = smem;
  }
  split_kernel<T, DPL><<<dim3(bh, a.n_split), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dpl(const SplitArgs& a, int bh, cudaStream_t stream) {
  if (a.d <= 32) return launch_typed<T, 1>(a, bh, stream);
  if (a.d <= 64) return launch_typed<T, 2>(a, bh, stream);
  return launch_typed<T, 4>(a, bh, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  kv_len points to one int32 on the device;
// part is float32 scratch of bh x n_split x g x (d + 2); tickets is bh
// int32 that are zero, and zero again once the launch has run (no two
// launches in flight may share them).  The caller checks shapes and
// alignment (D % 8 == 0, D <= 128, g <= 8, S % bk == 0, k and v 16-byte
// aligned, n_split <= 65535, split_keys a multiple of 32 with n_split *
// split_keys >= S); returns a cudaError_t.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, void* part, void* tickets,
                            const void* kv_len, int dtype, int bh, int g,
                            int s, int d, int bk, int n_split,
                            int split_keys, float scale, void* stream) {
  const SplitArgs a{q, k, v, o, static_cast<float*>(part),
                    static_cast<int*>(tickets),
                    static_cast<const int*>(kv_len), g, s, d, bk, n_split,
                    split_keys, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_dpl<float>(a, bh, st)
                    : launch_dpl<__nv_bfloat16>(a, bh, st);
}

// dynamic shared memory of one split block, in bytes
int decode_attention_smem_bytes(int dtype, int g, int d) {
  return (int)(dtype == 0 ? smem_bytes<float>(g, d)
                          : smem_bytes<__nv_bfloat16>(g, d));
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
