// Single-token GQA decode attention for Hopper (sm_90a), float32 math.
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
// What bounds it on this card: the bytes of K and V up to kv_len, read
// once at the HBM rate; it does ~4*g*D operations a key, far below the
// compute rate.
//
// Design.  One block per bh row: the g query rows of one KV head, in
// shared memory as float32.  The block's 8 warps split the visited keys
// into 32-key sub-tiles (warp w takes sub-tiles w, w+8, ...), so each
// warp streams its own share of the cache: it stages a sub-tile of K in
// shared memory with coalesced loads, lane j scores key j for every row,
// and V is read straight from global memory, lane c owning output columns
// c, c+32, ....  Each warp keeps an online softmax (m, l, acc) for each
// row in registers; at the end the block merges the eight partial states.
// One block per bh underfills the card at small B*KH: a split over KV
// across blocks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr int kKeys = 32;          // keys a sub-tile: one a lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxGroup = 8;  // query rows a KV head (g)
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

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_len;
  int g, s, d, bk;
  float scale;
};

template <typename T> __host__ __device__ constexpr int k_pad() {
  return 16 / sizeof(T);
}

// a warp's shared memory: a staged K sub-tile or, at the end, its partial
// (m, l, acc) for each row; rounded up to 16 bytes
template <typename T> __host__ __device__ size_t warp_bytes(int g, int d) {
  const size_t stage = sizeof(T) * kKeys * (d + k_pad<T>());
  const size_t partial = sizeof(float) * g * (d + 2);
  return ((stage > partial ? stage : partial) + 15) / 16 * 16;
}

// q rows as float32, then the warps' areas
template <typename T> size_t smem_bytes(int g, int d) {
  return sizeof(float) * g * (d + 4) + kWarps * warp_bytes<T>(g, d);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g = a.g, d = a.d, qd = d + 4, kd = d + k_pad<T>();
  const size_t per_warp = warp_bytes<T>(g, d);
  float* q_s = reinterpret_cast<float*>(smem_raw);  // g x qd
  unsigned char* warp_area = smem_raw + sizeof(float) * g * qd;

  const int bh = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q) + (size_t)bh * g * d;
  const T* kb = static_cast<const T*>(a.k) + (size_t)bh * a.s * d;
  const T* vb = static_cast<const T*>(a.v) + (size_t)bh * a.s * d;
  T* o = static_cast<T*>(a.o) + (size_t)bh * g * d;
  T* k_w = reinterpret_cast<T*>(warp_area + warp * per_warp);

  for (int idx = tid; idx < g * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    q_s[r * qd + c] = to_f32(q[idx]);
  }
  __syncthreads();

  // keys of the tiles visited: those with k_first < kv_len
  const int kv_len = *a.kv_len;
  const int n_keys =
      kv_len <= 0 ? 0 : min(a.s, (kv_len + a.bk - 1) / a.bk * a.bk);

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][DPL];
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  for (int j0 = warp * kKeys; j0 < n_keys; j0 += kWarps * kKeys) {
    const int n = min(kKeys, n_keys - j0);
    __syncwarp();  // the previous sub-tile is consumed
    for (int idx = lane; idx < n * d; idx += 32) {
      const int j = idx / d, c = idx - j * d;
      k_w[j * kd + c] = kb[(size_t)j0 * d + idx];
    }
    __syncwarp();

    const int kpos = j0 + lane;
    float p[kMaxGroup];
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) {
      if (r >= g) break;
      float s = -INFINITY;  // lanes past the sub-tile hold no key
      if (lane < n) {
        const float* qr = q_s + r * qd;
        const T* kr = k_w + lane * kd;
        float dot = 0.f;
        for (int c = 0; c < d; c += 8) {
          float kk[8];
          load8(kr + c, kk);
          const float4 q0 = *reinterpret_cast<const float4*>(qr + c);
          const float4 q1 = *reinterpret_cast<const float4*>(qr + c + 4);
          dot += q0.x * kk[0]; dot += q0.y * kk[1];
          dot += q0.z * kk[2]; dot += q0.w * kk[3];
          dot += q1.x * kk[4]; dot += q1.y * kk[5];
          dot += q1.z * kk[6]; dot += q1.w * kk[7];
        }
        s = kpos < kv_len ? dot * a.scale : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(s));
      p[r] = lane < n ? expf(s - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
    }
    for (int j = 0; j < n; ++j) {
      const T* vrow = vb + (size_t)(j0 + j) * d;
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < d ? to_f32(vrow[col]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kMaxGroup; ++r) {
        if (r >= g) break;
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] += pj * vv[c];
      }
    }
  }

  // merge the warps' partial softmax states: (m, l, acc[d]) a row
  __syncthreads();  // every warp is done with its staged K
  float* part = reinterpret_cast<float*>(warp_area + warp * per_warp);
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    if (r >= g) break;
    float* row = part + r * (d + 2);
    if (lane == 0) {
      row[0] = m[r];
      row[1] = l[r];
    }
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) row[2 + col] = acc[r][c];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = reinterpret_cast<const float*>(
          warp_area + w * per_warp) + r * (d + 2);
      mx = fmaxf(mx, row[0]);
    }
    float lsum = 0.f, asum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* row = reinterpret_cast<const float*>(
          warp_area + w * per_warp) + r * (d + 2);
      const float f = expf(row[0] - mx);
      lsum += row[1] * f;
      asum += row[2 + c] * f;
    }
    o[idx] = from_f32<T>(asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int DPL>
cudaError_t launch_typed(const DecodeArgs& a, int bh, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.g, a.d);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, DPL><<<bh, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dpl(const DecodeArgs& a, int bh, cudaStream_t stream) {
  if (a.d <= 32) return launch_typed<T, 1>(a, bh, stream);
  if (a.d <= 64) return launch_typed<T, 2>(a, bh, stream);
  return launch_typed<T, 4>(a, bh, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  kv_len points to one int32 on the device.
// The caller checks shapes (D % 8 == 0, D <= 128, g <= 8, S % bk == 0);
// returns a cudaError_t.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            void* o, const void* kv_len, int dtype, int bh,
                            int g, int s, int d, int bk, float scale,
                            void* stream) {
  const DecodeArgs a{q, k, v, o, static_cast<const int*>(kv_len), g, s, d,
                     bk, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_dpl<float>(a, bh, st)
                    : launch_dpl<__nv_bfloat16>(a, bh, st);
}

// dynamic shared memory of one block, in bytes
int decode_attention_smem_bytes(int dtype, int g, int d) {
  return (int)(dtype == 0 ? smem_bytes<float>(g, d)
                          : smem_bytes<__nv_bfloat16>(g, d));
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
