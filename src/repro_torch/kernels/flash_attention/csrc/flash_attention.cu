// Forward GQA flash attention for Hopper (sm_90a), CUDA cores, float32 math.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// (flash_attention_bh, _flash_kernel): q (BH, g, Sq, D), k/v (BH, Sk, D) ->
// o (BH, g, Sq, D), float32 or bfloat16 in and out, causal or not, with the
// q_offset / sk_valid masks and the skip of KV tiles in the causal future
// of a whole Q tile (k_first <= q_first + bq - 1).  m and l start at -1e30
// and 0, masked scores are -1e30 (not -inf) and l is clamped at 1e-30, as
// on the TPU, and KV is visited from tile 0 upwards, so a row whose first
// keys are all masked behaves as the TPU kernel's does.
//
// What bounds it on this card: at the serving shapes the function is
// compute-bound (4*g*D operations a visible query-key pair against q, k, v
// and o read or written once), so its bound is the bf16 tensor-core rate.
// This first version runs on the CUDA cores in float32 and sits far below
// that bound; it is right and simple, and the tensor-core redesign (wgmma,
// TMA, warp specialisation) is later work.
//
// Design.  One block per (q tile, row group, bh).  The tile's g*bq query
// rows (the whole GQA group shares each K/V tile, as on the TPU) are cut
// into groups of ROWS rows; each block keeps its rows' q in shared memory
// as float32 and walks the visible keys in sub-tiles of 32, staged in
// shared memory in the input type.  Each warp owns ROWS/NW rows, with
// their m, l and D-wide accumulators in registers: lane j scores key j of
// the sub-tile (a float32 dot product over D), the warp reduces the
// sub-tile's max and sum with shuffles, and for P.V lane c owns the output
// columns c, c+32, ....  The online softmax is updated every 32 keys
// instead of every bk keys; that changes float rounding only.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr int kKeys = 32;          // keys a sub-tile: one a lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;  // query rows a block
constexpr int kRowsPerWarp = kRows / kWarps;
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

// eight consecutive elements (16-byte aligned) as float32
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

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int g, sq, sk, d, bq, bk, causal, q_offset, sk_valid;
  float scale;
};

// padded row of a staged K sub-tile: 16 bytes past D, so that lane j's
// 16-byte reads of row j fall in distinct banks
template <typename T> __host__ __device__ constexpr int k_pad() {
  return 16 / sizeof(T);
}

template <typename T>
size_t smem_bytes(int d) {
  return sizeof(float) * kRows * (d + 4) +
         sizeof(T) * (kKeys * (d + k_pad<T>()) + kKeys * d);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = a.d, qd = d + 4, kd = d + k_pad<T>();
  float* q_s = reinterpret_cast<float*>(smem_raw);  // kRows x qd
  T* k_s = reinterpret_cast<T*>(q_s + kRows * qd);  // kKeys x kd
  T* v_s = k_s + kKeys * kd;                        // kKeys x d

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);

  const int qt = blockIdx.x, row0 = blockIdx.y * kRows, bh = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nrows = min(kRows, a.g * a.bq - row0);
  const int q_first = a.q_offset + qt * a.bq;

  // global offset of the block's local row i (row0 + i = gi * bq + qi)
  auto row_offset = [&](int i) -> size_t {
    const int r = row0 + i, gi = r / a.bq, qi = r - gi * a.bq;
    return ((size_t)(bh * a.g + gi) * a.sq + qt * a.bq + qi) * d;
  };

  for (int idx = tid; idx < nrows * d; idx += kThreads) {
    const int i = idx / d, c = idx - i * d;
    q_s[i * qd + c] = to_f32(q[row_offset(i) + c]);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DPL];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int gr = row0 + warp + r * kWarps;
    qpos[r] = q_first + (gr % a.bq);
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // KV tiles visited: all, or (causal) those with k_first <= q_first+bq-1
  const int nk = a.sk / a.bk;
  int n_tiles = nk;
  if (a.causal) {
    const int last = q_first + a.bq - 1;
    n_tiles = last < 0 ? 0 : min(nk, last / a.bk + 1);
  }
  const int n_keys = n_tiles * a.bk;
  const T* kb = k + (size_t)bh * a.sk * d;
  const T* vb = v + (size_t)bh * a.sk * d;

  for (int j0 = 0; j0 < n_keys; j0 += kKeys) {
    const int n = min(kKeys, n_keys - j0);
    __syncthreads();  // the previous sub-tile is consumed (and q_s written)
    for (int idx = tid; idx < n * d; idx += kThreads) {
      const int j = idx / d, c = idx - j * d;
      k_s[j * kd + c] = kb[(size_t)(j0 + j) * d + c];
      v_s[j * d + c] = vb[(size_t)(j0 + j) * d + c];
    }
    __syncthreads();

    const int kpos = j0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp + r * kWarps;
      if (i >= nrows) break;  // warp-uniform
      float s = -INFINITY;    // lanes past the sub-tile hold no key
      if (lane < n) {
        const float* qr = q_s + i * qd;
        const T* kr = k_s + lane * kd;
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
        s = dot * a.scale;
        bool ok = kpos < a.sk_valid;
        if (a.causal) ok = ok && qpos[r] >= kpos;
        if (!ok) s = kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int col = lane + 32 * c;
          if (col < d) acc[r][c] += pj * to_f32(v_s[j * d + col]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = warp + r * kWarps;
    if (i >= nrows) break;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = o + row_offset(i);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) orow[col] = from_f32<T>(acc[r][c] / lc);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch_typed(const FlashArgs& a, int bh, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(a.d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.sq / a.bq, (a.g * a.bq + kRows - 1) / kRows, bh);
  flash_fwd_kernel<T, DPL><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dpl(const FlashArgs& a, int bh, cudaStream_t stream) {
  if (a.d <= 32) return launch_typed<T, 1>(a, bh, stream);
  if (a.d <= 64) return launch_typed<T, 2>(a, bh, stream);
  return launch_typed<T, 4>(a, bh, stream);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  The caller checks shapes (D % 8 == 0,
// D <= 128, Sq % bq == 0, Sk % bk == 0, BH <= 65535); returns a cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int bh, int g, int sq, int sk,
                           int d, int bq, int bk, int causal, int q_offset,
                           int sk_valid, float scale, void* stream) {
  const FlashArgs a{q, k, v, o, g, sq, sk, d, bq, bk, causal, q_offset,
                    sk_valid, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_dpl<float>(a, bh, s)
                    : launch_dpl<__nv_bfloat16>(a, bh, s);
}

// dynamic shared memory of one block, in bytes
int flash_attention_smem_bytes(int dtype, int d) {
  return (int)(dtype == 0 ? smem_bytes<float>(d)
                          : smem_bytes<__nv_bfloat16>(d));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
