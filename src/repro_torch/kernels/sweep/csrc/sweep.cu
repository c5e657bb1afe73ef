// Batched-event kernel for the single-queue spot/on-demand event loop,
// written by hand for Hopper (sm_90a).
//
// Replaces repro/kernels/sweep/sweep.py::batched_event_windows, the Pallas
// kernel behind the JAX package's impl="pallas" executor, for the
// single-queue loop (repro/core/engine.py::_engine_event) on the slab
// stream.  Its plain PyTorch version is ../ref.py; the ctypes wrapper is
// ../sweep.py.
//
// What bounds it: integer and FP32 instruction throughput, not bytes.  A
// lane-event costs about three threefry-2x32 columns (20 rounds of
// add/rotate/xor each) plus rmax-wide selects and three slot reductions; a
// lane reads a few words of state once and writes ten numbers per window.
// The TPU kernel read a pre-built (lanes, windows, events, columns) slab;
// at 4,096 lanes and 2^20 events that slab would be ~55 GB, so this kernel
// draws the slab's bits itself, from the same per-window keys, bitwise the
// slab the plain version builds.
//
// Design: one warp per lane, so that 4,096 lanes fill the card with 4,096
// warps.  Slot s lives on thread s % 32, in register s / 32 (SPT slots per
// thread).  Thread c draws slab column c of each event and shuffles it to
// the warp.  Slot reductions are __shfl_xor_sync butterflies over (value,
// index) pairs compared lexicographically, which reproduces argmin's
// first-index tie rule.  The window loop runs inside the kernel (the TPU
// grid's window axis): state stays in registers across windows, each window
// writes its ten sums and rebases the join order.  Built with --fmad=false
// so products and sums round as PyTorch's separate operations do; the two
// multiply-adds the JAX package's compiled samplers fuse (Uniform's
// low + u * width, the bathtub tail b - e * tau2) are explicit fmaf.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // lanes per block, one warp each
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 3e38f;  // the engine's INF ("never")
constexpr int kOrderMax = 2147483647;
constexpr int kNoSlot = 1 << 30;  // index of a slot past rmax

enum Arrival { kExponential = 0, kGamma = 1, kUniform = 2, kDeterministic = 3,
               kBathtub = 4 };
enum Policy { kThreePhase = 0, kSingleSlot = 1 };
enum Wait { kInfiniteWait = 0, kTwoPointWait = 1, kExponentialWait = 2,
            kDeterministicWait = 3 };

struct Args {
  // initial state, per lane (slot arrays are lanes x rmax)
  const float* next_job0;
  const float* next_spot0;
  const float* ages0;
  const float* budgets0;
  const uint8_t* occ0;
  const int32_t* order0;
  const int32_t* next_seq0;
  const int32_t* qlen0;
  const uint32_t* win_keys;  // lanes x windows x 2: each window's slab key
  const int32_t* plan;       // events per window
  const float* k_cost;       // per lane
  const float* pa;           // per lane: r, or the wait family's first param
  const float* pb;           // per lane: the wait family's second param
  // final state
  float* next_job;
  float* next_spot;
  float* ages;
  float* budgets;
  uint8_t* occ;
  int32_t* order;
  int32_t* next_seq;
  int32_t* qlen;
  int32_t* istats;  // 6 x lanes x windows
  float* fstats;    // 4 x lanes x windows
  int lanes, rmax, n_windows, n_cols;
  int job_code, spot_code, policy_code, wait_code;
  int job_col, spot_col, admit_col, job_n, spot_n;
  float job_c[4], spot_c[4];
};

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = (x1 << r) | (x1 >> (32 - r));
  x1 ^= x0;
}

// threefry2x32 of counter (0, c1) under key (k0, k1), k2 = k0 ^ k1 ^ C;
// returns x0 ^ x1, the word jax.random.bits keeps.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint32_t c1) {
  uint32_t x0 = k0, x1 = c1 + k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

__device__ __forceinline__ float u01(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// column c of this event's slab row, drawn by thread c
__device__ __forceinline__ float col(float u, int c) {
  return __shfl_sync(kFull, u, c);
}

__device__ __forceinline__ float exp_from_u(float u) { return -log1pf(-u); }

__device__ float sample_arrival(int code, const float* c, int n, float u,
                                int col0) {
  switch (code) {
    case kExponential:  // c[0] = float32 1 / rate
      return exp_from_u(col(u, col0)) * c[0];
    case kGamma: {  // sum of n unit exponentials, left to right
      float s = log1pf(-col(u, col0));
      for (int i = 1; i < n; ++i) s = s + log1pf(-col(u, col0 + i));
      return -s * c[0];
    }
    case kUniform:
      return fmaf(col(u, col0), c[1], c[0]);
    case kBathtub: {
      const float u0 = col(u, col0), u1 = col(u, col0 + 1);
      const float u2 = col(u, col0 + 2);
      const float head = fminf(exp_from_u(u1) * c[1], c[3]);
      const float tail = fmaxf(fmaf(-exp_from_u(u2), c[2], c[3]), 0.f);
      return u0 < c[0] ? head : tail;
    }
    default:  // kDeterministic
      return c[0];
  }
}

__device__ float sample_wait(int code, float pa, float pb, float u, int col0) {
  switch (code) {
    case kTwoPointWait:
      return col(u, col0) < pa ? pb : 0.f;
    case kExponentialWait:
      return exp_from_u(col(u, col0)) / pa;
    case kDeterministicWait:
      return pa;
    default:  // kInfiniteWait
      return kInf;
  }
}

template <typename T>
__device__ __forceinline__ void lexmin(T& v, int& i, T ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <typename T>
__device__ __forceinline__ void warp_argmin(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    lexmin(v, i, ov, oi);
  }
}

// value of slot s (s < rmax), from the thread that holds it
template <int SPT>
__device__ __forceinline__ float slot_value(const float (&x)[SPT], int s) {
  float v = x[0];
#pragma unroll
  for (int j = 1; j < SPT; ++j)
    if ((s >> 5) == j) v = x[j];
  return __shfl_sync(kFull, v, s & 31);
}

template <int SPT>
__global__ void __launch_bounds__(kWarps * 32) sweep_kernel(const Args a) {
  const int t = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (lane >= a.lanes) return;  // the whole warp leaves together
  const int R = a.rmax, W = a.n_windows, L = a.lanes;
  const float kc = a.k_cost[lane], pa = a.pa[lane], pb = a.pb[lane];

  float nj = a.next_job0[lane], ns = a.next_spot0[lane];
  int next_seq = a.next_seq0[lane], qlen = a.qlen0[lane];
  float ages[SPT], budgets[SPT];
  bool occ[SPT];
  int order[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int s = t + 32 * j;
    ages[j] = 0.f;
    budgets[j] = kInf;
    occ[j] = false;
    order[j] = 0;
    if (s < R) {
      const size_t o = static_cast<size_t>(lane) * R + s;
      ages[j] = a.ages0[o];
      budgets[j] = a.budgets0[o];
      occ[j] = a.occ0[o] != 0;
      order[j] = a.order0[o];
    }
  }

  for (int w = 0; w < W; ++w) {
    const size_t kw = (static_cast<size_t>(lane) * W + w) * 2;
    const uint32_t k0 = a.win_keys[kw], k1 = a.win_keys[kw + 1];
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    const int n_ev = a.plan[w];
    int jobs_arrived = 0, jobs_completed = 0, spot_served = 0, ondemand = 0;
    int spot_arrivals = 0, spot_found_empty = 0;
    float cost_sum = 0.f, delay_sum = 0.f, time_elapsed = 0.f;
    float empty_time = 0.f;

    for (int e = 0; e < n_ev; ++e) {
      // thread t draws column t of this event's slab row
      const float u = u01(threefry_bits(
          k0, k1, k2, static_cast<uint32_t>(e) * a.n_cols + t));

      // pre-event slot reductions: deadline, first free, FIFO-oldest
      float dv = __int_as_float(0x7f800000);  // +inf: past every slot
      int di = kNoSlot, fv = 2, fi = kNoSlot, sv = kOrderMax, si = kNoSlot;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int s = t + 32 * j;
        if (s < R) {
          lexmin(dv, di, occ[j] ? budgets[j] : kInf, s);
          lexmin(fv, fi, occ[j] ? 1 : 0, s);
          lexmin(sv, si, occ[j] ? order[j] : kOrderMax, s);
        }
      }
      warp_argmin(dv, di);
      warp_argmin(fv, fi);
      warp_argmin(sv, si);
      const float deadline = dv;

      // ties resolve spot > deadline > job
      const float dt = fminf(fminf(nj, ns), deadline);
      const bool is_spot = ns <= fminf(nj, deadline);
      const bool is_deadline = !is_spot && deadline <= nj;
      const bool is_job = !is_spot && !is_deadline;

      bool admit_raw;
      float budget;
      if (a.policy_code == kThreePhase) {
        const float n_hat = floorf(pa), frac = pa - n_hat;
        const float qf = static_cast<float>(qlen);
        const float p = qf < n_hat ? 1.f : (qf == n_hat ? frac : 0.f);
        admit_raw = col(u, a.admit_col) < p;
        budget = kInf;
      } else {
        budget = sample_wait(a.wait_code, pa, pb, u, a.admit_col);
        admit_raw = qlen == 0 && budget > 0.f;
      }
      const bool admit = is_job && admit_raw && qlen < R;
      const bool od_now = is_job && !admit;
      const bool has_job = qlen > 0;
      const bool served = is_spot && has_job;
      const bool defected = is_deadline;
      const bool leave = served || defected;
      const int leave_slot = served ? si : di;

#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        ages[j] = ages[j] + dt;
        budgets[j] = occ[j] ? budgets[j] - dt : kInf;
      }
      const float wait_served = slot_value<SPT>(ages, si);
      const float age_defect = slot_value<SPT>(ages, di);
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int s = t + 32 * j;
        const bool join = admit && s == fi;
        if (join) {
          ages[j] = 0.f;
          budgets[j] = budget;
          order[j] = next_seq;
        }
        occ[j] = (occ[j] || join) && !(leave && s == leave_slot);
      }

      const float job_draw =
          sample_arrival(a.job_code, a.job_c, a.job_n, u, a.job_col);
      const float spot_draw =
          sample_arrival(a.spot_code, a.spot_c, a.spot_n, u, a.spot_col);

      jobs_arrived += is_job;
      jobs_completed += od_now || served || defected;
      spot_served += served;
      ondemand += od_now || defected;
      cost_sum = cost_sum + (served ? 1.f : 0.f);
      cost_sum = cost_sum + ((od_now || defected) ? kc : 0.f);
      delay_sum = delay_sum + (served ? wait_served : 0.f);
      delay_sum = delay_sum + (defected ? age_defect : 0.f);
      time_elapsed = time_elapsed + dt;
      empty_time = empty_time + (qlen == 0 ? dt : 0.f);  // pre-event qlen
      spot_arrivals += is_spot;
      spot_found_empty += is_spot && !has_job;

      nj = is_job ? job_draw : nj - dt;
      ns = is_spot ? spot_draw : ns - dt;
      next_seq += admit;
      qlen += static_cast<int>(admit) - static_cast<int>(leave);
    }

    if (t == 0) {
      const size_t o = static_cast<size_t>(lane) * W + w, n = size_t(L) * W;
      a.istats[0 * n + o] = jobs_arrived;
      a.istats[1 * n + o] = jobs_completed;
      a.istats[2 * n + o] = spot_served;
      a.istats[3 * n + o] = ondemand;
      a.istats[4 * n + o] = spot_arrivals;
      a.istats[5 * n + o] = spot_found_empty;
      a.fstats[0 * n + o] = cost_sum;
      a.fstats[1 * n + o] = delay_sum;
      a.fstats[2 * n + o] = time_elapsed;
      a.fstats[3 * n + o] = empty_time;
    }

    // order rebase: subtract the oldest occupied sequence (or next_seq)
    int base = kOrderMax;
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      if (t + 32 * j < R) base = min(base, occ[j] ? order[j] : next_seq);
    base = __reduce_min_sync(kFull, base);
#pragma unroll
    for (int j = 0; j < SPT; ++j) order[j] = occ[j] ? order[j] - base : 0;
    next_seq -= base;
  }

#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int s = t + 32 * j;
    if (s < R) {
      const size_t o = static_cast<size_t>(lane) * R + s;
      a.ages[o] = ages[j];
      a.budgets[o] = budgets[j];
      a.occ[o] = occ[j];
      a.order[o] = order[j];
    }
  }
  if (t == 0) {
    a.next_job[lane] = nj;
    a.next_spot[lane] = ns;
    a.next_seq[lane] = next_seq;
    a.qlen[lane] = qlen;
  }
}

}  // namespace

// ptrs: the 23 pointers of Args in order; icfg: lanes, rmax, n_windows,
// n_cols, job_code, spot_code, policy_code, wait_code, job_col, spot_col,
// admit_col, job_n, spot_n; fcfg: job_c[4], spot_c[4].  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int sweep_launch(const int64_t* ptrs, const int32_t* icfg,
                            const float* fcfg, void* stream) {
  Args a;
  a.next_job0 = reinterpret_cast<const float*>(ptrs[0]);
  a.next_spot0 = reinterpret_cast<const float*>(ptrs[1]);
  a.ages0 = reinterpret_cast<const float*>(ptrs[2]);
  a.budgets0 = reinterpret_cast<const float*>(ptrs[3]);
  a.occ0 = reinterpret_cast<const uint8_t*>(ptrs[4]);
  a.order0 = reinterpret_cast<const int32_t*>(ptrs[5]);
  a.next_seq0 = reinterpret_cast<const int32_t*>(ptrs[6]);
  a.qlen0 = reinterpret_cast<const int32_t*>(ptrs[7]);
  a.win_keys = reinterpret_cast<const uint32_t*>(ptrs[8]);
  a.plan = reinterpret_cast<const int32_t*>(ptrs[9]);
  a.k_cost = reinterpret_cast<const float*>(ptrs[10]);
  a.pa = reinterpret_cast<const float*>(ptrs[11]);
  a.pb = reinterpret_cast<const float*>(ptrs[12]);
  a.next_job = reinterpret_cast<float*>(ptrs[13]);
  a.next_spot = reinterpret_cast<float*>(ptrs[14]);
  a.ages = reinterpret_cast<float*>(ptrs[15]);
  a.budgets = reinterpret_cast<float*>(ptrs[16]);
  a.occ = reinterpret_cast<uint8_t*>(ptrs[17]);
  a.order = reinterpret_cast<int32_t*>(ptrs[18]);
  a.next_seq = reinterpret_cast<int32_t*>(ptrs[19]);
  a.qlen = reinterpret_cast<int32_t*>(ptrs[20]);
  a.istats = reinterpret_cast<int32_t*>(ptrs[21]);
  a.fstats = reinterpret_cast<float*>(ptrs[22]);
  a.lanes = icfg[0];
  a.rmax = icfg[1];
  a.n_windows = icfg[2];
  a.n_cols = icfg[3];
  a.job_code = icfg[4];
  a.spot_code = icfg[5];
  a.policy_code = icfg[6];
  a.wait_code = icfg[7];
  a.job_col = icfg[8];
  a.spot_col = icfg[9];
  a.admit_col = icfg[10];
  a.job_n = icfg[11];
  a.spot_n = icfg[12];
  for (int i = 0; i < 4; ++i) {
    a.job_c[i] = fcfg[i];
    a.spot_c[i] = fcfg[4 + i];
  }
  const dim3 grid((a.lanes + kWarps - 1) / kWarps), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int spt = (a.rmax + 31) / 32;
  if (spt <= 1)
    sweep_kernel<1><<<grid, block, 0, s>>>(a);
  else if (spt <= 2)
    sweep_kernel<2><<<grid, block, 0, s>>>(a);
  else if (spt <= 8)
    sweep_kernel<8><<<grid, block, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
