// Batched-event kernels for the spot/on-demand event loops, written by
// hand for Hopper (sm_90a): sweep_kernel runs the single queue,
// market_kernel (below) the P-pool spot market, region_kernel (last)
// N-region routing.
//
// Replaces repro/kernels/sweep/sweep.py::batched_event_windows, the Pallas
// kernel behind the JAX package's impl="pallas" executor, for three of the
// event bodies it runs on the slab stream, and for the single queue's and
// the market's on the split stream: the single queue
// (repro/core/engine.py::_engine_event), the market
// (repro/core/engine.py::_market_event) and the regions
// (repro/core/engine.py::_region_event).  Their plain PyTorch versions are
// in ../ref.py; the ctypes wrappers in ../sweep.py.
//
// What bounds it: integer and FP32 instruction issue, not bytes.  A
// lane-event costs n_cols threefry-2x32 columns (20 rounds of
// add/rotate/xor each), rmax-wide selects and three slot reductions; a lane
// reads a few words of state once and writes ten numbers per window.  The
// TPU kernel read a pre-built (lanes, windows, events, columns) slab; at
// 4,096 lanes and 2^20 events that slab would be ~55 GB, so this kernel
// draws the slab's bits itself, from the same per-window keys, bitwise the
// slab the plain version builds.
//
// Design: every issued instruction should be one the lane-event needs.
// - Lane groups.  A lane runs on G threads (a template parameter; 32/G
//   lanes a warp), which the wrapper picks from rmax (sweep.py::group_size:
//   G 4 up to rmax 32, then 8 slots a thread on G 8, 16 or 32; only those
//   seven (G, SPT) pairs are built).  Slot s lives on thread s / SPT of
//   the group, in register s % SPT (SPT = slots a thread, a power of
//   two).  Slots at or past rmax are held as free slots with budget kInf:
//   they lie past every real slot, so argmin's first-index rule never
//   picks them while a real slot ties (and a join needs a free real
//   slot).
// - Draw ahead.  The group's threads draw the slab words of the lane's next
//   E = kDraws / n_cols events in one pass, thread t taking words t, t + G,
//   ..., four threefry chains at a time for ILP, and stage them in shared
//   memory as float32, where every thread of the group reads its event's
//   columns by broadcast.  The counters stay e * n_cols + c, so the bits
//   are those of the plain version's slab.  A second pass turns the rows
//   into each event's job clock, spot clock and wait budget, which depend
//   on the slab alone, events spread over the threads and interleaved,
//   so that the event loop's serial chain holds no sampler.  Every lane
//   runs the same window plan, so the passes are warp-uniform; a pass never
//   crosses a window and masks the window's ragged end.
// - Slot reductions on Hopper's warp primitives: the smallest budget
//   (non-negative floats and kInf, whose bit patterns order as int32) and
//   the FIFO-oldest join order as int32 minima, by __reduce_min_sync
//   (redux) where the group is the warp and by an xor butterfly of
//   shuffles within the group otherwise (redux leaves one value a warp, so
//   a mask a group runs it once for each group); the first slot holding
//   that minimum by a ballot of equality (the lowest thread that holds one,
//   then its lowest register); the first free slot by a ballot of each
//   thread's free bits and __ffs.  Occupancy is a bit mask a thread.
// - The per-event logic runs on every thread of the group (it is scalar);
//   the window loop runs inside the kernel (the TPU grid's window axis):
//   state stays in registers across windows, each window writes its ten
//   sums and rebases the join order.
// Built with --fmad=false so products and sums round as PyTorch's separate
// operations do; the two multiply-adds the JAX package's compiled samplers
// fuse (Uniform's low + u * width, the bathtub tail b - e * tau2) are
// explicit fmaf.
//
// The split stream (rng="split", the JAX package's default; the single
// queue here, the market below) is a run-time flag of sweep_kernel,
// warp-uniform, so it adds no instantiation: it changes what a pass
// stages, never the event chain.  On
// the split stream event e's key k_e gives split(k_e, 4), four
// threefry-2x32 hashes of counters (0, 0..3): subkey 0 is k_{e+1}, and the
// job, spot and policy draws each take one jax.random.bits word of their
// subkey (a bathtub draw splits its subkey three ways first), with
// jax.random.uniform's 23-bit conversion.  The ladder k_e -> k_{e+1} is a
// serial chain of one hash an event a lane: every thread of the group
// walks it (no thread could share it), and the thread that samples event
// e stages k_e in the lane's slab words; then the G threads hash the
// subkeys and draw for their events, U at a time, as the slab's sample
// pass does, and stage the same three samples (the policy's admission
// uniform, or the wait budget, third).  The lane key lives in registers
// across windows (the windows do not touch it) and is written at the end.
//
// Telemetry (the telemetry= axis, repro/obs/stats.py::telemetry_update,
// called from each of the three JAX event bodies) is a template flag TEL
// of the three kernels: with it, each event is also folded into a lane's
// quantile sketches, event counters and optional trace ring (see "The
// telemetry fold" below).  This source is built twice: without
// SWEEP_TELEMETRY the library holds the TEL=false instantiations, the
// kernels as they run without the axis; with it, the TEL=true ones.  So
// telemetry=None launches code that does not hold the fold, and the two
// builds run side by side.
//
// The environment timeline (the env= axis, repro/core/env.py, threaded
// through each of the three JAX event bodies) is a second template flag,
// ENV, with its own define, SWEEP_ENV: so the source builds four ways (no
// flag, TEL, ENV, TEL and ENV) and env=None launches code without it.  See
// "The environment timeline" below.
//
// The work structure (the work= axis, repro/core/work.py and
// repro/obs/survival.py, threaded through each of the three JAX event
// bodies) is a third template flag, WORK, with its own define, SWEEP_WORK:
// the source builds eight ways, and work=None launches code without it.
// See "The work structure" below.
#include <cstdint>
#include <cuda_runtime.h>

#ifdef SWEEP_TELEMETRY
constexpr bool kTel = true;
#else
constexpr bool kTel = false;
#endif
#ifdef SWEEP_ENV
constexpr bool kEnv = true;
#else
constexpr bool kEnv = false;
#endif
#ifdef SWEEP_WORK
constexpr bool kWork = true;
#else
constexpr bool kWork = false;
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInf = 3e38f;  // the engine's INF ("never")
constexpr int kOrderMax = 2147483647;
// slab words a lane stages a pass; >= MAX_COLS, so a pass holds an event
constexpr int kDraws = 64;
// a lane's strides in shared memory, for its slab words and for its
// events' three samples (job clock, spot clock, wait budget): odd, so the
// lanes of a warp reading their rows fall in distinct banks
constexpr int kLaneStride = kDraws + 1;
constexpr int kSampleStride = 3 * kDraws + 1;
// events a split pass covers: their keys fill a lane's kDraws staging words
constexpr int kSplitPass = kDraws / 2;
constexpr uint32_t kParity = 0x1BD11BDAu;  // threefry's key-schedule constant

enum Arrival { kExponential = 0, kGamma = 1, kUniform = 2, kDeterministic = 3,
               kBathtub = 4 };
enum Policy { kThreePhase = 0, kSingleSlot = 1 };
// kFixedExponentialWait: an unswept exponential wait (either stream), a
// product with the float32 reciprocal of the rate (pa), as XLA compiles the
// JAX package's division by that constant
enum Wait { kInfiniteWait = 0, kTwoPointWait = 1, kExponentialWait = 2,
            kDeterministicWait = 3, kFixedExponentialWait = 4 };

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
                             // (the split stream: lanes x 1 x 2, lane keys)
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
  uint32_t* key_out;  // lanes x 2: the final lane keys (split stream only)
  int split;          // the stream: 0 the slab, 1 the split ladder
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

// threefry2x32 of counter (0, c1) under key (k0, k1), k2 = k0 ^ k1 ^ C:
// both output words (y0, y1), a subkey of jax.random.split
__device__ __forceinline__ void threefry_pair(uint32_t k0, uint32_t k1,
                                              uint32_t k2, uint32_t c1,
                                              uint32_t& y0, uint32_t& y1) {
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
  y0 = x0;
  y1 = x1;
}

// the same hash's x0 ^ x1, the word jax.random.bits keeps
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint32_t c1) {
  uint32_t x0, x1;
  threefry_pair(k0, k1, k2, c1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float u01(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

__device__ __forceinline__ float exp_from_u(float u) { return -log1pf(-u); }

// U events' draws of an arrival process: event i's columns start at
// u[off[i] + col]; the switch is outside the unrolled loops, so the U
// events' chains interleave
template <int U>
__device__ __forceinline__ void sample_arrivals(int code, const float* c,
                                                int n, const float* u,
                                                const int (&off)[U], int col,
                                                float (&out)[U]) {
  switch (code) {
    case kExponential:  // c[0] = float32 1 / rate
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = exp_from_u(u[off[i] + col]) * c[0];
      break;
    case kGamma: {  // sum of n unit exponentials, left to right
      float acc[U];
#pragma unroll
      for (int i = 0; i < U; ++i) acc[i] = log1pf(-u[off[i] + col]);
      for (int k = 1; k < n; ++k) {
#pragma unroll
        for (int i = 0; i < U; ++i)
          acc[i] = acc[i] + log1pf(-u[off[i] + col + k]);
      }
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = -acc[i] * c[0];
      break;
    }
    case kUniform:
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = fmaf(u[off[i] + col], c[1], c[0]);
      break;
    case kBathtub:
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const float* x = u + off[i] + col;
        const float head = fminf(exp_from_u(x[1]) * c[1], c[3]);
        const float tail = fmaxf(fmaf(-exp_from_u(x[2]), c[2], c[3]), 0.f);
        out[i] = x[0] < c[0] ? head : tail;
      }
      break;
    default:  // kDeterministic
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = c[0];
  }
}

// U events' wait budgets of the single-slot policy, as sample_arrivals
template <int U>
__device__ __forceinline__ void sample_waits(int code, float pa, float pb,
                                             const float* u,
                                             const int (&off)[U], int col,
                                             float (&out)[U]) {
  switch (code) {
    case kTwoPointWait:
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = u[off[i] + col] < pa ? pb : 0.f;
      break;
    case kExponentialWait:
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = exp_from_u(u[off[i] + col]) / pa;
      break;
    case kFixedExponentialWait:
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = exp_from_u(u[off[i] + col]) * pa;
      break;
    case kDeterministicWait:
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = pa;
      break;
    default:  // kInfiniteWait
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = kInf;
  }
}

// The G threads of a lane within their warp: the first thread's position
// in the warp and this thread's index t.  Every lane of a warp runs the
// same instructions, so the votes and shuffles take the whole warp's mask
// (a mask a group would make the warp run them once for each group), and
// the group's min takes redux only where the group is the warp: redux
// leaves one value a warp.
template <int G> struct LaneGroup {
  int shift, t;
  __device__ __forceinline__ explicit LaneGroup(int warp_thread)
      : shift(warp_thread & ~(G - 1)), t(warp_thread & (G - 1)) {}
  // smallest v over the group
  __device__ __forceinline__ int reduce_min(int v) const {
    if constexpr (G == 32) {
      return __reduce_min_sync(kFull, v);
    } else {
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        v = min(v, __shfl_xor_sync(kFull, v, o, G));
      return v;
    }
  }
  // the lowest thread whose pred holds (G where none does)
  __device__ __forceinline__ int first(bool pred) const {
    const unsigned b =
        (__ballot_sync(kFull, pred) >> shift) & (kFull >> (32 - G));
    return b ? __ffs(b) - 1 : G;
  }
  // v of thread src
  template <typename T>
  __device__ __forceinline__ T from(T v, int src) const {
    return __shfl_sync(kFull, v, src, G);
  }
};

// slot index (thread * SPT + register) of the first slot whose key equals
// the group minimum `m`; `keys` are this thread's keys
template <int G, int SPT>
__device__ __forceinline__ int first_equal(const LaneGroup<G>& grp,
                                           const int (&keys)[SPT], int m) {
  int j = SPT;
#pragma unroll
  for (int i = SPT - 1; i >= 0; --i)
    if (keys[i] == m) j = i;
  const int owner = grp.first(j < SPT);
  return owner * SPT + grp.from(j, owner & (G - 1));
}

// this thread's value of register (s % SPT) of slot s, from its owner
template <int G, int SPT, typename T>
__device__ __forceinline__ T slot_value(const LaneGroup<G>& grp,
                                        const T (&x)[SPT], int s) {
  const int j = s & (SPT - 1);
  T v = x[0];
#pragma unroll
  for (int i = 1; i < SPT; ++i)
    if (j == i) v = x[i];
  return grp.from(v, s / SPT);
}

// the window-end order rebase: subtract the oldest occupied join sequence
// (or next_seq where the queue is empty) from every occupied slot's
template <int G, int SPT>
__device__ __forceinline__ void rebase_order(const LaneGroup<G>& grp,
                                             unsigned occ, int (&order)[SPT],
                                             int& next_seq, int s0, int R) {
  int base = kOrderMax;
#pragma unroll
  for (int j = 0; j < SPT; ++j)
    if (s0 + j < R) base = min(base, (occ >> j) & 1u ? order[j] : next_seq);
  base = grp.reduce_min(base);
#pragma unroll
  for (int j = 0; j < SPT; ++j) order[j] = (occ >> j) & 1u ? order[j] - base : 0;
  next_seq -= base;
}

// the samples of the pass's n events, from their slab rows in u_s (nc
// words each): job clock, spot clock and the single-slot policy's wait
// budget, three floats an event in x_s.  Thread t takes events t, t + G,
// ..., U at a time; an event past n repeats the last one and is not stored.
template <int G>
__device__ __forceinline__ void sample_pass(float* x_s, const float* u_s,
                                            int n, int nc, const Args& a,
                                            float pa, float pb, int t) {
  constexpr int U = G >= 16 ? 1 : (G >= 8 ? 2 : 4);
  for (int e0 = t; e0 < n; e0 += U * G) {
    int off[U];
#pragma unroll
    for (int i = 0; i < U; ++i) off[i] = min(e0 + i * G, n - 1) * nc;
    float job[U], spot[U], wait[U];
    sample_arrivals<U>(a.job_code, a.job_c, a.job_n, u_s, off, a.job_col,
                       job);
    sample_arrivals<U>(a.spot_code, a.spot_c, a.spot_n, u_s, off,
                       a.spot_col, spot);
    if (a.policy_code == kSingleSlot) {
      sample_waits<U>(a.wait_code, pa, pb, u_s, off, a.admit_col, wait);
    } else {
#pragma unroll
      for (int i = 0; i < U; ++i) wait[i] = kInf;
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int e = e0 + i * G;
      if (e < n) {
        x_s[3 * e] = job[i];
        x_s[3 * e + 1] = spot[i];
        x_s[3 * e + 2] = wait[i];
      }
    }
  }
}

// the slab words [c0, c0 + nd) of this lane's window, as float32 in u_s
template <int G>
__device__ __forceinline__ void draw_pass(float* u_s, int nd, uint32_t c0,
                                          uint32_t k0, uint32_t k1,
                                          uint32_t k2, int t) {
  constexpr int U = G >= 32 ? 2 : 4;  // independent chains in flight
  for (int i0 = t; i0 < nd; i0 += U * G) {
    uint32_t w[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      w[u] = threefry_bits(k0, k1, k2, c0 + static_cast<uint32_t>(i0 + u * G));
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * G < nd) u_s[i0 + u * G] = u01(w[u]);
  }
}

// ---------------------------------------------------------------------------
// The split stream (repro/core/clocks.py::split_event_keys and the keyed
// samplers; plain version repro_torch/core/engine.py::_engine_event with
// layout=None, run by ../ref.py with rng="split")
// ---------------------------------------------------------------------------
// jax.random.uniform's float32 on [0, 1): the top 23 bits under the
// exponent of 1.0, less 1
__device__ __forceinline__ float key_u01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3f800000u) - 1.f;
}

// the word jax.random.bits draws at shape () from key (k0, k1): counter 0
__device__ __forceinline__ uint32_t key_bits(uint32_t k0, uint32_t k1) {
  return threefry_bits(k0, k1, k0 ^ k1 ^ kParity, 0u);
}

// subkey i of jax.random.split(key, n)
__device__ __forceinline__ void subkey(uint32_t k0, uint32_t k1, uint32_t i,
                                       uint32_t& s0, uint32_t& s1) {
  threefry_pair(k0, k1, k0 ^ k1 ^ kParity, i, s0, s1);
}

// U events' keyed draws of an arrival process (ArrivalProcess.sample), the
// event i's subkey (k0[i], k1[i]); c as sample_arrivals reads it, with
// Uniform's float32 width high - low in c[2]
template <int U>
__device__ __forceinline__ void keyed_arrivals(int code, const float* c,
                                               const uint32_t (&k0)[U],
                                               const uint32_t (&k1)[U],
                                               float (&out)[U]) {
  switch (code) {
    case kExponential:  // c[0] = float32 1 / rate
#pragma unroll
      for (int i = 0; i < U; ++i)
        out[i] = exp_from_u(key_u01(key_bits(k0[i], k1[i]))) * c[0];
      break;
    case kUniform:  // max(low, u * (high - low) + low), one rounding
#pragma unroll
      for (int i = 0; i < U; ++i)
        out[i] = fmaxf(c[0], fmaf(key_u01(key_bits(k0[i], k1[i])), c[2],
                                  c[0]));
      break;
    case kBathtub:  // split(key, 3): the pick's uniform, two exponentials
#pragma unroll
      for (int i = 0; i < U; ++i) {
        uint32_t a0, a1, b0, b1, d0, d1;
        subkey(k0[i], k1[i], 0u, a0, a1);
        subkey(k0[i], k1[i], 1u, b0, b1);
        subkey(k0[i], k1[i], 2u, d0, d1);
        const float pick = key_u01(key_bits(a0, a1));
        const float head =
            fminf(exp_from_u(key_u01(key_bits(b0, b1))) * c[1], c[3]);
        const float tail = fmaxf(
            fmaf(-exp_from_u(key_u01(key_bits(d0, d1))), c[2], c[3]), 0.f);
        out[i] = pick < c[0] ? head : tail;
      }
      break;
    default:  // kDeterministic (Gamma is refused by the wrapper)
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = c[0];
  }
}

// U events' keyed wait budgets of the single-slot policy
// (WaitTime.sample_from), as keyed_arrivals
template <int U>
__device__ __forceinline__ void keyed_waits(int code, float pa, float pb,
                                            const uint32_t (&k0)[U],
                                            const uint32_t (&k1)[U],
                                            float (&out)[U]) {
  switch (code) {
    case kTwoPointWait:
#pragma unroll
      for (int i = 0; i < U; ++i)
        out[i] = key_u01(key_bits(k0[i], k1[i])) < pa ? pb : 0.f;
      break;
    case kExponentialWait:
#pragma unroll
      for (int i = 0; i < U; ++i)
        out[i] = exp_from_u(key_u01(key_bits(k0[i], k1[i]))) / pa;
      break;
    case kFixedExponentialWait:
#pragma unroll
      for (int i = 0; i < U; ++i)
        out[i] = exp_from_u(key_u01(key_bits(k0[i], k1[i]))) * pa;
      break;
    case kDeterministicWait:
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = pa;
      break;
    default:  // kInfiniteWait
#pragma unroll
      for (int i = 0; i < U; ++i) out[i] = kInf;
  }
}

// The ladder over the lane's next n events, from the lane key (lk0, lk1),
// which it leaves n events down the ladder: event e's key k_e gives
// k_{e+1} as subkey 0 of its split (the same hash whatever the split's
// width: subkey i hashes counter (0, i)).  Every thread of the group walks
// it (no thread could share the serial chain); event e's key is staged in
// k_s by thread e % G, which draws that event.
template <int G>
__device__ __forceinline__ void walk_ladder(uint32_t* k_s, int n,
                                            uint32_t& lk0, uint32_t& lk1,
                                            int t) {
  for (int e = 0; e < n; ++e) {
    if ((e & (G - 1)) == t) {
      k_s[2 * e] = lk0;
      k_s[2 * e + 1] = lk1;
    }
    uint32_t n0, n1;
    subkey(lk0, lk1, 0u, n0, n1);
    lk0 = n0;
    lk1 = n1;
  }
  __syncwarp();  // an event past n reads the last event's key
}

// The split stream's pass over the lane's next n events (n <= kSplitPass):
// the ladder, then thread t hashes the subkeys of events t, t + G, ..., U
// at a time, draws them and stages job clock, spot clock and the policy's
// draw (three-phase: the admission uniform; single slot: the wait budget)
// in x_s, three floats an event as sample_pass does.  A process that draws
// nothing hashes no subkey.
template <int G>
__device__ __forceinline__ void split_pass(float* x_s, uint32_t* k_s, int n,
                                           const Args& a, float pa, float pb,
                                           uint32_t& lk0, uint32_t& lk1,
                                           int t) {
  walk_ladder<G>(k_s, n, lk0, lk1, t);
  const bool job_keyed = a.job_code != kDeterministic;
  const bool spot_keyed = a.spot_code != kDeterministic;
  const bool pol_keyed =
      a.policy_code == kThreePhase ||
      (a.wait_code != kInfiniteWait && a.wait_code != kDeterministicWait);
  constexpr int U = G >= 16 ? 1 : (G >= 8 ? 2 : 4);
  for (int e0 = t; e0 < n; e0 += U * G) {
    uint32_t j0[U], j1[U], s0[U], s1[U], p0[U], p1[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int e = min(e0 + i * G, n - 1);
      const uint32_t k0 = k_s[2 * e], k1 = k_s[2 * e + 1];
      j0[i] = j1[i] = s0[i] = s1[i] = p0[i] = p1[i] = 0u;
      if (job_keyed) subkey(k0, k1, 1u, j0[i], j1[i]);
      if (spot_keyed) subkey(k0, k1, 2u, s0[i], s1[i]);
      if (pol_keyed) subkey(k0, k1, 3u, p0[i], p1[i]);
    }
    float job[U], spot[U], pol[U];
    keyed_arrivals<U>(a.job_code, a.job_c, j0, j1, job);
    keyed_arrivals<U>(a.spot_code, a.spot_c, s0, s1, spot);
    if (a.policy_code == kThreePhase) {
#pragma unroll
      for (int i = 0; i < U; ++i) pol[i] = key_u01(key_bits(p0[i], p1[i]));
    } else {
      keyed_waits<U>(a.wait_code, pa, pb, p0, p1, pol);
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int e = e0 + i * G;
      if (e < n) {
        x_s[3 * e] = job[i];
        x_s[3 * e + 1] = spot[i];
        x_s[3 * e + 2] = pol[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The telemetry fold (repro/obs/stats.py::telemetry_update; plain version
// repro_torch/obs/stats.py::telemetry_update, run by ../ref.py with tel=)
// ---------------------------------------------------------------------------
// The lane's group already agrees on each event: its type, the served,
// defected or revoked slot and its wait, the cost paid.  The counters
// (events by type, five more, the ring's true count) live in registers,
// the same on every thread of the group, as the base sums do.  What needs
// an index the event picks lives in the lane's slice of shared memory
// (int32): the wait and cost histograms (n_bins each) and the defects and
// resumes a location (kMaxLocs each, added by the group's first thread,
// the leader, with an atomicAdd on the rare event that has one).  The
// bins stay off the event chain, whose latency bounds the kernel: the
// leader stages each event's (t, wait or -1, cost or -1, type | loc << 2
// | qlen << 5) in the slice, and after the pass's events the G threads
// bin the staged events together (thread t takes events t, t + G, ...),
// by atomicAdds, and write the trace ring's records (cap > 0, a run-time
// branch; slot n % cap of the (lanes, windows, cap) outputs, only the
// records no later event of the pass overwrites, only for a lane of the
// fleet).  At the window's end the G threads write the histograms and
// location counts to the (lanes, windows, ...) outputs, neighbouring
// threads on neighbouring words, the leader the counters, and all start
// again from zero.  A bin is the JAX package's: floor((logf(max(x,
// 1e-30)) - log lo) * inv) + 1, clamped, with the host's float32 log lo
// and inv, logf (not __logf) and no contraction (--fmad=false), so the
// kernel and the plain version bin alike.
constexpr int kMaxBins = 256;
constexpr int kMaxLocs = 8;
enum EventType { kEvJob = 0, kEvSpot = 1, kEvPreempt = 2, kEvDeadline = 3 };

struct TelArgs {
  int32_t* wait_hist;    // lanes x windows x n_bins
  int32_t* cost_hist;    // lanes x windows x n_bins
  int32_t* events;       // lanes x windows x 4
  int32_t* counters;     // 5 x lanes x windows: spot_starts, preempts_fired,
                         // notices_honored, deadline_defects, rejects
  int32_t* loc_defects;  // lanes x windows x n_locs
  int32_t* loc_resumed;  // lanes x windows x n_locs
  float* ring_t;         // lanes x windows x cap (cap > 0): time after
  int32_t* ring_type;
  int32_t* ring_loc;
  int32_t* ring_qlen;
  float* ring_val;       // the wait sample, -1 where the event has none
  int32_t* ring_n;       // lanes x windows (cap > 0)
  int n_bins, n_locs, cap;
  float wait_log_lo, wait_inv, cost_log_lo, cost_inv;
};

// int32 words of a lane's slice: the two histograms, the two location
// counts (together the accumulators, 2 n_bins + 2 kMaxLocs), then four a
// staged event for the `pass` events a pass holds at most; odd, so the
// lanes of a warp spread over the banks
__host__ __device__ __forceinline__ int tel_stride(int n_bins, int pass) {
  return (2 * n_bins + 2 * kMaxLocs + 4 * pass) | 1;
}

__device__ __forceinline__ int hist_bin(float x, float log_lo, float inv,
                                        int n_bins) {
  const float raw = (logf(fmaxf(x, 1e-30f)) - log_lo) * inv;
  const int idx = static_cast<int>(floorf(raw)) + 1;
  return min(max(idx, 0), n_bins - 1);
}

// what one merged event gives the fold (the same on every thread)
struct TelEvent {
  int type, loc, qlen;
  bool served, preempt, resume, defected, rejected, wait_valid, cost_valid;
  float t, wait, cost;
};

// a window's counters, in registers (the same on every thread of a group)
struct TelCounts {
  int events[4] = {0, 0, 0, 0};
  int served = 0, preempt = 0, resume = 0, defected = 0, rejected = 0;
  int n = 0;  // events, the ring's true count
};

// fold event `e` of the pass: every thread counts it; the leader adds its
// location counts and stages the rest in the lane's slice `ts`
__device__ __forceinline__ void tel_fold(const TelArgs& tl, int* ts, int e,
                                         TelCounts& c, const TelEvent& ev,
                                         bool leader) {
  const int nb = tl.n_bins;
  if (leader) {
    if (ev.defected) atomicAdd(ts + 2 * nb + ev.loc, 1);
    if (ev.resume) atomicAdd(ts + 2 * nb + kMaxLocs + ev.loc, 1);
    float* r = reinterpret_cast<float*>(ts + 2 * nb + 2 * kMaxLocs) + 4 * e;
    r[0] = ev.t;
    r[1] = ev.wait_valid ? ev.wait : -1.f;
    r[2] = ev.cost_valid ? ev.cost : -1.f;
    r[3] = __int_as_float(ev.type | ev.loc << 2 | ev.qlen << 5);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c.events[i] += ev.type == i;
  c.served += ev.served;
  c.preempt += ev.preempt;
  c.resume += ev.resume;
  c.defected += ev.defected;
  c.rejected += ev.rejected;
  c.n += 1;
}

// after a pass of n events that began at event e0 of the window: the G
// threads bin the staged events and write the ring's records; `ring` is
// the offset of the lane's window in the ring outputs
template <int G>
__device__ __forceinline__ void tel_pass(const TelArgs& tl, int* ts, int n,
                                         int e0, size_t ring, int t,
                                         bool live) {
  const int nb = tl.n_bins;
  const float* stage =
      reinterpret_cast<const float*>(ts + 2 * nb + 2 * kMaxLocs);
  __syncwarp();  // the leader's staged events are visible
  for (int e = t; e < n; e += G) {
    const float* r = stage + 4 * e;
    const float wait = r[1], cost = r[2];
    if (wait >= 0.f)
      atomicAdd(ts + hist_bin(wait, tl.wait_log_lo, tl.wait_inv, nb), 1);
    if (cost >= 0.f)
      atomicAdd(ts + nb + hist_bin(cost, tl.cost_log_lo, tl.cost_inv, nb),
                1);
    // a record survives the pass where no later event of it takes its slot
    if (tl.cap > 0 && live && e + tl.cap >= n) {
      const int packed = __float_as_int(r[3]);
      const size_t o = ring + (e0 + e) % tl.cap;
      tl.ring_t[o] = r[0];
      tl.ring_type[o] = packed & 3;
      tl.ring_loc[o] = (packed >> 2) & 7;
      tl.ring_qlen[o] = packed >> 5;
      tl.ring_val[o] = wait;
    }
  }
}

// the lane's slice, after `before` floats of the block's shared memory,
// its accumulators zeroed (the next __syncwarp makes the zeros visible)
template <int G>
__device__ __forceinline__ int* tel_slice(float* smem, int before,
                                          int lane_in_block, int n_bins,
                                          int pass, int t) {
  int* ts = reinterpret_cast<int*>(smem + before) +
            lane_in_block * tel_stride(n_bins, pass);
  for (int i = t; i < 2 * n_bins + 2 * kMaxLocs; i += G) ts[i] = 0;
  return ts;
}

// the window's end: the G threads write the lane's accumulators and the
// leader its counters to window `lw` (lane * windows + window) of the
// outputs (n_lw = lanes * windows); then all start again from zero
template <int G>
__device__ __forceinline__ void tel_flush(const TelArgs& tl, int* ts,
                                          TelCounts& c, size_t lw,
                                          size_t n_lw, int t, bool live) {
  const int nb = tl.n_bins, nl = tl.n_locs;
  __syncwarp();  // the last pass's bins are in
  if (live) {
    for (int i = t; i < nb; i += G) {
      tl.wait_hist[lw * nb + i] = ts[i];
      tl.cost_hist[lw * nb + i] = ts[nb + i];
    }
    for (int i = t; i < nl; i += G) {
      tl.loc_defects[lw * nl + i] = ts[2 * nb + i];
      tl.loc_resumed[lw * nl + i] = ts[2 * nb + kMaxLocs + i];
    }
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) tl.events[lw * 4 + i] = c.events[i];
      tl.counters[0 * n_lw + lw] = c.served;
      tl.counters[1 * n_lw + lw] = c.preempt;
      tl.counters[2 * n_lw + lw] = c.resume;
      tl.counters[3 * n_lw + lw] = c.defected;
      tl.counters[4 * n_lw + lw] = c.rejected;
      if (tl.cap > 0) tl.ring_n[lw] = c.n;
    }
  }
  __syncwarp();  // every word is read before it is zeroed
  for (int i = t; i < 2 * nb + 2 * kMaxLocs; i += G) ts[i] = 0;
  c = TelCounts{};
}

// ---------------------------------------------------------------------------
// The environment timeline (repro/core/env.py and repro/obs/shocks.py;
// plain version repro_torch/core/engine.py's event bodies with ep=, run by
// ../ref.py)
// ---------------------------------------------------------------------------
// One table for every lane, in global memory (L2 holds it): the S segments'
// end times and kinds, and their per-location price, hazard and
// availability multipliers (S x n_locs).  A lane reads it only when it
// crosses a boundary.  Its cursor (the countdown to the next boundary and
// the segment) and what depends on the segment alone (effective prices,
// the hazards' running sums, 1/avail, the kernel's fixed choice, the alive
// pools or regions for PanicKernel) live in registers and in the lane's
// table in shared memory, recomputed once a crossing.  The boundary joins
// the event race as its first clock: a crossing is a divergent branch, the
// same on the G threads of a lane, whose shared-memory writes synchronize
// the group alone.  The sample pass runs ahead of the chain, so it keeps
// only what does not depend on the segment (the base draws, the unit
// exponential of the preemption clock); the chain scales them under the
// event's own segment, in the JAX body's order of operations.  The eight
// shock counters and two dwell times are held as the base sums are, on
// every thread of the group, and written with the window's other sums.
constexpr float kBlackoutScale = 1e15f;  // env.py BLACKOUT_SCALE
enum SegKind { kSegNormal = 0, kSegStorm = 1, kSegBlackout = 2,
               kSegSpike = 3 };

struct EnvArgs {
  const float* t_end;    // S
  const int32_t* kind;   // S
  const float* price;    // S x n_locs multipliers
  const float* hazard;   // S x n_locs
  const float* avail;    // S x n_locs
  const float* nb0;      // lanes: the countdown to the next boundary
  const int32_t* seg0;   // lanes: the segment
  float* nb;             // lanes: final countdown
  int32_t* seg;          // lanes: final segment
  int32_t* istats;       // 8 x lanes x windows: the shock counters
  float* fstats;         // 2 x lanes x windows: storm and blackout time
  int n_segments, n_locs;
  // PanicKernel: gate admissions on any location alive; fail a choice (a
  // pool, a route) over to the cheapest alive location; re-tag jobs queued
  // on a dead pool (market only)
  int panic_admit, panic_choice, drain;
};

__device__ __forceinline__ float inv_avail(float av) {
  return av > 0.f ? 1.f / av : kBlackoutScale;
}

// clock_rescale of two total hazards: old / new where both are positive
__device__ __forceinline__ float clock_rescale(float old_h, float new_h) {
  return old_h > 0.f && new_h > 0.f ? old_h / new_h : 1.f;
}

// a window's shock counters (the same on every thread of a group)
struct EnvCounts {
  int boundaries = 0, storms = 0, blackouts = 0, spikes = 0;
  int arrivals = 0, degraded = 0, served = 0, resumed = 0;
  float storm_time = 0.f, blackout_time = 0.f;
};

// the lane's cursor: its segment, that segment's kind and end time, and
// the countdown to its boundary
struct EnvCursor {
  int seg, kind;
  float t_end, nb;
};

// fold one event (env_update) and step the cursor over it; `kind_next`
// is read only on a crossing
__device__ __forceinline__ void env_fold(const EnvArgs& E, EnvCursor& c,
                                         EnvCounts& n, bool is_b, float dt,
                                         bool is_job, bool od_now,
                                         bool served, bool resumed) {
  const bool shock = c.kind != kSegNormal;
  n.arrivals += is_job && shock;
  n.degraded += od_now && shock;
  n.served += served && shock;
  n.resumed += resumed && shock;
  n.storm_time = n.storm_time + (c.kind == kSegStorm ? dt : 0.f);
  n.blackout_time = n.blackout_time + (c.kind == kSegBlackout ? dt : 0.f);
  if (is_b) {
    const int s1 = c.seg + 1;
    const int k1 = E.kind[s1];
    const float t1 = E.t_end[s1];
    n.boundaries += 1;
    n.storms += k1 == kSegStorm;
    n.blackouts += k1 == kSegBlackout;
    n.spikes += k1 == kSegSpike;
    c.nb = t1 - c.t_end;
    c.seg = s1;
    c.kind = k1;
    c.t_end = t1;
  } else {
    c.nb = c.nb - dt;
  }
}

__device__ __forceinline__ EnvCursor env_cursor(const EnvArgs& E, int lane) {
  EnvCursor c;
  c.seg = E.seg0[lane];
  c.kind = E.kind[c.seg];
  c.t_end = E.t_end[c.seg];
  c.nb = E.nb0[lane];
  return c;
}

// window `o` (lane * windows + window) of the shock outputs (n = lanes *
// windows); the group's first thread writes; then the counts start again
__device__ __forceinline__ void env_flush(const EnvArgs& E, EnvCounts& n,
                                          size_t o, size_t nw, bool write) {
  if (write) {
    E.istats[0 * nw + o] = n.boundaries;
    E.istats[1 * nw + o] = n.storms;
    E.istats[2 * nw + o] = n.blackouts;
    E.istats[3 * nw + o] = n.spikes;
    E.istats[4 * nw + o] = n.arrivals;
    E.istats[5 * nw + o] = n.degraded;
    E.istats[6 * nw + o] = n.served;
    E.istats[7 * nw + o] = n.resumed;
    E.fstats[0 * nw + o] = n.storm_time;
    E.fstats[1 * nw + o] = n.blackout_time;
  }
  n = EnvCounts{};
}

// ---------------------------------------------------------------------------
// The work structure (repro/core/work.py and repro/obs/survival.py; plain
// version repro_torch/core/engine.py's event bodies with work=, run by
// ../ref.py)
// ---------------------------------------------------------------------------
// A slot's work state is four floats: progress, restart-overhead debt, the
// checkpointed progress and the life since admission.  Only life changes at
// every slot on every event (life + dt, reset at a join), so it lives in
// registers beside the ages; in the single queue it is the ages themselves
// (both start at zero, gain dt at every slot on every event and reset at a
// join only: the wrapper checks that the initial states agree).  Progress,
// debt and checkpoint change only at the event's served, revoked or joining
// slot, so they live in the lane's slice of shared memory (slot t * SPT + j
// at j * G + t, so that the G threads' own slots are neighbouring words),
// where every thread of the group reads the event's slots by broadcast and
// every thread writes a changed slot, the same value (the group agrees on
// the event, so no sync is needed).  The work model's seven floats, the
// checkpoint mode and the safety net are run constants: uniform branches.
// With the safety net (CantBeLateKernel) each occupied slot's panic clock,
// max(deadline - life - (oh + max(total - prog, 0)) * od_time - buffer, 0),
// joins its budget in the deadline race, in the same pass over the slots,
// and a bit a slot marks where it won.  The ledger's six counters and four
// sums are held as the base sums are, on every thread of the group, and
// written with the window's other sums.
enum CkptMode { kCkptNever = 0, kCkptNotice = 1, kCkptPeriodic = 2 };

struct WorkArgs {
  const float* prog0;  // lanes x slots: the initial work state
  const float* oh0;
  const float* ckpt0;
  const float* life0;
  float* prog;         // lanes x slots: the final work state
  float* oh;
  float* ckpt;
  float* life;
  int32_t* istats;     // 6 x lanes x windows: admitted, finished, misses,
                       // ontime, checkpoints, panics
  float* fstats;       // 4 x lanes x windows: work done, lost, recomputed,
                       // overhead paid
  int mode, safety;
  float total, overhead, ckpt_time, period, ckpt_cost, deadline, od_time,
      buffer;
};

// floats of a lane's work slice: progress, debt and checkpoint of its
// `slots` (G * SPT) slots; odd, so the lanes of a warp spread over the banks
__host__ __device__ __forceinline__ int work_stride(int slots) {
  return 3 * slots + 1;
}

// where slot s's progress lies in the slice (debt and checkpoint follow
// at + G * SPT and + 2 G * SPT)
template <int G, int SPT>
__device__ __forceinline__ int work_index(int s) {
  return (s & (SPT - 1)) * G + s / SPT;
}

// a window's ledger (the same on every thread of a group)
struct WorkCounts {
  int admitted = 0, finished = 0, misses = 0, ontime = 0, checkpoints = 0;
  int panics = 0;
  float done = 0.f, lost = 0.f, recomputed = 0.f, overhead = 0.f;
};

// a slot's panic clock under the safety net: its slack, clamped at 0
__device__ __forceinline__ float panic_clock(const WorkArgs& W, float life,
                                             float prog, float oh) {
  const float rem = oh + fmaxf(W.total - prog, 0.f);
  const float slack = W.deadline - life - rem * W.od_time - W.buffer;
  return slack > 0.f ? slack : 0.f;
}

// a serve's unit of work on a slot's (prog, oh, ckpt): debt first, the rest
// into progress, a periodic checkpoint where one falls due; `complete`
// where the slot's remaining total clears
struct WorkServe {
  float prog, oh, ckpt, done;
  bool complete, taken;
};

__device__ __forceinline__ WorkServe work_serve(const WorkArgs& W,
                                                bool served, float prog,
                                                float oh, float ckpt) {
  WorkServe r;
  const float rem = oh + (W.total - prog);
  r.oh = fmaxf(oh - 1.f, 0.f);
  r.prog = fminf(prog + fmaxf(1.f - oh, 0.f), W.total);
  r.done = served ? r.prog - prog : 0.f;
  r.ckpt = ckpt;
  r.taken = W.mode == kCkptPeriodic && served && rem > 1.f &&
            r.prog - ckpt >= W.period;
  if (r.taken) {
    r.ckpt = r.prog;
    r.oh = r.oh + W.ckpt_cost;
  }
  r.complete = served && rem <= 1.f;
  return r;
}

// write slot index k's (prog, oh, ckpt) in the slice (n = G * SPT)
__device__ __forceinline__ void work_put(float* wsl, int n, int k,
                                         float prog, float oh, float ckpt) {
  wsl[k] = prog;
  wsl[n + k] = oh;
  wsl[2 * n + k] = ckpt;
}

// fold one event into the ledger: a job finishes at its last served unit
// or when it migrates to on-demand (its life at the migration plus its
// pre-event remainder x od_time), and misses where that passes the
// deadline
__device__ __forceinline__ void work_fold(
    const WorkArgs& W, WorkCounts& c, bool is_job, bool od_now,
    bool complete, bool defected, bool defect_pre, float life_def,
    float rem_def, float life_pre, float rem_pre, float life_srv, bool panic,
    bool taken, float done, float lost, float oh_inc) {
  const float dl = W.deadline, od = W.od_time;
  const bool miss = (od_now && W.total * od > dl) ||
                    (defected && life_def + rem_def * od > dl) ||
                    (defect_pre && life_pre + rem_pre * od > dl) ||
                    (complete && life_srv > dl);
  const bool fin = od_now || complete || defected || defect_pre;
  c.admitted += is_job;
  c.finished += fin;
  c.misses += fin && miss;
  c.ontime += fin && !miss;
  c.checkpoints += taken;
  c.panics += panic;
  c.done = c.done + done;
  c.lost = c.lost + lost;
  c.recomputed = c.recomputed + (lost + oh_inc);
  c.overhead = c.overhead + oh_inc;
}

// the lane's slice (after `before` floats of the block's shared memory),
// loaded with its slots' initial (prog, oh, ckpt); padding slots are zero.
// The first pass's __syncwarp makes it visible to the group.
template <int G, int SPT>
__device__ __forceinline__ float* work_slice(const WorkArgs& W, float* smem,
                                             size_t before, int lane_in_block,
                                             int lane, int R, int s0, int t) {
  constexpr int n = G * SPT;
  float* wsl = smem + before + lane_in_block * work_stride(n);
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    float p = 0.f, h = 0.f, c = 0.f;
    if (s0 + j < R) {
      const size_t o = static_cast<size_t>(lane) * R + s0 + j;
      p = W.prog0[o];
      h = W.oh0[o];
      c = W.ckpt0[o];
    }
    work_put(wsl, n, j * G + t, p, h, c);
  }
  return wsl;
}

// the final work state of this thread's slots (life from `life`)
template <int G, int SPT>
__device__ __forceinline__ void work_store(const WorkArgs& W,
                                           const float* wsl,
                                           const float (&life)[SPT],
                                           int lane, int R, int s0, int t) {
  constexpr int n = G * SPT;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (s0 + j < R) {
      const size_t o = static_cast<size_t>(lane) * R + s0 + j;
      const int k = j * G + t;
      W.prog[o] = wsl[k];
      W.oh[o] = wsl[n + k];
      W.ckpt[o] = wsl[2 * n + k];
      W.life[o] = life[j];
    }
  }
}

// window `o` of the ledger outputs (n = lanes * windows); the group's first
// thread writes; then the counts start again
__device__ __forceinline__ void work_flush(const WorkArgs& W, WorkCounts& c,
                                           size_t o, size_t nw, bool write) {
  if (write) {
    W.istats[0 * nw + o] = c.admitted;
    W.istats[1 * nw + o] = c.finished;
    W.istats[2 * nw + o] = c.misses;
    W.istats[3 * nw + o] = c.ontime;
    W.istats[4 * nw + o] = c.checkpoints;
    W.istats[5 * nw + o] = c.panics;
    W.fstats[0 * nw + o] = c.done;
    W.fstats[1 * nw + o] = c.lost;
    W.fstats[2 * nw + o] = c.recomputed;
    W.fstats[3 * nw + o] = c.overhead;
  }
  c = WorkCounts{};
}

// the bit of slot s in the per-thread masks `bits` (bit j: slot t * SPT + j)
template <int G, int SPT>
__device__ __forceinline__ bool slot_bit(const LaneGroup<G>& grp,
                                         unsigned bits, int s) {
  return (grp.from(bits, s / SPT) >> (s & (SPT - 1))) & 1u;
}

// the G threads of the lane at `shift` in the warp, for the syncs of a
// crossing (a branch the other lanes of the warp may not take)
template <int G>
__device__ __forceinline__ unsigned group_mask(int shift) {
  return G == 32 ? kFull : ((1u << G) - 1u) << shift;
}

template <int G, int SPT, bool TEL, bool ENV, bool WORK>
__global__ void sweep_kernel(const Args a, const TelArgs tl, const EnvArgs E,
                             const WorkArgs Wk) {
  extern __shared__ float smem[];
  const LaneGroup<G> grp(threadIdx.x & 31);
  const int t = grp.t;
  const int lane_in_block = threadIdx.x / G;
  const int lane0 = blockIdx.x * (blockDim.x / G) + lane_in_block;
  // lanes past the fleet (a ragged last warp) run a copy of the last lane,
  // so every draw pass and reduction stays warp-uniform, and store nothing
  const bool live = lane0 < a.lanes;
  const int lane = live ? lane0 : a.lanes - 1;
  const int R = a.rmax, W = a.n_windows, L = a.lanes, nc = a.n_cols;
  // events a draw pass covers (a slab of no columns draws nothing)
  const int per_pass = a.split ? kSplitPass : (nc ? kDraws / nc : kDraws);
  const int lanes_per_block = blockDim.x / G;
  float* u_s = smem + lane_in_block * kLaneStride;
  float* x_s = smem + lanes_per_block * kLaneStride +
               lane_in_block * kSampleStride;
  const float kc = a.k_cost[lane], pa = a.pa[lane], pb = a.pb[lane];
  const int s0 = t * SPT;  // this thread's first slot
  int* ts = nullptr;  // the lane's telemetry slice
  TelCounts tc;       // ... and its counters
  if constexpr (TEL)
    ts = tel_slice<G>(smem, lanes_per_block * (kLaneStride + kSampleStride),
                      lane_in_block, tl.n_bins, kDraws, t);
  // the environment: the lane's cursor and counts, its segment's 1/avail
  // and spot price (1 and 1 without the axis)
  EnvCursor cur{};
  EnvCounts ec;
  float inv_cur = 1.f, price_cur = 1.f;
  if constexpr (ENV) {
    cur = env_cursor(E, lane);
    inv_cur = inv_avail(E.avail[cur.seg]);
    price_cur = E.price[cur.seg];
  }
  // the work structure: the lane's slice and its ledger (life is the ages)
  constexpr int wn = G * SPT;
  float* wsl = nullptr;
  WorkCounts wc;
  if constexpr (WORK)
    wsl = work_slice<G, SPT>(
        Wk, smem,
        lanes_per_block * (kLaneStride + kSampleStride) +
            (TEL ? size_t(lanes_per_block) * tel_stride(tl.n_bins, kDraws)
                 : 0),
        lane_in_block, lane, R, s0, t);

  float nj = a.next_job0[lane], ns = a.next_spot0[lane];
  int next_seq = a.next_seq0[lane], qlen = a.qlen0[lane];
  // the lane key of the split stream, one step down the ladder an event
  uint32_t lk0 = 0u, lk1 = 0u;
  if (a.split) {
    lk0 = a.win_keys[2 * static_cast<size_t>(lane)];
    lk1 = a.win_keys[2 * static_cast<size_t>(lane) + 1];
  }
  float ages[SPT], budgets[SPT];
  int order[SPT];
  unsigned occ = 0;  // bit j: slot s0 + j is occupied
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    ages[j] = 0.f;
    budgets[j] = kInf;
    order[j] = 0;
    if (s0 + j < R) {
      const size_t o = static_cast<size_t>(lane) * R + s0 + j;
      ages[j] = a.ages0[o];
      budgets[j] = a.budgets0[o];
      occ |= static_cast<unsigned>(a.occ0[o] != 0) << j;
      order[j] = a.order0[o];
    }
  }

  for (int w = 0; w < W; ++w) {
    uint32_t k0 = 0u, k1 = 0u;  // the window's slab key
    if (!a.split) {
      const size_t kw = (static_cast<size_t>(lane) * W + w) * 2;
      k0 = a.win_keys[kw];
      k1 = a.win_keys[kw + 1];
    }
    const uint32_t k2 = k0 ^ k1 ^ kParity;
    const int n_ev = a.plan[w];
    int jobs_arrived = 0, jobs_completed = 0, spot_served = 0, ondemand = 0;
    int spot_arrivals = 0, spot_found_empty = 0;
    float cost_sum = 0.f, delay_sum = 0.f, time_elapsed = 0.f;
    float empty_time = 0.f;

    for (int e0 = 0; e0 < n_ev; e0 += per_pass) {
      const int n_pass = min(per_pass, n_ev - e0);
      __syncwarp();  // the previous pass's rows are read
      if (a.split) {
        split_pass<G>(x_s, reinterpret_cast<uint32_t*>(u_s), n_pass, a, pa,
                      pb, lk0, lk1, t);
      } else {
        draw_pass<G>(u_s, n_pass * nc, static_cast<uint32_t>(e0) * nc, k0,
                     k1, k2, t);
        __syncwarp();
        sample_pass<G>(x_s, u_s, n_pass, nc, a, pa, pb, t);
      }
      __syncwarp();

      for (int e = 0; e < n_pass; ++e) {
        const float* u = u_s + e * nc;  // this event's slab row
        const float* x = x_s + 3 * e;   // ... and its samples

        // pre-event slot reductions: deadline, first free, FIFO-oldest
        int bkey[SPT], okey[SPT];
        unsigned armed = 0;  // bit j: slot s0 + j's panic clock won
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const bool o = (occ >> j) & 1u;
          float b = o ? budgets[j] : kInf;
          if constexpr (WORK) {
            if (Wk.safety && o) {
              const int k = j * G + t;
              const float pk =
                  panic_clock(Wk, ages[j], wsl[k], wsl[wn + k]);
              armed |= static_cast<unsigned>(pk < b) << j;
              b = fminf(b, pk);
            }
          }
          bkey[j] = __float_as_int(b);
          okey[j] = o ? order[j] : kOrderMax;
        }
        int bmin = bkey[0], omin = okey[0];
#pragma unroll
        for (int j = 1; j < SPT; ++j) {
          bmin = min(bmin, bkey[j]);
          omin = min(omin, okey[j]);
        }
        bmin = grp.reduce_min(bmin);
        omin = grp.reduce_min(omin);
        const int di = first_equal<G, SPT>(grp, bkey, bmin);
        const int si = first_equal<G, SPT>(grp, okey, omin);
        const unsigned free_bits = ~occ & ((1u << SPT) - 1u);
        const int owner = grp.first(free_bits != 0);
        const int fj = free_bits ? __ffs(free_bits) - 1 : 0;
        const int fi = owner * SPT + grp.from(fj, owner & (G - 1));
        const float deadline = __int_as_float(bmin);

        // ties resolve spot > deadline > job
        float dt = fminf(fminf(nj, ns), deadline);
        bool is_spot = ns <= fminf(nj, deadline);
        bool is_deadline = !is_spot && deadline <= nj;
        bool is_job = !is_spot && !is_deadline;
        bool is_b = false;  // a boundary crossing: no queue activity
        if constexpr (ENV) {
          is_b = cur.nb <= dt;
          dt = fminf(dt, cur.nb);
          is_spot = is_spot && !is_b;
          is_deadline = is_deadline && !is_b;
          is_job = is_job && !is_b;
        }

        bool admit_raw;
        float budget;
        if (a.policy_code == kThreePhase) {
          const float n_hat = floorf(pa), frac = pa - n_hat;
          const float qf = static_cast<float>(qlen);
          const float p = qf < n_hat ? 1.f : (qf == n_hat ? frac : 0.f);
          // the split stream stages the admission uniform third
          admit_raw = (a.split ? x[2] : u[a.admit_col]) < p;
          budget = kInf;
        } else {
          budget = x[2];
          admit_raw = qlen == 0 && budget > 0.f;
        }
        const bool admit = is_job && admit_raw && qlen < R;
        const bool od_now = is_job && !admit;
        const bool has_job = qlen > 0;
        const bool served = is_spot && has_job;
        const bool defected = is_deadline;
        // a serve completes its job only where the remaining work clears
        WorkServe sv{};
        sv.complete = served;
        float rem_def = 0.f;
        if constexpr (WORK) {
          const int ks = work_index<G, SPT>(si), kd = work_index<G, SPT>(di);
          sv = work_serve(Wk, served, wsl[ks], wsl[wn + ks],
                          wsl[2 * wn + ks]);
          rem_def = wsl[wn + kd] + (Wk.total - wsl[kd]);
          if (served) work_put(wsl, wn, ks, sv.prog, sv.oh, sv.ckpt);
          if (admit) work_put(wsl, wn, work_index<G, SPT>(fi), 0.f, 0.f, 0.f);
        }
        const bool leave = sv.complete || defected;
        const int leave_slot = served ? si : di;

#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          ages[j] = ages[j] + dt;
          budgets[j] = (occ >> j) & 1u ? budgets[j] - dt : kInf;
        }
        const float wait_served = slot_value<G, SPT>(grp, ages, si);
        const float age_defect = slot_value<G, SPT>(grp, ages, di);
        const int join_j = admit && fi / SPT == t ? fi & (SPT - 1) : -1;
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          if (j == join_j) {
            ages[j] = 0.f;
            budgets[j] = budget;
            order[j] = next_seq;
          }
        }
        if (join_j >= 0) occ |= 1u << join_j;
        if (leave && leave_slot / SPT == t)
          occ &= ~(1u << (leave_slot & (SPT - 1)));

        const float job_draw = x[0], spot_draw = x[1];

        jobs_arrived += is_job;
        jobs_completed += od_now || served || defected;
        spot_served += served;
        ondemand += od_now || defected;
        cost_sum = cost_sum + (served ? price_cur : 0.f);
        cost_sum = cost_sum + ((od_now || defected) ? kc : 0.f);
        delay_sum = delay_sum + (served ? wait_served : 0.f);
        delay_sum = delay_sum + (defected ? age_defect : 0.f);
        time_elapsed = time_elapsed + dt;
        empty_time = empty_time + (qlen == 0 ? dt : 0.f);  // pre-event qlen
        spot_arrivals += is_spot;
        spot_found_empty += is_spot && !has_job;

        nj = is_job ? job_draw : nj - dt;
        if constexpr (ENV) {
          // the spot clock at rate x avail: a fresh draw x 1/avail, the
          // survived clock rescaled by inv_new / inv_old at a crossing
          if (is_b) {
            const float inv_new = inv_avail(E.avail[cur.seg + 1]);
            ns = (ns - dt) * (inv_new / inv_cur);
            inv_cur = inv_new;
            price_cur = E.price[cur.seg + 1];
          } else {
            ns = is_spot ? spot_draw * inv_cur : ns - dt;
          }
          env_fold(E, cur, ec, is_b, dt, is_job, od_now, served, false);
        } else {
          ns = is_spot ? spot_draw : ns - dt;
        }
        next_seq += admit;
        qlen += static_cast<int>(admit) - static_cast<int>(leave);
        if constexpr (WORK) {
          // a panic: the defecting slot's panic clock won (a shuffle every
          // thread of the warp runs: the safety net is a run constant)
          const bool panic =
              Wk.safety && slot_bit<G, SPT>(grp, armed, di) && defected;
          work_fold(Wk, wc, is_job, od_now, sv.complete, defected, false,
                    age_defect, rem_def, 0.f, 0.f, wait_served, panic,
                    sv.taken, sv.done, 0.f, 0.f);
        }

        if constexpr (TEL) {
          TelEvent ev;
          ev.type = is_spot ? kEvSpot : (is_deadline ? kEvDeadline : kEvJob);
          ev.loc = 0;
          ev.qlen = qlen;
          ev.served = served;
          ev.preempt = false;
          ev.resume = false;
          ev.defected = defected;
          ev.rejected = od_now;
          ev.wait_valid = served || defected;
          ev.wait = served ? wait_served : age_defect;
          ev.cost_valid = served || od_now || defected;
          ev.cost = served ? 1.f : kc;
          ev.t = time_elapsed;
          tel_fold(tl, ts, e, tc, ev, t == 0);
        }
      }
      if constexpr (TEL)
        tel_pass<G>(tl, ts, n_pass, e0,
                    (static_cast<size_t>(lane) * W + w) * tl.cap, t, live);
    }

    if (t == 0 && live) {
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
    if constexpr (TEL)
      tel_flush<G>(tl, ts, tc, static_cast<size_t>(lane) * W + w,
                   static_cast<size_t>(L) * W, t, live);
    if constexpr (ENV)
      env_flush(E, ec, static_cast<size_t>(lane) * W + w,
                static_cast<size_t>(L) * W, t == 0 && live);
    if constexpr (WORK)
      work_flush(Wk, wc, static_cast<size_t>(lane) * W + w,
                 static_cast<size_t>(L) * W, t == 0 && live);

    rebase_order<G, SPT>(grp, occ, order, next_seq, s0, R);
  }

  if (!live) return;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (s0 + j < R) {
      const size_t o = static_cast<size_t>(lane) * R + s0 + j;
      a.ages[o] = ages[j];
      a.budgets[o] = budgets[j];
      a.occ[o] = (occ >> j) & 1u;
      a.order[o] = order[j];
    }
  }
  if constexpr (WORK) work_store<G, SPT>(Wk, wsl, ages, lane, R, s0, t);
  if (t == 0) {
    a.next_job[lane] = nj;
    a.next_spot[lane] = ns;
    a.next_seq[lane] = next_seq;
    a.qlen[lane] = qlen;
    if (a.split) {
      a.key_out[2 * static_cast<size_t>(lane)] = lk0;
      a.key_out[2 * static_cast<size_t>(lane) + 1] = lk1;
    }
    if constexpr (ENV) {
      E.nb[lane] = cur.nb;
      E.seg[lane] = cur.seg;
    }
  }
}

// dynamic shared memory a block of `lanes_per_block` lanes adds for the
// telemetry slices of `pass` staged events (none without the axis)
size_t tel_smem(const TelArgs& tl, int lanes_per_block, int pass) {
  return kTel ? sizeof(int) * lanes_per_block * tel_stride(tl.n_bins, pass)
              : 0;
}

// ... and for the work slices of lanes of `slots` slots (G * SPT), which
// follow the telemetry slices (none without the axis)
size_t work_smem(int lanes_per_block, int slots) {
  return kWork ? sizeof(float) * lanes_per_block * work_stride(slots) : 0;
}

template <int G, int SPT>
cudaError_t launch_gs(const Args& a, const TelArgs& tl, const EnvArgs& E,
                      const WorkArgs& Wk, int warps_per_block,
                      cudaStream_t s) {
  const int lanes_per_block = warps_per_block * 32 / G;
  const dim3 grid((a.lanes + lanes_per_block - 1) / lanes_per_block);
  const dim3 block(warps_per_block * 32);
  const size_t smem =
      sizeof(float) * lanes_per_block * (kLaneStride + kSampleStride) +
      tel_smem(tl, lanes_per_block, kDraws) +
      work_smem(lanes_per_block, G * SPT);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<G, SPT, kTel, kEnv, kWork>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sweep_kernel<G, SPT, kTel, kEnv, kWork><<<grid, block, smem, s>>>(a, tl, E,
                                                                   Wk);
  return cudaGetLastError();
}

// the (G, SPT) pairs sweep.py::group_size picks, and no other
cudaError_t launch_g(const Args& a, const TelArgs& tl, const EnvArgs& E,
                     const WorkArgs& Wk, int group, int spt,
                     int warps_per_block,
                     cudaStream_t s) {
  if (group == 4) {
    switch (spt) {
      case 1: return launch_gs<4, 1>(a, tl, E, Wk, warps_per_block, s);
      case 2: return launch_gs<4, 2>(a, tl, E, Wk, warps_per_block, s);
      case 4: return launch_gs<4, 4>(a, tl, E, Wk, warps_per_block, s);
      case 8: return launch_gs<4, 8>(a, tl, E, Wk, warps_per_block, s);
    }
  } else if (spt == 8) {
    switch (group) {
      case 8: return launch_gs<8, 8>(a, tl, E, Wk, warps_per_block, s);
      case 16: return launch_gs<16, 8>(a, tl, E, Wk, warps_per_block, s);
      case 32: return launch_gs<32, 8>(a, tl, E, Wk, warps_per_block, s);
    }
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The P-pool spot market (repro/core/engine.py::_market_event on the slab
// stream; plain version ../ref.py::market_event_windows_ref, wrapper
// ../sweep.py::market_event_windows)
// ---------------------------------------------------------------------------
// The same design as the single queue's: a lane on G threads, its slot
// state in registers across windows, the slab drawn a pass ahead into
// shared memory and every draw the event chain needs sampled there first.
// What the market adds a lane-event: a pool tag a slot; P spot clocks
// (registers, the same on every thread of the group) merged by an argmin
// whose ties go to the lowest pool; one superposed preemption clock, its
// firing pool picked by thinning in the sample pass; two masked FIFO
// reductions where the single queue has one (the oldest job tagged the
// firing spot pool, the oldest tagged the revoked pool), each an int32
// min and a ballot with the pool compare folded into the key; and the
// per-pool counts, each on the thread that owns the pool (pool q on thread
// q % G).  P is a bound of the run (at most kMaxPools), not a template
// parameter: the pools' loops unroll to kMaxPools and test p < P, so the
// library holds the same seven (G, SPT) builds as the single queue.
// Hazard sums run left to right, as XLA's CPU backend sums a pool vector;
// the hazard clock and the slot rates divide (IEEE division), as XLA does
// by a traced value.
//
// The split stream (rng="split", repro/core/engine.py::_market_event with
// layout=None) is a run-time flag of the same kernel, tested once: the
// window loop is a generic lambda compiled for each stream (StreamTag), so
// neither stream's event chain carries the other's branches (one chain
// holding both ran the slab stream 3% slower than the kernel before the
// split stream, and the split stream 6-8% slower than two chains).  Event
// e's key k_e gives split(k_e, 5) (4 without preemption), and its pass
// stages, in place of the slab's draws, the keyed ones: the job clock
// (subkey 1), every pool's spot draw (subkey 2, folded with the pool's tag
// where P > 1), the policy's (subkey 3, split into an admission and a
// choice key by a market kernel: the admission uniform or the wait budget,
// and the uniform rule's randint or the weighted rule's Gumbel draws) and,
// with preemption, the re-admission uniform and every pool's hazard clock
// (subkey 4 folded with the pool's tag).  The preemption clocks are then
// a vector of P in registers beside the spot clocks, the revoked pool the
// earliest (lowest on ties), and a revocation refreshes only its pool's
// clock.  Which pool fires depends on the previous event, so the pass
// draws all 2P clocks (4P hashes an event, spread over the G threads)
// rather than put the firing pool's two hashes on the event chain, whose
// latency bounds the kernel.
constexpr int kMaxPools = 8;
// a stream as a type: the argument that compiles a generic lambda's body
// once for the slab stream and once for the split stream
template <bool Split>
struct StreamTag {
  static constexpr bool value = Split;
};
// events a market draw pass covers at most (fewer where a row is wide)
constexpr int kMarketPass = 16;
// floats an event's samples take: job clock, wait budget, pool choice
// (int bits), revoked pool (int bits), preemption clock, P spot draws; on
// the split stream slot 3 holds the admission uniform, slot 4 the
// re-admission uniform, and P hazard clocks follow the spot draws
constexpr int kEv = 5 + kMaxPools;
constexpr int kEvSplit = 5 + 2 * kMaxPools;
// a lane's pool table in shared memory: price, spot scale, the hazards'
// running sums, pool logits, the hazards, with the environment 1/avail
// (prices and hazards then the segment's effective ones), and the pools'
// slot processes (four constants, the code and the stream tag a pool), so
// that the split pass's loops over the pools index shared memory and stay
// rolled (unrolled, their hashes made each build's market code several
// times longer)
constexpr int kHz = 4 * kMaxPools;
constexpr int kProc = (kEnv ? 6 : 5) * kMaxPools;
constexpr int kProcCode = kProc + 4 * kMaxPools;
constexpr int kProcTag = kProcCode + kMaxPools;
constexpr int kTab = kProcTag + kMaxPools + 1;
constexpr float kTiny = 1.17549435e-38f;  // float32's smallest normal

// floats a lane's samples take in shared memory on the stream
__host__ __device__ __forceinline__ int market_sample_stride(int split) {
  return kMarketPass * (split ? kEvSplit : kEv) + 1;
}

enum Admit { kThreePhaseAdmit = 0, kSingleSlotAdmit = 1 };
enum Choice { kPoolZero = 0, kCheapest = 1, kFastest = 2, kLeastLoaded = 3,
              kUniformChoice = 4, kWeighted = 5 };
enum Resume { kDefect = 0, kNoticeAware = 1 };

struct MArgs {
  // initial state, per lane (slot arrays lanes x rmax, pool clocks lanes x P)
  const float* next_job0;
  const float* next_spot0;
  const float* next_pre0;
  const float* ages0;
  const float* budgets0;
  const uint8_t* occ0;
  const int32_t* pool0;
  const int32_t* order0;
  const int32_t* next_seq0;
  const int32_t* qlen0;
  const uint32_t* win_keys;  // lanes x windows x 2
  const int32_t* plan;
  const float* k_cost;  // per lane
  const float* pa;      // per lane: r, or the wait family's first param
  const float* pb;      // per lane: the wait family's second param
  const float* ckpt;    // per lane: checkpoint time (notice-aware kernels)
  // the pools config, lanes x P each (logits only for the weighted rule)
  const float* price;
  const float* hazard;
  const float* notice;
  const float* rate;
  const float* scale;
  const float* logits;
  // final state
  float* next_job;
  float* next_spot;
  float* next_pre;
  float* ages;
  float* budgets;
  uint8_t* occ;
  int32_t* pool;
  int32_t* order;
  int32_t* next_seq;
  int32_t* qlen;
  int32_t* istats;  // 7 x lanes x windows
  float* fstats;    // 5 x lanes x windows
  int32_t* pstats;  // 3 x lanes x windows x P
  uint32_t* key_out;  // lanes x 2: the final lane keys (split stream only)
  int split;          // the stream: 0 the slab, 1 the split ladder
  int lanes, rmax, n_windows, n_cols, n_pools;
  int job_code, job_n, admit_code, wait_code, choice_code, resume_code;
  int preempt_on, any_exp_pool;
  int job_col, spot_col, admit_col, choice_col, pre_col, onpre_col;
  int pool_code[kMaxPools], pool_n[kMaxPools];
  uint32_t tag[kMaxPools];  // the pools' stream tags (split stream)
  float job_c[4];
  float pool_c[kMaxPools][4];
};

// the Theorem-4 admission probability at queue length q under cap r
__device__ __forceinline__ float three_phase_p(float r, int q) {
  const float n_hat = floorf(r), frac = r - n_hat;
  const float qf = static_cast<float>(q);
  return qf < n_hat ? 1.f : (qf == n_hat ? frac : 0.f);
}

// which of the P locations a revocation hits: u thinned over the hazards'
// running sums `cum` (clocks.py::thinning_pick)
__device__ __forceinline__ int thinning_pick(const float* cum, int P,
                                             float u) {
  const float xu = u * cum[P - 1];
  int pick = 0;
#pragma unroll
  for (int p = 0; p < kMaxPools - 1; ++p)
    if (p < P - 1) pick += xu >= cum[p];
  return min(pick, P - 1);
}

// what a segment fixes for a lane's market or regions: the rule's fixed
// choice (cheapest, fastest), the alive locations (rate x avail > 0) and
// the cheapest alive one (position 0 where none is)
struct LocSeg {
  int fixed, cheapest_alive;
  unsigned alive;
};

// the lane's locations under segment s: the effective prices (at tab[p]),
// the effective hazards' running sums (at cum[p]), 1/avail (at inv[p]) and,
// where hz is given, the effective hazards (at hz[p]), written by the
// writer thread; `price`, `hazard`, `rate` and `scale` the lane's base
// config (n entries), `rule` the fixed-choice rule
__device__ __forceinline__ LocSeg loc_segment(
    const EnvArgs& E, int s, int n, const float* price, const float* hazard,
    const float* rate, const float* scale, int rule, float* tab, float* cum,
    float* inv, float* hz, bool writer) {
  LocSeg r{0, 0, 0u};
  const size_t row = static_cast<size_t>(s) * E.n_locs;
  float h_sum = 0.f, best = 0.f, best_alive = 0.f;
#pragma unroll
  for (int p = 0; p < kMaxPools; ++p) {
    if (p < n) {
      const float av = E.avail[row + p];
      const float eff_price = price[p] * E.price[row + p];
      const float h = hazard[p] * E.hazard[row + p];
      h_sum = p == 0 ? h : h_sum + h;
      const float eff_rate = (rate[p] / scale[p]) * av;
      if (writer) {
        tab[p] = eff_price;
        cum[p] = h_sum;
        inv[p] = inv_avail(av);
        if (hz) hz[p] = h;
      }
      const bool alive = eff_rate > 0.f;
      r.alive |= static_cast<unsigned>(alive) << p;
      if (rule == kCheapest) {
        if (p == 0 || eff_price < best) { best = eff_price; r.fixed = p; }
      } else if (rule == kFastest) {
        if (p == 0 || eff_rate > best) { best = eff_rate; r.fixed = p; }
      }
      const float v = alive ? eff_price : kInf;
      if (p == 0 || v < best_alive) { best_alive = v; r.cheapest_alive = p; }
    }
  }
  return r;
}

// the left-to-right sum of the lane's effective hazards under segment s
__device__ __forceinline__ float total_hazard(const EnvArgs& E, int s, int n,
                                              const float* hazard) {
  const size_t row = static_cast<size_t>(s) * E.n_locs;
  float h_sum = 0.f;
#pragma unroll
  for (int p = 0; p < kMaxPools; ++p) {
    if (p < n) {
      const float h = hazard[p] * E.hazard[row + p];
      h_sum = p == 0 ? h : h_sum + h;
    }
  }
  return h_sum;
}

// the samples of the pass's n events (kEv floats each in x_s) from their
// slab rows in u_s; thread t takes events t, t + G, ...  With ENV the
// revoked pool and the preemption clock depend on the event's segment: the
// pass leaves the pick to the chain and stores the unit exponential alone.
template <int G, bool ENV>
__device__ __forceinline__ void market_sample_pass(
    float* x_s, const float* u_s, const float* tab, int n, int nc,
    const MArgs& a, float pa, float pb, int fixed_choice, int t) {
  const int P = a.n_pools;
  for (int e = t; e < n; e += G) {
    const float* u = u_s + e * nc;
    float* x = x_s + e * kEv;
    const int off[1] = {e * nc};
    float out[1];
    sample_arrivals<1>(a.job_code, a.job_c, a.job_n, u_s, off, a.job_col,
                       out);
    x[0] = out[0];
    out[0] = kInf;
    if (a.admit_code == kSingleSlotAdmit)
      sample_waits<1>(a.wait_code, pa, pb, u_s, off, a.admit_col, out);
    x[1] = out[0];
    int choice = fixed_choice;
    if (a.choice_code == kUniformChoice) {
      choice = min(static_cast<int>(u[a.choice_col] * static_cast<float>(P)),
                   P - 1);
    } else if (a.choice_code == kWeighted) {
      float best = 0.f;
#pragma unroll
      for (int p = 0; p < kMaxPools; ++p) {
        if (p < P) {
          const float g =
              -logf(-logf(fmaxf(u[a.choice_col + p], 1e-12f)));
          const float v = tab[3 * kMaxPools + p] + g;
          if (p == 0 || v > best) {
            best = v;
            choice = p;
          }
        }
      }
    }
    x[2] = __int_as_float(choice);
    if (ENV) {
      if (a.preempt_on) x[4] = exp_from_u(u[a.pre_col]);
    } else if (a.preempt_on) {
      const float total = tab[2 * kMaxPools + P - 1];
      const float xu = u[a.pre_col + 1] * total;
      int pick = 0;
#pragma unroll
      for (int p = 0; p < kMaxPools - 1; ++p)
        if (p < P - 1) pick += xu >= tab[2 * kMaxPools + p];
      x[3] = __int_as_float(min(pick, P - 1));
      x[4] = total > 0.f ? exp_from_u(u[a.pre_col]) / fmaxf(total, 1e-30f)
                         : kInf;
    }
    // every pool transforms the same spot columns
    const float unit = a.any_exp_pool ? exp_from_u(u[a.spot_col]) : 0.f;
#pragma unroll
    for (int p = 0; p < kMaxPools; ++p) {
      if (p < P) {
        float d;
        if (a.pool_code[p] == kExponential) {
          d = unit * a.pool_c[p][0];
        } else {
          sample_arrivals<1>(a.pool_code[p], a.pool_c[p], a.pool_n[p], u_s,
                             off, a.spot_col, out);
          d = out[0];
        }
        x[5 + p] = d * tab[kMaxPools + p];
      }
    }
  }
}

// The split stream's market pass over the lane's next n events (n <=
// kMarketPass): the ladder, then thread t draws events t, t + G, ... from
// their keys into x_s (kEvSplit floats an event).  With ENV a hazard clock
// depends on the event's segment: the pass stores its unit exponential and
// the chain divides.  A process that draws nothing hashes no subkey.
template <int G, bool ENV>
__device__ __forceinline__ void market_split_pass(
    float* x_s, uint32_t* k_s, const float* tab, int n, const MArgs& a,
    float pa, float pb, int fixed_choice, uint32_t& lk0, uint32_t& lk1,
    int t) {
  walk_ladder<G>(k_s, n, lk0, lk1, t);
  const int P = a.n_pools;
  for (int e = t; e < n; e += G) {
    const uint32_t k0 = k_s[2 * e], k1 = k_s[2 * e + 1];
    float* x = x_s + e * kEvSplit;
    float out[1];
    // the job clock (subkey 1)
    uint32_t j0[1] = {0u}, j1[1] = {0u};
    if (a.job_code != kDeterministic) subkey(k0, k1, 1u, j0[0], j1[0]);
    keyed_arrivals<1>(a.job_code, a.job_c, j0, j1, out);
    x[0] = out[0];
    // the policy (subkey 3): a legacy kernel draws from it, a market kernel
    // splits it into the admission key and the choice key
    uint32_t q0[1], q1[1], c0 = 0u, c1 = 0u;
    subkey(k0, k1, 3u, q0[0], q1[0]);
    if (a.choice_code != kPoolZero) {
      if (a.choice_code == kUniformChoice || a.choice_code == kWeighted)
        subkey(q0[0], q1[0], 1u, c0, c1);
      subkey(q0[0], q1[0], 0u, q0[0], q1[0]);
    }
    x[1] = kInf;
    x[3] = 0.f;
    if (a.admit_code == kSingleSlotAdmit) {
      keyed_waits<1>(a.wait_code, pa, pb, q0, q1, out);
      x[1] = out[0];
    } else {
      x[3] = key_u01(key_bits(q0[0], q1[0]));
    }
    int choice = fixed_choice;
    if (a.choice_code == kUniformChoice) {
      // jax.random.randint(k, (), 0, P): two words from the key's halves,
      // reduced modulo P in uint32 arithmetic
      uint32_t h0, h1, l0, l1;
      subkey(c0, c1, 0u, h0, h1);
      subkey(c0, c1, 1u, l0, l1);
      const uint32_t span = static_cast<uint32_t>(P);
      const uint32_t m = ((65536u % span) * (65536u % span)) % span;
      choice = static_cast<int>(
          ((key_bits(h0, h1) % span) * m + key_bits(l0, l1) % span) % span);
    } else if (a.choice_code == kWeighted) {
      // jax.random.gumbel(k, (P,)): word p hashes counter (0, p); the
      // uniform on [tiny, 1) is the key uniform, tiny where it is 0
      const uint32_t c2 = c0 ^ c1 ^ kParity;
      float best = 0.f;
#pragma unroll 1
      for (int p = 0; p < P; ++p) {
        const float u = fmaxf(
            key_u01(threefry_bits(c0, c1, c2, static_cast<uint32_t>(p))) +
                kTiny,
            kTiny);
        const float v = tab[3 * kMaxPools + p] + -logf(-logf(u));
        if (p == 0 || v > best) {
          best = v;
          choice = p;
        }
      }
    }
    x[2] = __int_as_float(choice);
    // the pools' spot draws (subkey 2, folded with the tag where P > 1)
    const int* code = reinterpret_cast<const int*>(tab + kProcCode);
    const uint32_t* tag = reinterpret_cast<const uint32_t*>(tab + kProcTag);
    uint32_t sp0, sp1;
    subkey(k0, k1, 2u, sp0, sp1);
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
      uint32_t w0[1] = {sp0}, w1[1] = {sp1};
      if (P > 1 && code[p] != kDeterministic)
        subkey(sp0, sp1, tag[p], w0[0], w1[0]);
      keyed_arrivals<1>(code[p], tab + kProc + 4 * p, w0, w1, out);
      x[5 + p] = out[0] * tab[kMaxPools + p];
    }
    // revocation (subkey 4): the re-admission uniform and every pool's
    // hazard clock, always folded with the tag
    if (a.preempt_on) {
      uint32_t r0, r1;
      subkey(k0, k1, 4u, r0, r1);
      x[4] = a.resume_code == kNoticeAware ? key_u01(key_bits(r0, r1)) : 0.f;
#pragma unroll 1
      for (int p = 0; p < P; ++p) {
        uint32_t h0, h1;
        subkey(r0, r1, tag[p], h0, h1);
        const float unit = exp_from_u(key_u01(key_bits(h0, h1)));
        const float h = tab[kHz + p];
        x[5 + kMaxPools + p] =
            ENV ? unit : (h > 0.f ? unit / fmaxf(h, 1e-30f) : kInf);
      }
    }
  }
}

template <int G, int SPT, bool TEL, bool ENV, bool WORK>
__global__ void market_kernel(const MArgs a, const TelArgs tl,
                              const EnvArgs E, const WorkArgs Wk) {
  extern __shared__ float smem[];
  const LaneGroup<G> grp(threadIdx.x & 31);
  const int t = grp.t;
  const int lane_in_block = threadIdx.x / G;
  const int lanes_per_block = blockDim.x / G;
  const int lane0 = blockIdx.x * lanes_per_block + lane_in_block;
  // lanes past the fleet run a copy of the last lane and store nothing
  const bool live = lane0 < a.lanes;
  const int lane = live ? lane0 : a.lanes - 1;
  const int R = a.rmax, W = a.n_windows, L = a.lanes, nc = a.n_cols;
  const int P = a.n_pools;
  const int mss = market_sample_stride(a.split);
  float* u_s = smem + lane_in_block * kLaneStride;
  float* x_s = smem + lanes_per_block * kLaneStride + lane_in_block * mss;
  float* tab = smem + lanes_per_block * (kLaneStride + mss) +
               lane_in_block * kTab;
  const float kc = a.k_cost[lane], pa = a.pa[lane], pb = a.pb[lane];
  const int s0 = t * SPT;
  int* ts = nullptr;  // the lane's telemetry slice
  TelCounts tc;       // ... and its counters
  if constexpr (TEL)
    ts = tel_slice<G>(smem, lanes_per_block * (kLaneStride + mss + kTab),
                      lane_in_block, tl.n_bins, kMarketPass, t);

  // the lane's pool table, and what depends on it alone
  const size_t lp = static_cast<size_t>(lane) * P;
  for (int p = t; p < P; p += G) {
    tab[p] = a.price[lp + p];
    tab[kMaxPools + p] = a.scale[lp + p];
    tab[3 * kMaxPools + p] = a.logits ? a.logits[lp + p] : 0.f;
    tab[kHz + p] = a.hazard[lp + p];
  }
  if (a.split && t == 0) {
#pragma unroll
    for (int p = 0; p < kMaxPools; ++p) {
#pragma unroll
      for (int c = 0; c < 4; ++c) tab[kProc + 4 * p + c] = a.pool_c[p][c];
      tab[kProcCode + p] = __int_as_float(a.pool_code[p]);
      tab[kProcTag + p] = __uint_as_float(a.tag[p]);
    }
  }
  if (t == 0) {
    float cum = a.hazard[lp];
    tab[2 * kMaxPools] = cum;
    for (int p = 1; p < P; ++p) {
      cum = cum + a.hazard[lp + p];
      tab[2 * kMaxPools + p] = cum;
    }
  }
  __syncwarp();
  int fixed_choice = 0;  // cheapest / fastest: first index on ties
  unsigned within = 0;   // bit p: a checkpoint fits pool p's notice
  unsigned wwithin = 0;  // ... the work model's checkpoint (the base notice)
  {
    const float ck = a.ckpt[lane];
    float best = 0.f;
#pragma unroll
    for (int p = 0; p < kMaxPools; ++p) {
      if (p < P) {
        if (a.choice_code == kCheapest) {
          const float v = tab[p];
          if (p == 0 || v < best) { best = v; fixed_choice = p; }
        } else if (a.choice_code == kFastest) {
          const float v = a.rate[lp + p] / tab[kMaxPools + p];
          if (p == 0 || v > best) { best = v; fixed_choice = p; }
        }
        within |= static_cast<unsigned>(ck <= a.notice[lp + p]) << p;
        if constexpr (WORK)
          wwithin |= static_cast<unsigned>(Wk.ckpt_time <= a.notice[lp + p])
                     << p;
      }
    }
  }
  // the environment: the lane's cursor and counts, and what its segment
  // fixes (the table's prices, running sums and 1/avail are the segment's)
  EnvCursor cur{};
  EnvCounts ec;
  LocSeg sg{0, 0, 0u};
  float* const cum = tab + 2 * kMaxPools;
  float* const hz = tab + kHz;
  float* const inv = tab + 5 * kMaxPools;
  if constexpr (ENV) {
    cur = env_cursor(E, lane);
    sg = loc_segment(E, cur.seg, P, a.price + lp, a.hazard + lp, a.rate + lp,
                     a.scale + lp, a.choice_code, tab, cum, inv, hz, t == 0);
    __syncwarp();
  }

  // the work structure: the lane's slice, its ledger and the slots' lives
  constexpr int wn = G * SPT;
  float* wsl = nullptr;
  WorkCounts wc;
  float life[WORK ? SPT : 1];
  if constexpr (WORK) {
    wsl = work_slice<G, SPT>(
        Wk, smem,
        lanes_per_block * (kLaneStride + mss + kTab) +
            (TEL ? size_t(lanes_per_block) *
                       tel_stride(tl.n_bins, kMarketPass)
                 : 0),
        lane_in_block, lane, R, s0, t);
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      life[j] = s0 + j < R ? Wk.life0[static_cast<size_t>(lane) * R + s0 + j]
                           : 0.f;
  }

  float nj = a.next_job0[lane];
  // the preemption clocks: one superposed clock (npre[0]) on the slab
  // stream, one a pool on the split stream
  float ns[kMaxPools], npre[kMaxPools];
#pragma unroll
  for (int p = 0; p < kMaxPools; ++p) {
    ns[p] = p < P ? a.next_spot0[lp + p] : kInf;
    npre[p] = kInf;
    if (a.split ? p < P : p == 0)
      npre[p] = a.next_pre0[a.split ? lp + p : lane];
  }
  // the lane key of the split stream, one step down the ladder an event
  uint32_t lk0 = 0u, lk1 = 0u;
  if (a.split) {
    lk0 = a.win_keys[2 * static_cast<size_t>(lane)];
    lk1 = a.win_keys[2 * static_cast<size_t>(lane) + 1];
  }
  int next_seq = a.next_seq0[lane], qlen = a.qlen0[lane];
  float ages[SPT], budgets[SPT];
  int order[SPT], pool[SPT];
  unsigned occ = 0;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    ages[j] = 0.f;
    budgets[j] = kInf;
    order[j] = 0;
    pool[j] = 0;
    if (s0 + j < R) {
      const size_t o = static_cast<size_t>(lane) * R + s0 + j;
      ages[j] = a.ages0[o];
      budgets[j] = a.budgets0[o];
      occ |= static_cast<unsigned>(a.occ0[o] != 0) << j;
      order[j] = a.order0[o];
      pool[j] = a.pool0[o];
    }
  }
  // queued jobs a pool (least_loaded only), kept by increments from here
  int qp[kMaxPools];
#pragma unroll
  for (int p = 0; p < kMaxPools; ++p) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < SPT; ++j) c += ((occ >> j) & 1u) && pool[j] == p;
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) c += __shfl_xor_sync(kFull, c, o, G);
    qp[p] = c;
  }

  // the windows: the loop is compiled once a stream, the stream tested
  // once here
  const auto run_windows = [&](auto stream) {
    constexpr bool kSplit = decltype(stream)::value;
    const int per_pass = kSplit ? kMarketPass : min(kDraws / nc, kMarketPass);
    constexpr int ev = kSplit ? kEvSplit : kEv;  // floats an event's samples
    for (int w = 0; w < W; ++w) {
      uint32_t k0 = 0u, k1 = 0u;  // the window's slab key
      if (!kSplit) {
        const size_t kw = (static_cast<size_t>(lane) * W + w) * 2;
        k0 = a.win_keys[kw];
        k1 = a.win_keys[kw + 1];
      }
      const uint32_t k2 = k0 ^ k1 ^ kParity;
      const int n_ev = a.plan[w];
      int jobs_arrived = 0, jobs_completed = 0, spot_served = 0, ondemand = 0;
      int spot_arrivals = 0, spot_found_empty = 0, resumed = 0;
      float cost_sum = 0.f, delay_sum = 0.f, time_elapsed = 0.f;
      float empty_time = 0.f, spot_cost = 0.f;
      // pools q = t and t + G of this thread: served, slots, revocations
      int p_served[2] = {0, 0}, p_slots[2] = {0, 0}, p_pre[2] = {0, 0};

      for (int e0 = 0; e0 < n_ev; e0 += per_pass) {
        const int n_pass = min(per_pass, n_ev - e0);
        __syncwarp();
        if constexpr (kSplit) {
          market_split_pass<G, ENV>(x_s, reinterpret_cast<uint32_t*>(u_s), tab,
                                    n_pass, a, pa, pb, fixed_choice, lk0, lk1,
                                    t);
        } else {
          draw_pass<G>(u_s, n_pass * nc, static_cast<uint32_t>(e0) * nc, k0,
                       k1, k2, t);
          __syncwarp();
          market_sample_pass<G, ENV>(x_s, u_s, tab, n_pass, nc, a, pa, pb,
                                     fixed_choice, t);
        }
        __syncwarp();

        for (int e = 0; e < n_pass; ++e) {
          const float* u = u_s + e * nc;  // the slab stream's row
          const float* x = x_s + e * ev;

          // the firing spot pool: the earliest clock, the lowest on ties
          float min_spot = ns[0];
          int spot_pool = 0;
#pragma unroll
          for (int p = 1; p < kMaxPools; ++p)
            if (p < P && ns[p] < min_spot) { min_spot = ns[p]; spot_pool = p; }
          // the revoked pool: the earliest clock on the split stream, a
          // thinned pick of the superposed clock's on the slab stream
          int pre_pool = 0;
          float min_pre = npre[0];
          if (a.preempt_on) {
            if (kSplit) {
#pragma unroll
              for (int p = 1; p < kMaxPools; ++p) {
                if (p < P && npre[p] < min_pre) {
                  min_pre = npre[p];
                  pre_pool = p;
                }
              }
            } else {
              pre_pool = ENV ? thinning_pick(cum, P, u[a.pre_col + 1])
                             : __float_as_int(x[3]);
            }
          }
          if constexpr (ENV) {
            // PanicKernel's drain: jobs queued on a dead pool re-tag to the
            // cheapest alive one (where one is alive)
            if (E.drain) {
              bool moved = false;
#pragma unroll
              for (int j = 0; j < SPT; ++j) {
                if (sg.alive != 0u && ((occ >> j) & 1u) &&
                    !((sg.alive >> pool[j]) & 1u)) {
                  pool[j] = sg.cheapest_alive;
                  moved = true;
                }
              }
              if (a.choice_code == kLeastLoaded && __any_sync(kFull, moved)) {
#pragma unroll
                for (int p = 0; p < kMaxPools; ++p) {
                  int c = 0;
#pragma unroll
                  for (int j = 0; j < SPT; ++j)
                    c += ((occ >> j) & 1u) && pool[j] == p;
#pragma unroll
                  for (int o = G / 2; o > 0; o >>= 1)
                    c += __shfl_xor_sync(kFull, c, o, G);
                  qp[p] = c;
                }
              }
            }
          }

          // pre-event slot reductions: deadline, the oldest job of the spot
          // pool, the oldest of the revoked pool, the first free slot
          int bkey[SPT], skey[SPT], pkey[SPT];
          bool any_s = false, any_p = false;
          unsigned armed = 0;  // bit j: slot s0 + j's panic clock won
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            const bool o = (occ >> j) & 1u;
            const bool es = o && pool[j] == spot_pool;
            const bool ep = o && pool[j] == pre_pool;
            float b = o ? budgets[j] : kInf;
            if constexpr (WORK) {
              if (Wk.safety && o) {
                const int k = j * G + t;
                const float pk = panic_clock(Wk, life[j], wsl[k], wsl[wn + k]);
                armed |= static_cast<unsigned>(pk < b) << j;
                b = fminf(b, pk);
              }
            }
            bkey[j] = __float_as_int(b);
            skey[j] = es ? order[j] : kOrderMax;
            pkey[j] = ep ? order[j] : kOrderMax;
            any_s |= es;
            any_p |= ep;
          }
          int bmin = bkey[0], smin = skey[0], pmin = pkey[0];
#pragma unroll
          for (int j = 1; j < SPT; ++j) {
            bmin = min(bmin, bkey[j]);
            smin = min(smin, skey[j]);
            pmin = min(pmin, pkey[j]);
          }
          bmin = grp.reduce_min(bmin);
          smin = grp.reduce_min(smin);
          const int di = first_equal<G, SPT>(grp, bkey, bmin);
          const int si = first_equal<G, SPT>(grp, skey, smin);
          const bool has_elig = grp.first(any_s) < G;
          int pi = 0;
          bool has_pre = false;
          if (a.preempt_on) {
            pmin = grp.reduce_min(pmin);
            pi = first_equal<G, SPT>(grp, pkey, pmin);
            has_pre = grp.first(any_p) < G;
          }
          const unsigned free_bits = ~occ & ((1u << SPT) - 1u);
          const int owner = grp.first(free_bits != 0);
          const int fj = free_bits ? __ffs(free_bits) - 1 : 0;
          const int fi = owner * SPT + grp.from(fj, owner & (G - 1));
          const float deadline = __int_as_float(bmin);

          // ties resolve spot > preempt > deadline > job
          float dt;
          bool is_spot, is_pre = false, is_deadline;
          if (a.preempt_on) {
            dt = fminf(fminf(nj, min_spot), fminf(deadline, min_pre));
            is_spot = min_spot <= fminf(nj, fminf(deadline, min_pre));
            is_pre = !is_spot && min_pre <= fminf(nj, deadline);
            is_deadline = !is_spot && !is_pre && deadline <= nj;
          } else {
            dt = fminf(fminf(nj, min_spot), deadline);
            is_spot = min_spot <= fminf(nj, deadline);
            is_deadline = !is_spot && deadline <= nj;
          }
          bool is_b = false;  // a boundary crossing: no queue activity
          if constexpr (ENV) {
            is_b = cur.nb <= dt;
            dt = fminf(dt, cur.nb);
            is_spot = is_spot && !is_b;
            is_pre = is_pre && !is_b;
            is_deadline = is_deadline && !is_b;
          }
          const bool is_job = !is_b && !is_spot && !is_pre && !is_deadline;

          // admission and the pool it joins
          const float budget = x[1];
          bool admit_raw =
              a.admit_code == kThreePhaseAdmit
                  ? (kSplit ? x[3] : u[a.admit_col]) < three_phase_p(pa, qlen)
                  : qlen == 0 && budget > 0.f;
          int choice = __float_as_int(x[2]);
          if (ENV && (a.choice_code == kCheapest || a.choice_code == kFastest))
            choice = sg.fixed;  // the segment's, not the pass's
          if (a.choice_code == kLeastLoaded) {
            int best = qp[0];
            choice = 0;
#pragma unroll
            for (int p = 1; p < kMaxPools; ++p)
              if (p < P && qp[p] < best) { best = qp[p]; choice = p; }
          }
          if constexpr (ENV) {
            // PanicKernel: a dead pool fails over, and with every pool dark
            // the job goes to on-demand
            if (E.panic_choice && !((sg.alive >> choice) & 1u))
              choice = sg.cheapest_alive;
            if (E.panic_admit) admit_raw = admit_raw && sg.alive != 0u;
          }
          const bool admit = is_job && admit_raw && qlen < R;
          const bool od_now = is_job && !admit;
          const bool served = is_spot && has_elig;
          const float price_s = tab[spot_pool];

          // revocation: checkpoint and re-queue, or defect
          const bool pre_hit = is_pre && has_pre;
          bool resume = false;
          if (a.resume_code == kNoticeAware) {
            const int qlen_wo = max(qlen - 1, 0);
            resume = pre_hit && ((within >> pre_pool) & 1u) &&
                     (kSplit ? x[4] : u[a.onpre_col]) <
                         three_phase_p(pa, qlen_wo);
          }
          const bool defect_pre = pre_hit && !resume;
          const bool defected = is_deadline;
          // a serve completes its job only where the remaining work clears
          WorkServe sv{};
          sv.complete = served;
          if constexpr (WORK) {
            const int ks = work_index<G, SPT>(si);
            sv = work_serve(Wk, served, wsl[ks], wsl[wn + ks],
                            wsl[2 * wn + ks]);
          }
          const bool leave = sv.complete || defected || defect_pre;
          const int leave_slot = served ? si : (defected ? di : pi);

#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            ages[j] = ages[j] + dt;
            budgets[j] = (occ >> j) & 1u ? budgets[j] - dt : kInf;
            if constexpr (WORK) life[j] = life[j] + dt;
          }
          const float wait_served = slot_value<G, SPT>(grp, ages, si);
          const float age_defect = slot_value<G, SPT>(grp, ages, di);
          float age_pre = 0.f, price_p = 0.f;
          if (a.preempt_on) {
            age_pre = slot_value<G, SPT>(grp, ages, pi);
            price_p = tab[pre_pool];
          }
          if (a.choice_code == kLeastLoaded) {
            const int dpool = slot_value<G, SPT>(grp, pool, di);
            const int leave_pool = served ? spot_pool
                                          : (defected ? dpool : pre_pool);
#pragma unroll
            for (int p = 0; p < kMaxPools; ++p)
              qp[p] += (admit && p == choice) - (leave && p == leave_pool);
          }
          int tel_loc = 0;  // the event's pool: a deadline's is the job's
          if constexpr (TEL) {
            const int dpool = slot_value<G, SPT>(grp, pool, di);  // all threads
            tel_loc = is_spot ? spot_pool
                              : (is_pre ? pre_pool
                                        : (is_deadline ? dpool : choice));
          }
          // the work: the ledger's slot values (lives after dt, pre-event
          // remainders), the serve's write, a resume's rollback to its
          // checkpoint (saved first, in notice mode, where it fits the pool's
          // notice), a join's zero state
          float life_def = 0.f, life_pre = 0.f, life_srv = 0.f;
          float rem_def = 0.f, rem_pre = 0.f, lost = 0.f, oh_inc = 0.f;
          bool taken = sv.taken, panic = false;
          if constexpr (WORK) {
            life_def = slot_value<G, SPT>(grp, life, di);
            life_srv = slot_value<G, SPT>(grp, life, si);
            panic = Wk.safety && slot_bit<G, SPT>(grp, armed, di) && defected;
            const int kd = work_index<G, SPT>(di);
            rem_def = wsl[wn + kd] + (Wk.total - wsl[kd]);
            if (a.preempt_on) {
              life_pre = slot_value<G, SPT>(grp, life, pi);
              const int kp = work_index<G, SPT>(pi);
              const float prog_p = wsl[kp], ckpt_p = wsl[2 * wn + kp];
              rem_pre = wsl[wn + kp] + (Wk.total - prog_p);
              const bool saved = resume && Wk.mode == kCkptNotice &&
                                 ((wwithin >> pre_pool) & 1u);
              const float ckpt_val = saved ? fmaxf(ckpt_p, prog_p) : ckpt_p;
              if (resume) {
                work_put(wsl, wn, kp, ckpt_val, Wk.overhead, ckpt_val);
                lost = fmaxf(prog_p - ckpt_val, 0.f);
                oh_inc = Wk.overhead;
              }
              taken = taken || saved;
            }
            if (served)
              work_put(wsl, wn, work_index<G, SPT>(si), sv.prog, sv.oh,
                       sv.ckpt);
            if (admit) work_put(wsl, wn, work_index<G, SPT>(fi), 0.f, 0.f, 0.f);
          }
          const int join_j = admit && fi / SPT == t ? fi & (SPT - 1) : -1;
          const int resume_j = resume && pi / SPT == t ? pi & (SPT - 1) : -1;
#pragma unroll
          for (int j = 0; j < SPT; ++j) {
            if (j == join_j) {
              ages[j] = 0.f;
              budgets[j] = budget;
              order[j] = next_seq;
              pool[j] = choice;
              if constexpr (WORK) life[j] = 0.f;
            } else if (j == resume_j) {
              ages[j] = 0.f;
              budgets[j] = kInf;
              order[j] = next_seq;
            }
          }
          if (join_j >= 0) occ |= 1u << join_j;
          if (leave && leave_slot / SPT == t)
            occ &= ~(1u << (leave_slot & (SPT - 1)));

          const bool od_any = od_now || defected || defect_pre;
          jobs_arrived += is_job;
          jobs_completed += od_any || served || resume;
          spot_served += served;
          ondemand += od_any;
          cost_sum = cost_sum + (served ? price_s : 0.f);
          cost_sum = cost_sum + (od_any ? kc : 0.f);
          delay_sum = delay_sum + (served ? wait_served : 0.f);
          delay_sum = delay_sum + (defected ? age_defect : 0.f);
          spot_cost = spot_cost + (served ? price_s : 0.f);
          if (a.preempt_on) {  // without it these add +0.0
            cost_sum = cost_sum + (pre_hit ? price_p : 0.f);
            delay_sum = delay_sum + (pre_hit ? age_pre : 0.f);
            spot_cost = spot_cost + (pre_hit ? price_p : 0.f);
          }
          time_elapsed = time_elapsed + dt;
          empty_time = empty_time + (qlen == 0 ? dt : 0.f);
          spot_arrivals += is_spot;
          spot_found_empty += is_spot && !has_elig;
          resumed += resume;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = t + i * G;
            p_slots[i] += is_spot && spot_pool == q;
            p_served[i] += served && spot_pool == q;
            p_pre[i] += pre_hit && pre_pool == q;
          }

          nj = is_job ? x[0] : nj - dt;
          if constexpr (ENV) {
            if (is_b) {
              // the crossing: survived clocks rescaled exactly, then the new
              // segment's table (the group syncs alone: a branch)
              const size_t row = static_cast<size_t>(cur.seg + 1) * E.n_locs;
#pragma unroll
              for (int p = 0; p < kMaxPools; ++p)
                if (p < P)
                  ns[p] = (ns[p] - dt) * (inv_avail(E.avail[row + p]) / inv[p]);
              if (a.preempt_on && kSplit) {
                // each pool's clock by its own hazards' ratio
#pragma unroll
                for (int p = 0; p < kMaxPools; ++p)
                  if (p < P)
                    npre[p] = (npre[p] - dt) *
                              clock_rescale(hz[p], a.hazard[lp + p] *
                                                       E.hazard[row + p]);
              } else if (a.preempt_on) {
                npre[0] = (npre[0] - dt) *
                          clock_rescale(cum[P - 1],
                                        total_hazard(E, cur.seg + 1, P,
                                                     a.hazard + lp));
              }
              const unsigned gm = group_mask<G>(grp.shift);
              __syncwarp(gm);
              sg = loc_segment(E, cur.seg + 1, P, a.price + lp, a.hazard + lp,
                               a.rate + lp, a.scale + lp, a.choice_code, tab,
                               cum, inv, hz, t == 0);
              __syncwarp(gm);
            } else {
#pragma unroll
              for (int p = 0; p < kMaxPools; ++p)
                if (p < P)
                  ns[p] = is_spot && p == spot_pool ? x[5 + p] * inv[p]
                                                    : ns[p] - dt;
              if (a.preempt_on && kSplit) {
#pragma unroll
                for (int p = 0; p < kMaxPools; ++p) {
                  if (p < P) {
                    const float h = hz[p];
                    npre[p] = is_pre && p == pre_pool
                                  ? (h > 0.f ? x[5 + kMaxPools + p] /
                                                   fmaxf(h, 1e-30f)
                                             : kInf)
                                  : npre[p] - dt;
                  }
                }
              } else if (a.preempt_on) {
                const float total = cum[P - 1];
                npre[0] = is_pre ? (total > 0.f ? x[4] / fmaxf(total, 1e-30f)
                                                : kInf)
                                 : npre[0] - dt;
              }
            }
            env_fold(E, cur, ec, is_b, dt, is_job, od_now, served, resume);
          } else {
#pragma unroll
            for (int p = 0; p < kMaxPools; ++p)
              if (p < P)
                ns[p] = is_spot && p == spot_pool ? x[5 + p] : ns[p] - dt;
            if (a.preempt_on && kSplit) {
#pragma unroll
              for (int p = 0; p < kMaxPools; ++p)
                if (p < P)
                  npre[p] = is_pre && p == pre_pool ? x[5 + kMaxPools + p]
                                                    : npre[p] - dt;
            } else if (a.preempt_on) {
              npre[0] = is_pre ? x[4] : npre[0] - dt;
            }
          }
          next_seq += admit || resume;
          qlen += static_cast<int>(admit) - static_cast<int>(leave);
          if constexpr (WORK)
            work_fold(Wk, wc, is_job, od_now, sv.complete, defected,
                      defect_pre, life_def, rem_def, life_pre, rem_pre,
                      life_srv, panic, taken, sv.done, lost, oh_inc);

          if constexpr (TEL) {
            TelEvent ev;
            ev.type = is_spot       ? kEvSpot
                      : is_pre      ? kEvPreempt
                      : is_deadline ? kEvDeadline
                                    : kEvJob;
            ev.loc = tel_loc;
            ev.qlen = qlen;
            ev.served = served;
            ev.preempt = is_pre;
            ev.resume = resume;
            ev.defected = defected;
            ev.rejected = od_now;
            ev.wait_valid = served || defected || pre_hit;
            ev.wait = served ? wait_served : (defected ? age_defect : age_pre);
            ev.cost_valid = served || od_now || defected || pre_hit;
            ev.cost = (served ? price_s : 0.f) + (od_any ? kc : 0.f);
            ev.cost = ev.cost + (pre_hit ? price_p : 0.f);
            ev.t = time_elapsed;
            tel_fold(tl, ts, e, tc, ev, t == 0);
          }
        }
        if constexpr (TEL)
          tel_pass<G>(tl, ts, n_pass, e0,
                      (static_cast<size_t>(lane) * W + w) * tl.cap, t, live);
      }

      if (live) {
        const size_t o = static_cast<size_t>(lane) * W + w, n = size_t(L) * W;
        if (t == 0) {
          a.istats[0 * n + o] = jobs_arrived;
          a.istats[1 * n + o] = jobs_completed;
          a.istats[2 * n + o] = spot_served;
          a.istats[3 * n + o] = ondemand;
          a.istats[4 * n + o] = spot_arrivals;
          a.istats[5 * n + o] = spot_found_empty;
          a.istats[6 * n + o] = resumed;
          a.fstats[0 * n + o] = cost_sum;
          a.fstats[1 * n + o] = delay_sum;
          a.fstats[2 * n + o] = time_elapsed;
          a.fstats[3 * n + o] = empty_time;
          a.fstats[4 * n + o] = spot_cost;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = t + i * G;
          if (q < P) {
            const size_t po = o * P + q, pn = n * P;
            a.pstats[0 * pn + po] = p_served[i];
            a.pstats[1 * pn + po] = p_slots[i];
            a.pstats[2 * pn + po] = p_pre[i];
          }
        }
      }
      if constexpr (TEL)
        tel_flush<G>(tl, ts, tc, static_cast<size_t>(lane) * W + w,
                     static_cast<size_t>(L) * W, t, live);
      if constexpr (ENV)
        env_flush(E, ec, static_cast<size_t>(lane) * W + w,
                  static_cast<size_t>(L) * W, t == 0 && live);
      if constexpr (WORK)
        work_flush(Wk, wc, static_cast<size_t>(lane) * W + w,
                   static_cast<size_t>(L) * W, t == 0 && live);

      rebase_order<G, SPT>(grp, occ, order, next_seq, s0, R);
    }
  };
  if (a.split)
    run_windows(StreamTag<true>{});
  else
    run_windows(StreamTag<false>{});

  if (!live) return;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (s0 + j < R) {
      const size_t o = static_cast<size_t>(lane) * R + s0 + j;
      a.ages[o] = ages[j];
      a.budgets[o] = budgets[j];
      a.occ[o] = (occ >> j) & 1u;
      a.pool[o] = pool[j];
      a.order[o] = order[j];
    }
  }
  if constexpr (WORK) work_store<G, SPT>(Wk, wsl, life, lane, R, s0, t);
  if (t == 0) {
    a.next_job[lane] = nj;
#pragma unroll
    for (int p = 0; p < kMaxPools; ++p) {
      if (p < P) a.next_spot[lp + p] = ns[p];
      if (a.split ? p < P : p == 0)
        a.next_pre[a.split ? lp + p : lane] = npre[p];
    }
    if (a.split) {
      a.key_out[2 * static_cast<size_t>(lane)] = lk0;
      a.key_out[2 * static_cast<size_t>(lane) + 1] = lk1;
    }
    a.next_seq[lane] = next_seq;
    a.qlen[lane] = qlen;
    if constexpr (ENV) {
      E.nb[lane] = cur.nb;
      E.seg[lane] = cur.seg;
    }
  }
}

template <int G, int SPT>
cudaError_t market_launch_gs(const MArgs& a, const TelArgs& tl,
                             const EnvArgs& E, const WorkArgs& Wk,
                             int warps_per_block, cudaStream_t s) {
  const int lanes_per_block = warps_per_block * 32 / G;
  const dim3 grid((a.lanes + lanes_per_block - 1) / lanes_per_block);
  const dim3 block(warps_per_block * 32);
  const size_t smem =
      sizeof(float) * lanes_per_block *
          (kLaneStride + market_sample_stride(a.split) + kTab) +
      tel_smem(tl, lanes_per_block, kMarketPass) +
      work_smem(lanes_per_block, G * SPT);
  cudaError_t err = cudaFuncSetAttribute(
      market_kernel<G, SPT, kTel, kEnv, kWork>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  market_kernel<G, SPT, kTel, kEnv, kWork><<<grid, block, smem, s>>>(a, tl, E,
                                                                    Wk);
  return cudaGetLastError();
}

// the (G, SPT) pairs sweep.py::group_size picks, and no other
cudaError_t market_launch_g(const MArgs& a, const TelArgs& tl,
                            const EnvArgs& E, const WorkArgs& Wk, int group,
                            int spt, int warps_per_block, cudaStream_t s) {
  if (group == 4) {
    switch (spt) {
      case 1: return market_launch_gs<4, 1>(a, tl, E, Wk, warps_per_block, s);
      case 2: return market_launch_gs<4, 2>(a, tl, E, Wk, warps_per_block, s);
      case 4: return market_launch_gs<4, 4>(a, tl, E, Wk, warps_per_block, s);
      case 8: return market_launch_gs<4, 8>(a, tl, E, Wk, warps_per_block, s);
    }
  } else if (spt == 8) {
    switch (group) {
      case 8: return market_launch_gs<8, 8>(a, tl, E, Wk, warps_per_block, s);
      case 16: return market_launch_gs<16, 8>(a, tl, E, Wk, warps_per_block, s);
      case 32: return market_launch_gs<32, 8>(a, tl, E, Wk, warps_per_block, s);
    }
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// N-region routing (repro/core/engine.py::_region_event on the slab stream;
// plain version ../ref.py::region_event_windows_ref, wrapper
// ../sweep.py::region_event_windows)
// ---------------------------------------------------------------------------
// The market's design one level up: a lane on G threads, its slot state in
// registers across windows, the slab drawn a pass ahead into shared memory
// and every draw the event chain needs sampled there first.  What the
// region loop adds a lane-event: R job clocks beside the R spot clocks
// (registers, the same on every thread of the group), each merged by an
// argmin whose ties go to the lowest region; a static, ragged slot
// partition (region r owns slots [offset_r, offset_r + rmax_r) of the
// packed array; the R + 1 offsets are a run constant in the lane's shared
// table), so that the two masked FIFO reductions and the join take the
// region's slot bits, two offsets and a few integer operations a thread,
// where the market reads a tag a slot; routing before admission (cheapest
// and fastest fixed a lane, least_loaded an argmin over the per-region
// queue lengths, uniform and weighted drawn in the sample pass); admission
// against the target region's queue length and capacity, into the first
// free slot of its partition; the per-region queue lengths kept by
// increments; five per-region counters on the thread that owns the region
// (region q on thread q % G).  Every region's job (and spot) draw
// transforms the same slab columns, scaled by its job (spot) scale, all in
// the sample pass.  R is a bound of the run (at most kMaxRegions) with
// unrolled, guarded loops, as the market's P, so the library holds the same
// seven (G, SPT) builds.
constexpr int kMaxRegions = 8;
// floats an event's samples take: wait budget, route (int bits), revoked
// region (int bits), preemption clock, R job draws, R spot draws
constexpr int kREv = 4 + 2 * kMaxRegions;
constexpr int kRSampleStride = kMarketPass * kREv + 1;
// a lane's region table: price, job scale, spot scale, the hazards'
// running sums and logits (kMaxRegions each), then the R + 1 partition
// offsets (int bits), and with the environment 1/avail (prices and hazards
// then the segment's effective ones)
constexpr int kRInv = 5 * kMaxRegions + kMaxRegions + 1;
constexpr int kRTab = kRInv + (kEnv ? kMaxRegions : 0);

struct RArgs {
  // initial state, per lane (clocks and queue lengths lanes x R, slot
  // arrays lanes x S, S the sum of the regions' rmax)
  const float* next_job0;
  const float* next_spot0;
  const float* next_pre0;
  const float* ages0;
  const float* budgets0;
  const uint8_t* occ0;
  const int32_t* order0;
  const int32_t* next_seq0;
  const int32_t* qlen0;
  const uint32_t* win_keys;  // lanes x windows x 2
  const int32_t* plan;
  const float* k_cost;  // per lane
  const float* pa;      // per lane: r, or the wait family's first param
  const float* pb;      // per lane: the wait family's second param
  const float* ckpt;    // per lane: checkpoint time (notice-aware kernels)
  // the regions config, lanes x R each (logits only for the weighted rule)
  const float* price;
  const float* hazard;
  const float* notice;
  const float* rate;
  const float* spot_scale;
  const float* job_scale;
  const float* logits;
  // final state
  float* next_job;
  float* next_spot;
  float* next_pre;
  float* ages;
  float* budgets;
  uint8_t* occ;
  int32_t* order;
  int32_t* next_seq;
  int32_t* qlen;
  int32_t* istats;  // 8 x lanes x windows
  float* fstats;    // 5 x lanes x windows
  int32_t* rstats;  // 5 x lanes x windows x R
  int lanes, n_slots, n_windows, n_cols, n_regions;
  int admit_code, wait_code, route_code, resume_code, preempt_on;
  int any_exp_job, any_exp_spot;
  int job_col, spot_col, admit_col, route_col, pre_col, onpre_col;
  int offset[kMaxRegions + 1];
  int job_code[kMaxRegions], job_n[kMaxRegions];
  int spot_code[kMaxRegions], spot_n[kMaxRegions];
  float job_c[kMaxRegions][4], spot_c[kMaxRegions][4];
};

// v[i] of a region vector held in registers (i the same on every thread)
template <typename T>
__device__ __forceinline__ T region_value(const T (&v)[kMaxRegions], int i) {
  T out = v[0];
#pragma unroll
  for (int r = 1; r < kMaxRegions; ++r)
    if (r == i) out = v[r];
  return out;
}

// this thread's slot bits (bit j: slot s0 + j) in region r's partition
template <int SPT>
__device__ __forceinline__ unsigned region_bits(const int* off, int r,
                                                int s0) {
  const int lo = min(max(off[r] - s0, 0), SPT);
  const int hi = min(max(off[r + 1] - s0, 0), SPT);
  return ((1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// the samples of the pass's n events (kREv floats each in x_s) from their
// slab rows in u_s; thread t takes events t, t + G, ...  With ENV the pass
// leaves the revoked region to the chain and stores the preemption clock's
// unit exponential alone.
template <int G, bool ENV>
__device__ __forceinline__ void region_sample_pass(
    float* x_s, const float* u_s, const float* tab, int n, int nc,
    const RArgs& a, float pa, float pb, int t) {
  const int R = a.n_regions;
  for (int e = t; e < n; e += G) {
    const float* u = u_s + e * nc;
    float* x = x_s + e * kREv;
    const int off[1] = {e * nc};
    float out[1] = {kInf};
    if (a.admit_code == kSingleSlotAdmit)
      sample_waits<1>(a.wait_code, pa, pb, u_s, off, a.admit_col, out);
    x[0] = out[0];
    int route = 0;
    if (a.route_code == kUniformChoice) {
      route = min(static_cast<int>(u[a.route_col] * static_cast<float>(R)),
                  R - 1);
    } else if (a.route_code == kWeighted) {
      float best = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxRegions; ++r) {
        if (r < R) {
          const float g =
              -logf(-logf(fmaxf(u[a.route_col + r], 1e-12f)));
          const float v = tab[4 * kMaxRegions + r] + g;
          if (r == 0 || v > best) {
            best = v;
            route = r;
          }
        }
      }
    }
    x[1] = __int_as_float(route);
    if (ENV) {
      if (a.preempt_on) x[3] = exp_from_u(u[a.pre_col]);
    } else if (a.preempt_on) {
      const float total = tab[3 * kMaxRegions + R - 1];
      const float xu = u[a.pre_col + 1] * total;
      int pick = 0;
#pragma unroll
      for (int r = 0; r < kMaxRegions - 1; ++r)
        if (r < R - 1) pick += xu >= tab[3 * kMaxRegions + r];
      x[2] = __int_as_float(min(pick, R - 1));
      x[3] = total > 0.f ? exp_from_u(u[a.pre_col]) / fmaxf(total, 1e-30f)
                         : kInf;
    }
    // every region transforms the same job (spot) columns
    const float unit_job = a.any_exp_job ? exp_from_u(u[a.job_col]) : 0.f;
    const float unit_spot = a.any_exp_spot ? exp_from_u(u[a.spot_col]) : 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRegions; ++r) {
      if (r < R) {
        float d;
        if (a.job_code[r] == kExponential) {
          d = unit_job * a.job_c[r][0];
        } else {
          sample_arrivals<1>(a.job_code[r], a.job_c[r], a.job_n[r], u_s, off,
                             a.job_col, out);
          d = out[0];
        }
        x[4 + r] = d * tab[kMaxRegions + r];
        if (a.spot_code[r] == kExponential) {
          d = unit_spot * a.spot_c[r][0];
        } else {
          sample_arrivals<1>(a.spot_code[r], a.spot_c[r], a.spot_n[r], u_s,
                             off, a.spot_col, out);
          d = out[0];
        }
        x[4 + kMaxRegions + r] = d * tab[2 * kMaxRegions + r];
      }
    }
  }
}

template <int G, int SPT, bool TEL, bool ENV, bool WORK>
__global__ void region_kernel(const RArgs a, const TelArgs tl,
                              const EnvArgs E, const WorkArgs Wk) {
  extern __shared__ float smem[];
  const LaneGroup<G> grp(threadIdx.x & 31);
  const int t = grp.t;
  const int lane_in_block = threadIdx.x / G;
  const int lanes_per_block = blockDim.x / G;
  const int lane0 = blockIdx.x * lanes_per_block + lane_in_block;
  // lanes past the fleet run a copy of the last lane and store nothing
  const bool live = lane0 < a.lanes;
  const int lane = live ? lane0 : a.lanes - 1;
  const int S = a.n_slots, W = a.n_windows, L = a.lanes, nc = a.n_cols;
  const int R = a.n_regions;
  const int per_pass = min(kDraws / nc, kMarketPass);
  float* u_s = smem + lane_in_block * kLaneStride;
  float* x_s = smem + lanes_per_block * kLaneStride +
               lane_in_block * kRSampleStride;
  float* tab = smem + lanes_per_block * (kLaneStride + kRSampleStride) +
               lane_in_block * kRTab;
  int* off = reinterpret_cast<int*>(tab + 5 * kMaxRegions);
  const float kc = a.k_cost[lane], pa = a.pa[lane], pb = a.pb[lane];
  const int s0 = t * SPT;
  int* ts = nullptr;  // the lane's telemetry slice
  TelCounts tc;       // ... and its counters
  if constexpr (TEL)
    ts = tel_slice<G>(smem,
                      lanes_per_block * (kLaneStride + kRSampleStride + kRTab),
                      lane_in_block, tl.n_bins, kMarketPass, t);

  // the lane's region table, and what depends on it alone
  const size_t lr = static_cast<size_t>(lane) * R;
  for (int r = t; r < R; r += G) {
    tab[r] = a.price[lr + r];
    tab[kMaxRegions + r] = a.job_scale[lr + r];
    tab[2 * kMaxRegions + r] = a.spot_scale[lr + r];
    tab[4 * kMaxRegions + r] = a.logits ? a.logits[lr + r] : 0.f;
  }
  if (t == 0) {
    float cum = a.hazard[lr];
    tab[3 * kMaxRegions] = cum;
    for (int r = 1; r < R; ++r) {
      cum = cum + a.hazard[lr + r];
      tab[3 * kMaxRegions + r] = cum;
    }
#pragma unroll
    for (int r = 0; r <= kMaxRegions; ++r)
      if (r <= R) off[r] = a.offset[r];
  }
  __syncwarp();
  int fixed_route = 0;  // cheapest / fastest: first index on ties
  unsigned within = 0;  // bit r: a checkpoint fits region r's notice
  unsigned wwithin = 0;  // ... the work model's checkpoint (the base notice)
  {
    const float ck = a.ckpt[lane];
    float best = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRegions; ++r) {
      if (r < R) {
        if (a.route_code == kCheapest) {
          const float v = tab[r];
          if (r == 0 || v < best) { best = v; fixed_route = r; }
        } else if (a.route_code == kFastest) {
          const float v = a.rate[lr + r] / tab[2 * kMaxRegions + r];
          if (r == 0 || v > best) { best = v; fixed_route = r; }
        }
        within |= static_cast<unsigned>(ck <= a.notice[lr + r]) << r;
        if constexpr (WORK)
          wwithin |= static_cast<unsigned>(Wk.ckpt_time <= a.notice[lr + r])
                     << r;
      }
    }
  }
  // the environment: the lane's cursor and counts, and what its segment
  // fixes (the table's prices, running sums and 1/avail are the segment's)
  EnvCursor cur{};
  EnvCounts ec;
  LocSeg sg{0, 0, 0u};
  float* const cum = tab + 3 * kMaxRegions;
  float* const inv = tab + kRInv;
  if constexpr (ENV) {
    cur = env_cursor(E, lane);
    sg = loc_segment(E, cur.seg, R, a.price + lr, a.hazard + lr, a.rate + lr,
                     a.spot_scale + lr, a.route_code, tab, cum, inv, nullptr,
                     t == 0);
    __syncwarp();
  }

  float nj[kMaxRegions], ns[kMaxRegions];
  int qr[kMaxRegions];  // queued jobs a region
  int qtot = 0;         // ... and in all
#pragma unroll
  for (int r = 0; r < kMaxRegions; ++r) {
    nj[r] = r < R ? a.next_job0[lr + r] : kInf;
    ns[r] = r < R ? a.next_spot0[lr + r] : kInf;
    qr[r] = r < R ? a.qlen0[lr + r] : 0;
    qtot += qr[r];
  }
  // the work structure: the lane's slice, its ledger and the slots' lives
  constexpr int wn = G * SPT;
  float* wsl = nullptr;
  WorkCounts wc;
  float life[WORK ? SPT : 1];
  if constexpr (WORK) {
    wsl = work_slice<G, SPT>(
        Wk, smem,
        lanes_per_block * (kLaneStride + kRSampleStride + kRTab) +
            (TEL ? size_t(lanes_per_block) *
                       tel_stride(tl.n_bins, kMarketPass)
                 : 0),
        lane_in_block, lane, S, s0, t);
#pragma unroll
    for (int j = 0; j < SPT; ++j)
      life[j] = s0 + j < S ? Wk.life0[static_cast<size_t>(lane) * S + s0 + j]
                           : 0.f;
  }
  float npre = a.next_pre0[lane];
  int next_seq = a.next_seq0[lane];
  float ages[SPT], budgets[SPT];
  int order[SPT];
  unsigned occ = 0;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    ages[j] = 0.f;
    budgets[j] = kInf;
    order[j] = 0;
    if (s0 + j < S) {
      const size_t o = static_cast<size_t>(lane) * S + s0 + j;
      ages[j] = a.ages0[o];
      budgets[j] = a.budgets0[o];
      occ |= static_cast<unsigned>(a.occ0[o] != 0) << j;
      order[j] = a.order0[o];
    }
  }

  for (int w = 0; w < W; ++w) {
    const size_t kw = (static_cast<size_t>(lane) * W + w) * 2;
    const uint32_t k0 = a.win_keys[kw], k1 = a.win_keys[kw + 1];
    const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
    const int n_ev = a.plan[w];
    int jobs_arrived = 0, jobs_completed = 0, spot_served = 0, ondemand = 0;
    int spot_arrivals = 0, spot_found_empty = 0, resumed = 0;
    int routed_home = 0;
    float cost_sum = 0.f, delay_sum = 0.f, time_elapsed = 0.f;
    float empty_time = 0.f, spot_cost = 0.f;
    // regions q = t and t + G of this thread: served, slots, revocations,
    // arrivals by home, admissions by target
    int r_served[2] = {0, 0}, r_slots[2] = {0, 0}, r_pre[2] = {0, 0};
    int r_jobs[2] = {0, 0}, r_routed[2] = {0, 0};

    for (int e0 = 0; e0 < n_ev; e0 += per_pass) {
      const int n_pass = min(per_pass, n_ev - e0);
      __syncwarp();
      draw_pass<G>(u_s, n_pass * nc, static_cast<uint32_t>(e0) * nc, k0, k1,
                   k2, t);
      __syncwarp();
      region_sample_pass<G, ENV>(x_s, u_s, tab, n_pass, nc, a, pa, pb, t);
      __syncwarp();

      for (int e = 0; e < n_pass; ++e) {
        const float* u = u_s + e * nc;
        const float* x = x_s + e * kREv;

        // the home region (the earliest job clock) and the firing spot
        // region, the lowest on ties; the revoked region; the route
        float min_job = nj[0], min_spot = ns[0];
        int home = 0, spot_r = 0;
#pragma unroll
        for (int r = 1; r < kMaxRegions; ++r) {
          if (r < R) {
            if (nj[r] < min_job) { min_job = nj[r]; home = r; }
            if (ns[r] < min_spot) { min_spot = ns[r]; spot_r = r; }
          }
        }
        int pre_r = 0;
        if (a.preempt_on)
          pre_r = ENV ? thinning_pick(cum, R, u[a.pre_col + 1])
                      : __float_as_int(x[2]);
        int target = home;
        if (a.route_code == kCheapest || a.route_code == kFastest) {
          target = ENV ? sg.fixed : fixed_route;
        } else if (a.route_code == kLeastLoaded) {
          int best = qr[0];
          target = 0;
#pragma unroll
          for (int r = 1; r < kMaxRegions; ++r)
            if (r < R && qr[r] < best) { best = qr[r]; target = r; }
        } else if (a.route_code != kPoolZero) {  // uniform, weighted
          target = __float_as_int(x[1]);
        }
        if constexpr (ENV) {
          // PanicKernel's route: a dead region fails over
          if (E.panic_choice && !((sg.alive >> target) & 1u))
            target = sg.cheapest_alive;
        }

        // pre-event slot reductions: deadline, the oldest job of the spot
        // region, the oldest of the revoked region, the target's first
        // free slot
        const unsigned s_bits = occ & region_bits<SPT>(off, spot_r, s0);
        const unsigned p_bits = occ & region_bits<SPT>(off, pre_r, s0);
        const unsigned free_bits = ~occ & region_bits<SPT>(off, target, s0);
        int bkey[SPT], skey[SPT], pkey[SPT];
        unsigned armed = 0;  // bit j: slot s0 + j's panic clock won
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          const bool o = (occ >> j) & 1u;
          float b = o ? budgets[j] : kInf;
          if constexpr (WORK) {
            if (Wk.safety && o) {
              const int k = j * G + t;
              const float pk = panic_clock(Wk, life[j], wsl[k], wsl[wn + k]);
              armed |= static_cast<unsigned>(pk < b) << j;
              b = fminf(b, pk);
            }
          }
          bkey[j] = __float_as_int(b);
          skey[j] = (s_bits >> j) & 1u ? order[j] : kOrderMax;
          pkey[j] = (p_bits >> j) & 1u ? order[j] : kOrderMax;
        }
        int bmin = bkey[0], smin = skey[0], pmin = pkey[0];
#pragma unroll
        for (int j = 1; j < SPT; ++j) {
          bmin = min(bmin, bkey[j]);
          smin = min(smin, skey[j]);
          pmin = min(pmin, pkey[j]);
        }
        bmin = grp.reduce_min(bmin);
        smin = grp.reduce_min(smin);
        const int di = first_equal<G, SPT>(grp, bkey, bmin);
        const int si = first_equal<G, SPT>(grp, skey, smin);
        const bool has_elig = grp.first(s_bits != 0) < G;
        int pi = 0;
        bool has_pre = false;
        if (a.preempt_on) {
          pmin = grp.reduce_min(pmin);
          pi = first_equal<G, SPT>(grp, pkey, pmin);
          has_pre = grp.first(p_bits != 0) < G;
        }
        const int owner = grp.first(free_bits != 0);
        const int fj = free_bits ? __ffs(free_bits) - 1 : 0;
        const int fi = owner * SPT + grp.from(fj, owner & (G - 1));
        const float deadline = __int_as_float(bmin);

        // ties resolve spot > preempt > deadline > job
        float dt;
        bool is_spot, is_pre = false, is_deadline;
        if (a.preempt_on) {
          dt = fminf(fminf(min_job, min_spot), fminf(deadline, npre));
          is_spot = min_spot <= fminf(min_job, fminf(deadline, npre));
          is_pre = !is_spot && npre <= fminf(min_job, deadline);
          is_deadline = !is_spot && !is_pre && deadline <= min_job;
        } else {
          dt = fminf(fminf(min_job, min_spot), deadline);
          is_spot = min_spot <= fminf(min_job, deadline);
          is_deadline = !is_spot && deadline <= min_job;
        }
        bool is_b = false;  // a boundary crossing: no queue activity
        if constexpr (ENV) {
          is_b = cur.nb <= dt;
          dt = fminf(dt, cur.nb);
          is_spot = is_spot && !is_b;
          is_pre = is_pre && !is_b;
          is_deadline = is_deadline && !is_b;
        }
        const bool is_job = !is_b && !is_spot && !is_pre && !is_deadline;

        // admission against the target region's queue and capacity
        const int qlen_t = region_value(qr, target);
        const int rmax_t = off[target + 1] - off[target];
        const float budget = x[0];
        bool admit_raw = a.admit_code == kThreePhaseAdmit
                             ? u[a.admit_col] < three_phase_p(pa, qlen_t)
                             : qlen_t == 0 && budget > 0.f;
        if constexpr (ENV) {
          // PanicKernel's admission: with every region dark the job goes
          // to on-demand
          if (E.panic_admit) admit_raw = admit_raw && sg.alive != 0u;
        }
        const bool admit = is_job && admit_raw && qlen_t < rmax_t;
        const bool od_now = is_job && !admit;
        const bool served = is_spot && has_elig;
        const float price_s = tab[spot_r];

        // revocation: checkpoint and re-queue, or defect
        const bool pre_hit = is_pre && has_pre;
        bool resume = false;
        if (a.resume_code == kNoticeAware) {
          const int qlen_wo = max(region_value(qr, pre_r) - 1, 0);
          resume = pre_hit && ((within >> pre_r) & 1u) &&
                   u[a.onpre_col] < three_phase_p(pa, qlen_wo);
        }
        const bool defect_pre = pre_hit && !resume;
        const bool defected = is_deadline;
        // a serve completes its job only where the remaining work clears
        WorkServe sv{};
        sv.complete = served;
        if constexpr (WORK) {
          const int ks = work_index<G, SPT>(si);
          sv = work_serve(Wk, served, wsl[ks], wsl[wn + ks],
                          wsl[2 * wn + ks]);
        }
        const bool leave = sv.complete || defected || defect_pre;
        const int leave_slot = served ? si : (defected ? di : pi);
        int leave_r = served ? spot_r : pre_r;  // the region it leaves
        if (defected) {
          leave_r = 0;
#pragma unroll
          for (int r = 1; r < kMaxRegions; ++r)
            if (r < R) leave_r += di >= off[r];
        }

#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          ages[j] = ages[j] + dt;
          budgets[j] = (occ >> j) & 1u ? budgets[j] - dt : kInf;
          if constexpr (WORK) life[j] = life[j] + dt;
        }
        const float wait_served = slot_value<G, SPT>(grp, ages, si);
        const float age_defect = slot_value<G, SPT>(grp, ages, di);
        float age_pre = 0.f, price_p = 0.f;
        if (a.preempt_on) {
          age_pre = slot_value<G, SPT>(grp, ages, pi);
          price_p = tab[pre_r];
        }
        // the work, as the market's (a resume's checkpoint fits the
        // region's notice)
        float life_def = 0.f, life_pre = 0.f, life_srv = 0.f;
        float rem_def = 0.f, rem_pre = 0.f, lost = 0.f, oh_inc = 0.f;
        bool taken = sv.taken, panic = false;
        if constexpr (WORK) {
          life_def = slot_value<G, SPT>(grp, life, di);
          life_srv = slot_value<G, SPT>(grp, life, si);
          panic = Wk.safety && slot_bit<G, SPT>(grp, armed, di) && defected;
          const int kd = work_index<G, SPT>(di);
          rem_def = wsl[wn + kd] + (Wk.total - wsl[kd]);
          if (a.preempt_on) {
            life_pre = slot_value<G, SPT>(grp, life, pi);
            const int kp = work_index<G, SPT>(pi);
            const float prog_p = wsl[kp], ckpt_p = wsl[2 * wn + kp];
            rem_pre = wsl[wn + kp] + (Wk.total - prog_p);
            const bool saved = resume && Wk.mode == kCkptNotice &&
                               ((wwithin >> pre_r) & 1u);
            const float ckpt_val = saved ? fmaxf(ckpt_p, prog_p) : ckpt_p;
            if (resume) {
              work_put(wsl, wn, kp, ckpt_val, Wk.overhead, ckpt_val);
              lost = fmaxf(prog_p - ckpt_val, 0.f);
              oh_inc = Wk.overhead;
            }
            taken = taken || saved;
          }
          if (served)
            work_put(wsl, wn, work_index<G, SPT>(si), sv.prog, sv.oh,
                     sv.ckpt);
          if (admit) work_put(wsl, wn, work_index<G, SPT>(fi), 0.f, 0.f, 0.f);
        }
        const int join_j = admit && fi / SPT == t ? fi & (SPT - 1) : -1;
        const int resume_j = resume && pi / SPT == t ? pi & (SPT - 1) : -1;
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          if (j == join_j) {
            ages[j] = 0.f;
            budgets[j] = budget;
            order[j] = next_seq;
            if constexpr (WORK) life[j] = 0.f;
          } else if (j == resume_j) {
            ages[j] = 0.f;
            budgets[j] = kInf;
            order[j] = next_seq;
          }
        }
        if (join_j >= 0) occ |= 1u << join_j;
        if (leave && leave_slot / SPT == t)
          occ &= ~(1u << (leave_slot & (SPT - 1)));

        const bool od_any = od_now || defected || defect_pre;
        jobs_arrived += is_job;
        jobs_completed += od_any || served || resume;
        spot_served += served;
        ondemand += od_any;
        cost_sum = cost_sum + (served ? price_s : 0.f);
        cost_sum = cost_sum + (od_any ? kc : 0.f);
        delay_sum = delay_sum + (served ? wait_served : 0.f);
        delay_sum = delay_sum + (defected ? age_defect : 0.f);
        spot_cost = spot_cost + (served ? price_s : 0.f);
        if (a.preempt_on) {  // without it these add +0.0
          cost_sum = cost_sum + (pre_hit ? price_p : 0.f);
          delay_sum = delay_sum + (pre_hit ? age_pre : 0.f);
          spot_cost = spot_cost + (pre_hit ? price_p : 0.f);
        }
        time_elapsed = time_elapsed + dt;
        empty_time = empty_time + (qtot == 0 ? dt : 0.f);
        spot_arrivals += is_spot;
        spot_found_empty += is_spot && !has_elig;
        resumed += resume;
        routed_home += admit && target == home;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int q = t + i * G;
          r_slots[i] += is_spot && spot_r == q;
          r_served[i] += served && spot_r == q;
          r_pre[i] += pre_hit && pre_r == q;
          r_jobs[i] += is_job && home == q;
          r_routed[i] += admit && target == q;
        }

#pragma unroll
        for (int r = 0; r < kMaxRegions; ++r) {
          if (r < R) {
            nj[r] = is_job && r == home ? x[4 + r] : nj[r] - dt;
            if (!ENV)
              ns[r] = is_spot && r == spot_r ? x[4 + kMaxRegions + r]
                                             : ns[r] - dt;
            qr[r] += static_cast<int>(admit && r == target) -
                     static_cast<int>(leave && r == leave_r);
          }
        }
        if constexpr (ENV) {
          if (is_b) {
            // the crossing: survived spot and preemption clocks rescaled
            // exactly (the job clocks are never modulated), then the new
            // segment's table (the group syncs alone: a branch)
            const size_t row = static_cast<size_t>(cur.seg + 1) * E.n_locs;
#pragma unroll
            for (int r = 0; r < kMaxRegions; ++r)
              if (r < R)
                ns[r] = (ns[r] - dt) * (inv_avail(E.avail[row + r]) / inv[r]);
            if (a.preempt_on)
              npre = (npre - dt) *
                     clock_rescale(cum[R - 1], total_hazard(E, cur.seg + 1, R,
                                                            a.hazard + lr));
            const unsigned gm = group_mask<G>(grp.shift);
            __syncwarp(gm);
            sg = loc_segment(E, cur.seg + 1, R, a.price + lr, a.hazard + lr,
                             a.rate + lr, a.spot_scale + lr, a.route_code,
                             tab, cum, inv, nullptr, t == 0);
            __syncwarp(gm);
          } else {
#pragma unroll
            for (int r = 0; r < kMaxRegions; ++r)
              if (r < R)
                ns[r] = is_spot && r == spot_r
                            ? x[4 + kMaxRegions + r] * inv[r]
                            : ns[r] - dt;
            if (a.preempt_on) {
              const float total = cum[R - 1];
              npre = is_pre ? (total > 0.f ? x[3] / fmaxf(total, 1e-30f)
                                           : kInf)
                            : npre - dt;
            }
          }
          env_fold(E, cur, ec, is_b, dt, is_job, od_now, served, resume);
        } else if (a.preempt_on) {
          npre = is_pre ? x[3] : npre - dt;
        }
        next_seq += admit || resume;
        qtot += static_cast<int>(admit) - static_cast<int>(leave);
        if constexpr (WORK)
          work_fold(Wk, wc, is_job, od_now, sv.complete, defected,
                    defect_pre, life_def, rem_def, life_pre, rem_pre,
                    life_srv, panic, taken, sv.done, lost, oh_inc);

        if constexpr (TEL) {
          TelEvent ev;
          ev.type = is_spot       ? kEvSpot
                    : is_pre      ? kEvPreempt
                    : is_deadline ? kEvDeadline
                                  : kEvJob;
          // a job event's region is its target, a deadline's the
          // defecting job's (leave_r); a crossing's is the target too
          ev.loc = is_job || is_b ? target
                                  : (is_spot ? spot_r
                                             : (is_pre ? pre_r : leave_r));
          ev.qlen = qtot;
          ev.served = served;
          ev.preempt = is_pre;
          ev.resume = resume;
          ev.defected = defected;
          ev.rejected = od_now;
          ev.wait_valid = served || defected || pre_hit;
          ev.wait = served ? wait_served : (defected ? age_defect : age_pre);
          ev.cost_valid = served || od_now || defected || pre_hit;
          ev.cost = (served ? price_s : 0.f) + (od_any ? kc : 0.f);
          ev.cost = ev.cost + (pre_hit ? price_p : 0.f);
          ev.t = time_elapsed;
          tel_fold(tl, ts, e, tc, ev, t == 0);
        }
      }
      if constexpr (TEL)
        tel_pass<G>(tl, ts, n_pass, e0,
                    (static_cast<size_t>(lane) * W + w) * tl.cap, t, live);
    }

    if (live) {
      const size_t o = static_cast<size_t>(lane) * W + w, n = size_t(L) * W;
      if (t == 0) {
        a.istats[0 * n + o] = jobs_arrived;
        a.istats[1 * n + o] = jobs_completed;
        a.istats[2 * n + o] = spot_served;
        a.istats[3 * n + o] = ondemand;
        a.istats[4 * n + o] = spot_arrivals;
        a.istats[5 * n + o] = spot_found_empty;
        a.istats[6 * n + o] = resumed;
        a.istats[7 * n + o] = routed_home;
        a.fstats[0 * n + o] = cost_sum;
        a.fstats[1 * n + o] = delay_sum;
        a.fstats[2 * n + o] = time_elapsed;
        a.fstats[3 * n + o] = empty_time;
        a.fstats[4 * n + o] = spot_cost;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = t + i * G;
        if (q < R) {
          const size_t ro = o * R + q, rn = n * R;
          a.rstats[0 * rn + ro] = r_served[i];
          a.rstats[1 * rn + ro] = r_slots[i];
          a.rstats[2 * rn + ro] = r_pre[i];
          a.rstats[3 * rn + ro] = r_jobs[i];
          a.rstats[4 * rn + ro] = r_routed[i];
        }
      }
    }
    if constexpr (TEL)
      tel_flush<G>(tl, ts, tc, static_cast<size_t>(lane) * W + w,
                   static_cast<size_t>(L) * W, t, live);
    if constexpr (ENV)
      env_flush(E, ec, static_cast<size_t>(lane) * W + w,
                static_cast<size_t>(L) * W, t == 0 && live);
    if constexpr (WORK)
      work_flush(Wk, wc, static_cast<size_t>(lane) * W + w,
                 static_cast<size_t>(L) * W, t == 0 && live);

    rebase_order<G, SPT>(grp, occ, order, next_seq, s0, S);
  }

  if (!live) return;
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    if (s0 + j < S) {
      const size_t o = static_cast<size_t>(lane) * S + s0 + j;
      a.ages[o] = ages[j];
      a.budgets[o] = budgets[j];
      a.occ[o] = (occ >> j) & 1u;
      a.order[o] = order[j];
    }
  }
  if constexpr (WORK) work_store<G, SPT>(Wk, wsl, life, lane, S, s0, t);
  if (t == 0) {
    a.next_pre[lane] = npre;
    a.next_seq[lane] = next_seq;
    if constexpr (ENV) {
      E.nb[lane] = cur.nb;
      E.seg[lane] = cur.seg;
    }
#pragma unroll
    for (int r = 0; r < kMaxRegions; ++r) {
      if (r < R) {
        a.next_job[lr + r] = nj[r];
        a.next_spot[lr + r] = ns[r];
        a.qlen[lr + r] = qr[r];
      }
    }
  }
}

template <int G, int SPT>
cudaError_t region_launch_gs(const RArgs& a, const TelArgs& tl,
                             const EnvArgs& E, const WorkArgs& Wk,
                             int warps_per_block, cudaStream_t s) {
  const int lanes_per_block = warps_per_block * 32 / G;
  const dim3 grid((a.lanes + lanes_per_block - 1) / lanes_per_block);
  const dim3 block(warps_per_block * 32);
  const size_t smem = sizeof(float) * lanes_per_block *
                          (kLaneStride + kRSampleStride + kRTab) +
                      tel_smem(tl, lanes_per_block, kMarketPass) +
                      work_smem(lanes_per_block, G * SPT);
  cudaError_t err = cudaFuncSetAttribute(
      region_kernel<G, SPT, kTel, kEnv, kWork>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  region_kernel<G, SPT, kTel, kEnv, kWork><<<grid, block, smem, s>>>(a, tl, E,
                                                                    Wk);
  return cudaGetLastError();
}

// the (G, SPT) pairs sweep.py::group_size picks, and no other
cudaError_t region_launch_g(const RArgs& a, const TelArgs& tl,
                            const EnvArgs& E, const WorkArgs& Wk, int group,
                            int spt, int warps_per_block, cudaStream_t s) {
  if (group == 4) {
    switch (spt) {
      case 1: return region_launch_gs<4, 1>(a, tl, E, Wk, warps_per_block, s);
      case 2: return region_launch_gs<4, 2>(a, tl, E, Wk, warps_per_block, s);
      case 4: return region_launch_gs<4, 4>(a, tl, E, Wk, warps_per_block, s);
      case 8: return region_launch_gs<4, 8>(a, tl, E, Wk, warps_per_block, s);
    }
  } else if (spt == 8) {
    switch (group) {
      case 8: return region_launch_gs<8, 8>(a, tl, E, Wk, warps_per_block, s);
      case 16: return region_launch_gs<16, 8>(a, tl, E, Wk, warps_per_block, s);
      case 32: return region_launch_gs<32, 8>(a, tl, E, Wk, warps_per_block, s);
    }
  }
  return cudaErrorInvalidValue;
}

// the telemetry arguments of a launch: tel_ptrs the 12 pointers of TelArgs
// in order, tel_icfg n_bins, n_locs, cap, tel_fcfg the wait and cost bins'
// log lo and inv; false where they do not fit this build (the telemetry
// build needs them, the other takes none) or the kernel's bounds
bool tel_args(const int64_t* tel_ptrs, const int32_t* tel_icfg,
              const float* tel_fcfg, TelArgs* tl) {
  *tl = TelArgs{};
  if ((tel_ptrs != nullptr) != kTel) return false;
  if (!kTel) return true;
  int i = 0;
  tl->wait_hist = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->cost_hist = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->events = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->counters = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->loc_defects = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->loc_resumed = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->ring_t = reinterpret_cast<float*>(tel_ptrs[i++]);
  tl->ring_type = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->ring_loc = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->ring_qlen = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->ring_val = reinterpret_cast<float*>(tel_ptrs[i++]);
  tl->ring_n = reinterpret_cast<int32_t*>(tel_ptrs[i++]);
  tl->n_bins = tel_icfg[0];
  tl->n_locs = tel_icfg[1];
  tl->cap = tel_icfg[2];
  tl->wait_log_lo = tel_fcfg[0];
  tl->wait_inv = tel_fcfg[1];
  tl->cost_log_lo = tel_fcfg[2];
  tl->cost_inv = tel_fcfg[3];
  return tl->n_bins >= 3 && tl->n_bins <= kMaxBins && tl->n_locs >= 1 &&
         tl->n_locs <= kMaxLocs && tl->cap >= 0;
}

// the environment arguments of a launch: env_ptrs the 11 pointers of
// EnvArgs in order, env_icfg n_segments, n_locs, panic_admit,
// panic_choice, drain; false where they do not fit this build (the ENV
// build needs them, the others take none) or the run's `n_locs`
bool env_args(const int64_t* env_ptrs, const int32_t* env_icfg, int n_locs,
              EnvArgs* E) {
  *E = EnvArgs{};
  if ((env_ptrs != nullptr) != kEnv) return false;
  if (!kEnv) return true;
  int i = 0;
  E->t_end = reinterpret_cast<const float*>(env_ptrs[i++]);
  E->kind = reinterpret_cast<const int32_t*>(env_ptrs[i++]);
  E->price = reinterpret_cast<const float*>(env_ptrs[i++]);
  E->hazard = reinterpret_cast<const float*>(env_ptrs[i++]);
  E->avail = reinterpret_cast<const float*>(env_ptrs[i++]);
  E->nb0 = reinterpret_cast<const float*>(env_ptrs[i++]);
  E->seg0 = reinterpret_cast<const int32_t*>(env_ptrs[i++]);
  E->nb = reinterpret_cast<float*>(env_ptrs[i++]);
  E->seg = reinterpret_cast<int32_t*>(env_ptrs[i++]);
  E->istats = reinterpret_cast<int32_t*>(env_ptrs[i++]);
  E->fstats = reinterpret_cast<float*>(env_ptrs[i++]);
  E->n_segments = env_icfg[0];
  E->n_locs = env_icfg[1];
  E->panic_admit = env_icfg[2];
  E->panic_choice = env_icfg[3];
  E->drain = env_icfg[4];
  return E->n_segments >= 1 && E->n_locs == n_locs;
}

// the work arguments of a launch: work_ptrs the 10 pointers of WorkArgs in
// order, work_icfg the checkpoint mode and the safety net, work_fcfg
// total_work, restart_overhead, ckpt_time, ckpt_period, ckpt_cost,
// deadline, od_time and the slack buffer; false where they do not fit this
// build (the WORK build needs them, the others take none)
bool work_args(const int64_t* work_ptrs, const int32_t* work_icfg,
               const float* work_fcfg, WorkArgs* Wk) {
  *Wk = WorkArgs{};
  if ((work_ptrs != nullptr) != kWork) return false;
  if (!kWork) return true;
  int i = 0;
  Wk->prog0 = reinterpret_cast<const float*>(work_ptrs[i++]);
  Wk->oh0 = reinterpret_cast<const float*>(work_ptrs[i++]);
  Wk->ckpt0 = reinterpret_cast<const float*>(work_ptrs[i++]);
  Wk->life0 = reinterpret_cast<const float*>(work_ptrs[i++]);
  Wk->prog = reinterpret_cast<float*>(work_ptrs[i++]);
  Wk->oh = reinterpret_cast<float*>(work_ptrs[i++]);
  Wk->ckpt = reinterpret_cast<float*>(work_ptrs[i++]);
  Wk->life = reinterpret_cast<float*>(work_ptrs[i++]);
  Wk->istats = reinterpret_cast<int32_t*>(work_ptrs[i++]);
  Wk->fstats = reinterpret_cast<float*>(work_ptrs[i++]);
  Wk->mode = work_icfg[0];
  Wk->safety = work_icfg[1];
  Wk->total = work_fcfg[0];
  Wk->overhead = work_fcfg[1];
  Wk->ckpt_time = work_fcfg[2];
  Wk->period = work_fcfg[3];
  Wk->ckpt_cost = work_fcfg[4];
  Wk->deadline = work_fcfg[5];
  Wk->od_time = work_fcfg[6];
  Wk->buffer = work_fcfg[7];
  return Wk->mode >= kCkptNever && Wk->mode <= kCkptPeriodic;
}

}  // namespace

// ptrs: the 24 pointers of Args in order (key_out may be 0 on the slab
// stream); icfg: lanes, rmax, n_windows, n_cols, job_code, spot_code,
// policy_code, wait_code, job_col, spot_col, admit_col, job_n, spot_n, G
// (threads a lane), SPT (slots a thread), warps a block, split (0 the slab
// stream, 1 the split ladder); fcfg: job_c[4], spot_c[4]; tel_*: the telemetry
// arguments (tel_args), null without the axis; env_*: the environment's
// (env_args), null without it; work_*: the work structure's (work_args),
// null without it.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a (G, SPT) that is not
// built, or telemetry or environment arguments that do not fit this
// build).
extern "C" int sweep_launch(const int64_t* ptrs, const int32_t* icfg,
                            const float* fcfg, const int64_t* tel_ptrs,
                            const int32_t* tel_icfg, const float* tel_fcfg,
                            const int64_t* env_ptrs, const int32_t* env_icfg,
                            const int64_t* work_ptrs,
                            const int32_t* work_icfg, const float* work_fcfg,
                            void* stream) {
  Args a;
  TelArgs tl;
  EnvArgs E;
  WorkArgs Wk;
  if (!tel_args(tel_ptrs, tel_icfg, tel_fcfg, &tl) ||
      !env_args(env_ptrs, env_icfg, 1, &E) ||
      !work_args(work_ptrs, work_icfg, work_fcfg, &Wk))
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.key_out = reinterpret_cast<uint32_t*>(ptrs[23]);
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
  const int group = icfg[13], spt = icfg[14], warps_per_block = icfg[15];
  a.split = icfg[16];
  for (int i = 0; i < 4; ++i) {
    a.job_c[i] = fcfg[i];
    a.spot_c[i] = fcfg[4 + i];
  }
  if (a.n_cols < 0 || a.n_cols > kDraws || warps_per_block < 1 ||
      warps_per_block > 32 || group * spt < a.rmax ||
      (a.split != 0 && a.split != 1) || (a.split && a.key_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_g(a, tl, E, Wk, group, spt, warps_per_block,
                                   static_cast<cudaStream_t>(stream)));
}

extern "C" const char* sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ptrs: the 36 pointers of MArgs in order (logits may be 0; key_out, last,
// only on the split stream); icfg: lanes, rmax, n_windows, n_cols,
// n_pools, job_code, job_n, admit_code, wait_code, choice_code,
// resume_code, preempt_on, any_exp_pool, job_col, spot_col, admit_col,
// choice_col, pre_col, onpre_col, G, SPT, warps a block, then
// pool_code[8], pool_n[8], split and tag[8]; fcfg: job_c[4], pool_c[8][4];
// tel_*, env_*, work_*: as sweep_launch's.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for a (G, SPT) that is not
// built, or telemetry or environment arguments that do not fit this
// build).
extern "C" int market_launch(const int64_t* ptrs, const int32_t* icfg,
                             const float* fcfg, const int64_t* tel_ptrs,
                             const int32_t* tel_icfg, const float* tel_fcfg,
                             const int64_t* env_ptrs,
                             const int32_t* env_icfg,
                             const int64_t* work_ptrs,
                             const int32_t* work_icfg,
                             const float* work_fcfg, void* stream) {
  MArgs a;
  TelArgs tl;
  EnvArgs E;
  WorkArgs Wk;
  if (!tel_args(tel_ptrs, tel_icfg, tel_fcfg, &tl) ||
      !env_args(env_ptrs, env_icfg, icfg[4], &E) ||
      !work_args(work_ptrs, work_icfg, work_fcfg, &Wk))
    return static_cast<int>(cudaErrorInvalidValue);
  int i = 0;
  a.next_job0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.next_spot0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.next_pre0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.ages0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.budgets0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.occ0 = reinterpret_cast<const uint8_t*>(ptrs[i++]);
  a.pool0 = reinterpret_cast<const int32_t*>(ptrs[i++]);
  a.order0 = reinterpret_cast<const int32_t*>(ptrs[i++]);
  a.next_seq0 = reinterpret_cast<const int32_t*>(ptrs[i++]);
  a.qlen0 = reinterpret_cast<const int32_t*>(ptrs[i++]);
  a.win_keys = reinterpret_cast<const uint32_t*>(ptrs[i++]);
  a.plan = reinterpret_cast<const int32_t*>(ptrs[i++]);
  a.k_cost = reinterpret_cast<const float*>(ptrs[i++]);
  a.pa = reinterpret_cast<const float*>(ptrs[i++]);
  a.pb = reinterpret_cast<const float*>(ptrs[i++]);
  a.ckpt = reinterpret_cast<const float*>(ptrs[i++]);
  a.price = reinterpret_cast<const float*>(ptrs[i++]);
  a.hazard = reinterpret_cast<const float*>(ptrs[i++]);
  a.notice = reinterpret_cast<const float*>(ptrs[i++]);
  a.rate = reinterpret_cast<const float*>(ptrs[i++]);
  a.scale = reinterpret_cast<const float*>(ptrs[i++]);
  a.logits = reinterpret_cast<const float*>(ptrs[i++]);
  a.next_job = reinterpret_cast<float*>(ptrs[i++]);
  a.next_spot = reinterpret_cast<float*>(ptrs[i++]);
  a.next_pre = reinterpret_cast<float*>(ptrs[i++]);
  a.ages = reinterpret_cast<float*>(ptrs[i++]);
  a.budgets = reinterpret_cast<float*>(ptrs[i++]);
  a.occ = reinterpret_cast<uint8_t*>(ptrs[i++]);
  a.pool = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.order = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.next_seq = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.qlen = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.istats = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.fstats = reinterpret_cast<float*>(ptrs[i++]);
  a.pstats = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.key_out = reinterpret_cast<uint32_t*>(ptrs[i++]);
  i = 0;
  a.lanes = icfg[i++];
  a.rmax = icfg[i++];
  a.n_windows = icfg[i++];
  a.n_cols = icfg[i++];
  a.n_pools = icfg[i++];
  a.job_code = icfg[i++];
  a.job_n = icfg[i++];
  a.admit_code = icfg[i++];
  a.wait_code = icfg[i++];
  a.choice_code = icfg[i++];
  a.resume_code = icfg[i++];
  a.preempt_on = icfg[i++];
  a.any_exp_pool = icfg[i++];
  a.job_col = icfg[i++];
  a.spot_col = icfg[i++];
  a.admit_col = icfg[i++];
  a.choice_col = icfg[i++];
  a.pre_col = icfg[i++];
  a.onpre_col = icfg[i++];
  const int group = icfg[i++], spt = icfg[i++], warps_per_block = icfg[i++];
  for (int p = 0; p < kMaxPools; ++p) {
    a.pool_code[p] = icfg[i + p];
    a.pool_n[p] = icfg[i + kMaxPools + p];
    a.tag[p] = static_cast<uint32_t>(icfg[i + 2 * kMaxPools + 1 + p]);
    for (int c = 0; c < 4; ++c) a.pool_c[p][c] = fcfg[4 + 4 * p + c];
  }
  a.split = icfg[i + 2 * kMaxPools];
  for (int c = 0; c < 4; ++c) a.job_c[c] = fcfg[c];
  if (a.n_cols < (a.split ? 0 : 1) || a.n_cols > kDraws || a.n_pools < 1 ||
      a.n_pools > kMaxPools || warps_per_block < 1 || warps_per_block > 32 ||
      group * spt < a.rmax || (a.split != 0 && a.split != 1) ||
      (a.split && a.key_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(market_launch_g(a, tl, E, Wk, group, spt,
                                          warps_per_block,
                                          static_cast<cudaStream_t>(stream)));
}

// ptrs: the 34 pointers of RArgs in order (logits may be 0); icfg: lanes,
// n_slots, n_windows, n_cols, n_regions, admit_code, wait_code,
// route_code, resume_code, preempt_on, any_exp_job, any_exp_spot,
// job_col, spot_col, admit_col, route_col, pre_col, onpre_col, G, SPT,
// warps a block, then offset[9], job_code[8], job_n[8], spot_code[8] and
// spot_n[8]; fcfg: job_c[8][4], spot_c[8][4]; tel_*, env_*: as
// sweep_launch's (work_* too).  Launches on `stream` and returns
// cudaGetLastError()
// (cudaErrorInvalidValue for a (G, SPT) that is not built, or telemetry or
// environment arguments that do not fit this build).
extern "C" int region_launch(const int64_t* ptrs, const int32_t* icfg,
                             const float* fcfg, const int64_t* tel_ptrs,
                             const int32_t* tel_icfg, const float* tel_fcfg,
                             const int64_t* env_ptrs,
                             const int32_t* env_icfg,
                             const int64_t* work_ptrs,
                             const int32_t* work_icfg,
                             const float* work_fcfg, void* stream) {
  RArgs a;
  TelArgs tl;
  EnvArgs E;
  WorkArgs Wk;
  if (!tel_args(tel_ptrs, tel_icfg, tel_fcfg, &tl) ||
      !env_args(env_ptrs, env_icfg, icfg[4], &E) ||
      !work_args(work_ptrs, work_icfg, work_fcfg, &Wk))
    return static_cast<int>(cudaErrorInvalidValue);
  int i = 0;
  a.next_job0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.next_spot0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.next_pre0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.ages0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.budgets0 = reinterpret_cast<const float*>(ptrs[i++]);
  a.occ0 = reinterpret_cast<const uint8_t*>(ptrs[i++]);
  a.order0 = reinterpret_cast<const int32_t*>(ptrs[i++]);
  a.next_seq0 = reinterpret_cast<const int32_t*>(ptrs[i++]);
  a.qlen0 = reinterpret_cast<const int32_t*>(ptrs[i++]);
  a.win_keys = reinterpret_cast<const uint32_t*>(ptrs[i++]);
  a.plan = reinterpret_cast<const int32_t*>(ptrs[i++]);
  a.k_cost = reinterpret_cast<const float*>(ptrs[i++]);
  a.pa = reinterpret_cast<const float*>(ptrs[i++]);
  a.pb = reinterpret_cast<const float*>(ptrs[i++]);
  a.ckpt = reinterpret_cast<const float*>(ptrs[i++]);
  a.price = reinterpret_cast<const float*>(ptrs[i++]);
  a.hazard = reinterpret_cast<const float*>(ptrs[i++]);
  a.notice = reinterpret_cast<const float*>(ptrs[i++]);
  a.rate = reinterpret_cast<const float*>(ptrs[i++]);
  a.spot_scale = reinterpret_cast<const float*>(ptrs[i++]);
  a.job_scale = reinterpret_cast<const float*>(ptrs[i++]);
  a.logits = reinterpret_cast<const float*>(ptrs[i++]);
  a.next_job = reinterpret_cast<float*>(ptrs[i++]);
  a.next_spot = reinterpret_cast<float*>(ptrs[i++]);
  a.next_pre = reinterpret_cast<float*>(ptrs[i++]);
  a.ages = reinterpret_cast<float*>(ptrs[i++]);
  a.budgets = reinterpret_cast<float*>(ptrs[i++]);
  a.occ = reinterpret_cast<uint8_t*>(ptrs[i++]);
  a.order = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.next_seq = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.qlen = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.istats = reinterpret_cast<int32_t*>(ptrs[i++]);
  a.fstats = reinterpret_cast<float*>(ptrs[i++]);
  a.rstats = reinterpret_cast<int32_t*>(ptrs[i++]);
  i = 0;
  a.lanes = icfg[i++];
  a.n_slots = icfg[i++];
  a.n_windows = icfg[i++];
  a.n_cols = icfg[i++];
  a.n_regions = icfg[i++];
  a.admit_code = icfg[i++];
  a.wait_code = icfg[i++];
  a.route_code = icfg[i++];
  a.resume_code = icfg[i++];
  a.preempt_on = icfg[i++];
  a.any_exp_job = icfg[i++];
  a.any_exp_spot = icfg[i++];
  a.job_col = icfg[i++];
  a.spot_col = icfg[i++];
  a.admit_col = icfg[i++];
  a.route_col = icfg[i++];
  a.pre_col = icfg[i++];
  a.onpre_col = icfg[i++];
  const int group = icfg[i++], spt = icfg[i++], warps_per_block = icfg[i++];
  for (int r = 0; r <= kMaxRegions; ++r) a.offset[r] = icfg[i++];
  for (int r = 0; r < kMaxRegions; ++r) {
    a.job_code[r] = icfg[i + r];
    a.job_n[r] = icfg[i + kMaxRegions + r];
    a.spot_code[r] = icfg[i + 2 * kMaxRegions + r];
    a.spot_n[r] = icfg[i + 3 * kMaxRegions + r];
    for (int c = 0; c < 4; ++c) {
      a.job_c[r][c] = fcfg[4 * r + c];
      a.spot_c[r][c] = fcfg[4 * kMaxRegions + 4 * r + c];
    }
  }
  if (a.n_cols < 1 || a.n_cols > kDraws || a.n_regions < 1 ||
      a.n_regions > kMaxRegions || a.offset[a.n_regions] != a.n_slots ||
      warps_per_block < 1 || warps_per_block > 32 || group * spt < a.n_slots)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(region_launch_g(a, tl, E, Wk, group, spt,
                                          warps_per_block,
                                          static_cast<cudaStream_t>(stream)));
}
