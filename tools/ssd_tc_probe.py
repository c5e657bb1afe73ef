"""Where the tensor-core SSD kernel's time goes, on an NVIDIA GPU.

    python3 tools/ssd_tc_probe.py

Builds ``src/repro_torch/kernels/ssd/csrc/ssd_tc.cu`` and patched copies
of it (written under ``build/ssd_tc_probe/``, one ``nvcc`` each, all
started together) and times them at mamba2-780m's scoring layer (B 8, L
4,096, H 48, P 64, N 128, Q 256, bf16) and at one prefill_32k row (B 1, L
32,768), every build in turn and then in the reverse order, by CUDA
events:

- the design's steps, as patches of the committed kernel: ``first`` (the
  first version: 8 warps, each its low and high query strip in turn, 154
  registers), ``one_strip`` (16 warps, one whole strip a warp, a
  scheduler's four warps balanced, no barrier between the strips and the
  update), the kernel as committed (16 warps, every warp the same number
  of key tiles), and ``y_staged`` (y staged in the strip's rows of C and
  written 16 bytes a lane; tried and dropped);
- ablations of the committed kernel, each with one part cut (their
  outputs are wrong; timing only): ``no_intra`` (the key loop of W·x),
  ``no_update``, ``no_ch`` (C·h_prev), ``no_fetch`` (the next chunk's
  copies), ``no_exp`` (the decay of W), ``no_wx`` (W·x's mma),
  ``no_store`` (the y stores);
- ``phases``: the committed kernel with a ``clock64`` at each phase
  boundary of each warp, the mean cycles a chunk of each phase.

Every build that computes y is held to the plain chunked scan by the
tensor-core rule (``ssd/ref.py::tc_tolerance``) first.  The card's name
and power limit head the output.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import ssd as ssd_mod  # noqa: E402
from repro_torch.kernels.ssd.ref import (ssd_chunked, ssd_tc_twin,  # noqa: E402
                                         tc_tolerance)

OUT = ROOT / "build" / "ssd_tc_probe"
H, P, N, Q = 48, 64, 128, 256
SHAPES = ((8, 4_096), (1, 32_768))

#: the committed kernel's strip phase, replaced by the earlier designs
STRIPS_FROM = "    // y.  Strips lo = j"
STRIPS_TO = ("    __syncthreads();  // C, dt and h's copy are read; B and x "
             "stay\n")
#: the first version's strip phase: 8 warps, each its strips w and S-1-w in
#: turn
FIRST_STRIPS = """    // y, a 16-row strip at a time: warp w takes strips w and S-1-w
    for (int k = 0; k < 2; ++k) {
      const int pos = 2 * warp + k;
      const bool has = pos < n_strips;
      const int strip = (pos & 1) ? n_strips - 1 - (pos >> 1) : (pos >> 1);
      const int q0 = 16 * strip;
      uint32_t ca[8][4];
      float acc[8][4];
      if (has) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          if (kk < ksteps)
            ldsm_x4(ca[kk], cs + (q0 + (lane & 15)) * kLdN + 16 * kk +
                                8 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        // exp(cum_q)·(C_q · h_prev): h's bf16 copy [p][n] is the B operand
        if (l0 > 0) {
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
          for (int j = 0; j < 8; ++j) {
            acc[j][0] *= e0;
            acc[j][1] *= e0;
            acc[j][2] *= e1;
            acc[j][3] *= e1;
          }
        }
      }
      if (k == 0) {
        cp_async_wait<0>();  // this chunk's B and x
        __syncthreads();
      }
      if (!has) continue;
      const float cq0 = cums[q0 + g] * kLog2e, cq1 = cums[q0 + g + 8] * kLog2e;
      for (int s0 = 0; s0 <= q0; s0 += 16) {
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
        for (int j = 0; j < 2; ++j) {
          const int s = s0 + 8 * j + 2 * t;
          const float c0 = cums[s] * kLog2e, c1 = cums[s + 1] * kLog2e;
          const float d0 = dts[s], d1 = dts[s + 1];
          const int qa = q0 + g, qb = q0 + g + 8;
          const float w00 = s <= qa ? sc[j][0] * ex2(cq0 - c0) * d0 : 0.f;
          const float w01 = s + 1 <= qa ? sc[j][1] * ex2(cq0 - c1) * d1 : 0.f;
          const float w10 = s <= qb ? sc[j][2] * ex2(cq1 - c0) * d0 : 0.f;
          const float w11 = s + 1 <= qb ? sc[j][3] * ex2(cq1 - c1) * d1 : 0.f;
          wa[2 * j] = pack(w00, w01);
          wa[2 * j + 1] = pack(w10, w11);
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
      // y = acc + D·x, as bf16
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= P) break;
        const int p = 8 * j + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = q0 + g + 8 * r;
          const float2 xv = __bfloat1622float2(
              *reinterpret_cast<const bf162*>(xs + q * kLdP + p));
          *reinterpret_cast<uint32_t*>(
              a.y + ((row0 + l0 + q) * H + h) * P + p) =
              pack(acc[j][2 * r] + D * xv.x, acc[j][2 * r + 1] + D * xv.y);
        }
      }
    }
"""
#: 16 warps, one whole strip a warp, a scheduler's four warps (w, w+4,
#: w+8, w+12) on strips j, S-1-j, 7-j and 8+j
ONE_STRIP = """    // y of the warp's 16-row strip: the strips in the order 0, S-1, 1,
    // S-2, ..., position 2 pj + member, pj = w % 4 for w < 8 and 7 - w % 4
    // above (a scheduler's four warps: pairs w % 4 and 7 - w % 4)
    {
      const int pj = (warp >> 3) ? 7 - (warp & 3) : (warp & 3);
      const int member = (warp >> 2) & 1;
      const bool has = 2 * pj + member < n_strips;
      const int strip = member ? n_strips - 1 - pj : pj;
      const int q0 = 16 * strip;
      uint32_t ca[8][4];
      float acc[8][4];
      if (has) {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          if (kk < ksteps)
            ldsm_x4(ca[kk], cs + (q0 + (lane & 15)) * kLdN + 16 * kk +
                                8 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        // exp(cum_q)·(C_q · h_prev): h's bf16 copy [p][n] is the B operand
        if (l0 > 0) {
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
          for (int j = 0; j < 8; ++j) {
            acc[j][0] *= e0;
            acc[j][1] *= e0;
            acc[j][2] *= e1;
            acc[j][3] *= e1;
          }
        }
      }
      cp_async_wait<0>();  // this chunk's B and x
      __syncthreads();
      if (has) {
        const float cq0 = cums[q0 + g] * kLog2e;
        const float cq1 = cums[q0 + g + 8] * kLog2e;
        for (int s0 = 0; s0 <= q0; s0 += 16) {
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
          for (int j = 0; j < 2; ++j) {
            const int s = s0 + 8 * j + 2 * t;
            const float c0 = cums[s] * kLog2e, c1 = cums[s + 1] * kLog2e;
            const float d0 = dts[s], d1 = dts[s + 1];
            const int qa = q0 + g, qb = q0 + g + 8;
            const float w00 = s <= qa ? sc[j][0] * ex2(cq0 - c0) * d0 : 0.f;
            const float w01 =
                s + 1 <= qa ? sc[j][1] * ex2(cq0 - c1) * d1 : 0.f;
            const float w10 = s <= qb ? sc[j][2] * ex2(cq1 - c0) * d0 : 0.f;
            const float w11 =
                s + 1 <= qb ? sc[j][3] * ex2(cq1 - c1) * d1 : 0.f;
            wa[2 * j] = pack(w00, w01);
            wa[2 * j + 1] = pack(w10, w11);
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
        // y = acc + D·x, as bf16
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (8 * j >= P) break;
          const int p = 8 * j + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int q = q0 + g + 8 * r;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const bf162*>(xs + q * kLdP + p));
            *reinterpret_cast<uint32_t*>(
                a.y + ((row0 + l0 + q) * H + h) * P + p) =
                pack(acc[j][2 * r] + D * xv.x, acc[j][2 * r + 1] + D * xv.y);
          }
        }
      }
    }
"""
#: 8 warps: the update's slice of h 16 x 64
WARPS8 = [
    ("constexpr int kWarps = 16;", "constexpr int kWarps = 8;"),
    ("16 * mw < P && 32 * nw < N", "16 * mw < P && 64 * nw < N"),
    ("float hacc[4][4];\n#pragma unroll\n  for (int j = 0; j < 4; ++j)",
     "float hacc[8][4];\n#pragma unroll\n  for (int j = 0; j < 8; ++j)"),
    ("      for (int j = 0; j < 4; ++j)\n#pragma unroll\n        for (int e = 0; "
     "e < 4; ++e) hacc[j][e] *= total;",
     "      for (int j = 0; j < 8; ++j)\n#pragma unroll\n        for (int e = 0; "
     "e < 4; ++e) hacc[j][e] *= total;"),
    ("for (int jn = 0; jn < 2; ++jn) {\n          const int n0 = 32 * nw + 16 "
     "* jn;", "for (int jn = 0; jn < 4; ++jn) {\n          const int n0 = 64 * "
     "nw + 16 * jn;"),
    ("for (int j = 0; j < 4; ++j) {\n        const int n = 32 * nw + 8 * j",
     "for (int j = 0; j < 8; ++j) {\n        const int n = 64 * nw + 8 * j"),
]
#: no barrier after the strips: the next chunk's C and dt are fetched with
#: its B and x at the chunk's end
NO_MID_BARRIER = [
    (STRIPS_TO + "    const bool more = l0 + Q < L;\n"
     "    if (more) fetch_c_dt(l0 + Q);\n", "    const bool more = l0 + Q < L;\n"),
    ("    if (more) fetch_b_x(l0 + Q);",
     "    if (more) {\n      fetch_c_dt(l0 + Q);\n      fetch_b_x(l0 + Q);\n    }"),
]
#: y staged in the strip's own rows of C (dead once held in registers) and
#: written 16 bytes a lane
Y_STAGED = [(
    """            *reinterpret_cast<uint32_t*>(
                a.y + ((row0 + l0 + q) * H + h) * P + p) =
                pack(acc[i][2 * r] + D * xv.x, acc[i][2 * r + 1] + D * xv.y);
          }
        }
      };""",
    """            *reinterpret_cast<uint32_t*>(cs + (q0 + g + 8 * r) * kLdN + p) =
                pack(acc[i][2 * r] + D * xv.x, acc[i][2 * r + 1] + D * xv.y);
          }
        }
        __syncwarp();
        for (int i = lane; i < 16 * pq; i += 32) {
          const int r = i / pq, k = i - r * pq;
          *reinterpret_cast<uint4*>(a.y + ((row0 + l0 + q0 + r) * H + h) * P
                                    + 8 * k) =
              *reinterpret_cast<const uint4*>(cs + (q0 + r) * kLdN + 8 * k);
        }
      };""")]


STRIPS = object()


def strips(block: str) -> list:
    """The edit that puts ``block`` in place of the committed strip phase,
    the text from STRIPS_FROM up to STRIPS_TO."""
    return [(STRIPS, block)]


#: earlier designs, as patches of the committed kernel
DESIGNS = {
    "first": strips(FIRST_STRIPS) + WARPS8,
    "one_strip": strips(ONE_STRIP) + NO_MID_BARRIER,
    "y_staged": Y_STAGED,
}
ABLATIONS = {
    "no_intra": [("for (int s0 = 16 * t0; s0 < 16 * t1; s0 += 16) {",
                  "for (int s0 = 16 * t0; s0 < 16 * t1 && D == 12345.f; "
                  "s0 += 16) {")],
    "no_update": [("    if (owns_h) {\n      const float total",
                   "    if (owns_h && D == 12345.f) {\n      const float total")],
    "no_ch": [("if (l0 > 0) {", "if (l0 > 0 && D == 12345.f) {")],
    "no_fetch": [("    if (more) fetch_c_dt(l0 + Q);\n", ""),
                 ("    if (more) fetch_b_x(l0 + Q);", "")],
    "no_exp": [(f"ex2(cq{i} - c{j})", "1.f") for i in (0, 1) for j in (0, 1)],
    "no_wx": [("            mma(acc[2 * jp], wa, xb[0], xb[1]);\n"
               "            mma(acc[2 * jp + 1], wa, xb[2], xb[3]);",
               "            acc[2 * jp][0] += __uint_as_float(wa[0] ^ xb[0]);")],
    "no_store": [("            *reinterpret_cast<uint32_t*>(\n"
                  "                a.y", "            if (D == 12345.f)\n"
                  "            *reinterpret_cast<uint32_t*>(\n"
                  "                a.y")],
}
PHASES = ["wait C, dt", "scan", "C·h_prev", "wait B, x", "strips (W·x)",
          "barrier", "update", "barrier", "h copy, fetch"]
#: clock64 marks: phase i ends where MARK(i) stands.  ptxas may read a
#: clock before a barrier it follows in the source, so a barrier's wait can
#: show in the phase after it.
MARKS = [
    ("  for (int l0 = 0; l0 < L; l0 += Q) {\n",
     "  for (int l0 = 0; l0 < L; l0 += Q) {\n    MARK(8);\n"),
    ("    cp_async_wait<1>();  // this chunk's C and dt (B and x may be in "
     "flight)\n    __syncthreads();\n",
     "    cp_async_wait<1>();  // this chunk's C and dt (B and x may be in "
     "flight)\n    __syncthreads();\n    MARK(0);\n"),
    ("    // y.  Strips lo = j", "    MARK(1);\n    // y.  Strips lo = j"),
    ("      cp_async_wait<0>();  // this chunk's B and x\n      "
     "__syncthreads();\n",
     "      MARK(2);\n      cp_async_wait<0>();  // this chunk's B and x\n"
     "      __syncthreads();\n      MARK(3);\n"),
    ("    __syncthreads();  // C, dt and h's copy are read; B and x stay\n",
     "    MARK(4);\n    __syncthreads();  // C, dt and h's copy are read; B "
     "and x stay\n    MARK(5);\n"),
    ("    __syncthreads();  // B and x are read\n",
     "    MARK(6);\n    __syncthreads();  // B and x are read\n    MARK(7);\n"),
]


def patched(src: str, edits) -> str:
    for old, new in edits:
        if old is STRIPS:
            src = (src[:src.index(STRIPS_FROM)] + new
                   + src[src.index(STRIPS_TO):])
            continue
        if src.count(old) != 1:
            raise AssertionError(f"patch anchor not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def with_phase_clocks(src: str) -> str:
    src = patched(src, [(
        "__global__ void __launch_bounds__(kThreads, 1) ssd_tc_kernel(Args a) {",
        "__device__ unsigned long long g_prof[16][9];\n"
        "__global__ void __launch_bounds__(kThreads, 1) ssd_tc_kernel(Args a) {\n"
        "  unsigned long long pr[9] = {0};\n  long long tk = clock64(), tn;\n"
        "#define MARK(i) do { tn = clock64(); pr[i] += tn - tk; tk = tn; } "
        "while (0)")] + MARKS)
    end = src.rindex("}\n", 0, src.index("}  // namespace"))
    src = (src[:end] + "  MARK(8);\n  if ((threadIdx.x & 31) == 0)\n"
           "    for (int i = 0; i < 9; ++i)\n"
           "      atomicAdd(&g_prof[threadIdx.x >> 5][i], pr[i]);\n"
           + src[end:])
    return src + ('\nextern "C" int ssd_tc_prof(void* out, int zero) {\n'
                  '  static unsigned long long z[16][9];\n'
                  '  return (int)(zero ? cudaMemcpyToSymbol(g_prof, z, '
                  'sizeof(z)) : cudaMemcpyFromSymbol(out, g_prof, '
                  'sizeof(z)));\n}\n')


def inputs(B: int, L: int, seed: int = 92):
    """The scoring inputs of chip_smoke.py: B and C column slices of one
    [B, C] tensor, dt near the model's range."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(B, L, H, P, generator=g, device="cuda") * 0.5).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(B, L, H, generator=g, device="cuda") - 4.0)
    bc = (torch.randn(B, L, 2 * N, generator=g, device="cuda") * 0.3
          ).bfloat16()
    a_log = torch.log(torch.arange(1, H + 1, device="cuda").float())
    return x, dt, a_log, torch.ones(H, device="cuda"), bc[..., :N], bc[..., N:]


def launcher(lib: _build.KernelLibrary):
    so = ctypes.CDLL(str(lib.path))
    so.ssd_tc_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                                 + [ctypes.c_void_p])

    def run(args, y):
        B, L = args[0].shape[:2]
        rc = so.ssd_tc_launch(*[a.data_ptr() for a in args], y.data_ptr(), B,
                              L, H, P, N, Q, args[4].stride(1),
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{lib.name}: launch failed ({rc})")
    return so, run


def ms(fn, repeat: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeat


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_tc_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    src = ssd_mod.TC_LIBRARY.source.read_text()
    sources = {"committed": src, "phases": with_phase_clocks(src)}
    sources |= {k: patched(src, v) for k, v in DESIGNS.items()}
    sources |= {k: patched(src, v) for k, v in ABLATIONS.items()}
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {}
    for tag, text in sources.items():
        path = OUT / f"ssd_tc_{tag}.cu"
        path.write_text(text)
        libs[tag] = _build.KernelLibrary(f"ssd_tc_probe_{tag}", path)
    for res in _build.build(*libs.values(), verbose=True):
        regs = "; ".join(line.split(":", 1)[-1].strip()
                         for line in res.ptxas.splitlines()
                         if "Used" in line or "spill" in line)
        print(f"{res.library.name}: {regs}", flush=True)
    runs = {tag: launcher(lib) for tag, lib in libs.items()}
    correct = ("committed", "phases", *DESIGNS)

    for B, L in SHAPES:
        args = inputs(B, L)
        plain = ssd_chunked(*args, chunk=Q)
        tol, dist = tc_tolerance(plain, ssd_tc_twin(*args, chunk=Q), 0.0)
        y = torch.empty_like(args[0])
        for tag in correct:
            runs[tag][1](args, y)
            torch.cuda.synchronize()
            torch.testing.assert_close(y.float(), plain.float(), **tol,
                                       msg=f"{tag} at B {B}, L {L}")
        print(f"B {B}, L {L}: every build within the tensor-core rule of "
              f"the chunked scan (the twin's distance {dist:.4g})",
              flush=True)
        del plain
        order = [t for t in runs if t != "phases"]
        times = {t: [] for t in order}
        for turn in (order, order[::-1]):
            for tag in turn:
                times[tag].append(ms(lambda: runs[tag][1](args, y),
                                     10 if B > 1 else 4))
        print(f"B {B}, L {L} (ms, in turns): " + ", ".join(
            f"{t} {a:.4f} / {b:.4f}" for t, (a, b) in times.items()),
            flush=True)
        so, run = runs["phases"]
        so.ssd_tc_prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
        run(args, y)
        so.ssd_tc_prof(None, 1)
        run(args, y)
        torch.cuda.synchronize()
        prof = (ctypes.c_ulonglong * (16 * 9))()
        so.ssd_tc_prof(prof, 0)
        per = B * H * (L // Q)
        print(f"B {B}, L {L}: mean cycles a chunk, warps 0..15, by phase "
              f"(clock64; {per} chunks):", flush=True)
        for i, name in enumerate(PHASES):
            print(f"  {name:14s}" + "".join(
                f"{prof[w * 9 + i] / per:7.0f}" for w in range(16)),
                flush=True)
        print("  total         " + "".join(
            f"{sum(prof[w * 9 + i] for i in range(9)) / per:7.0f}"
            for w in range(16)), flush=True)
        del args, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
