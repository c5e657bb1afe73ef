"""Time the sweep kernel's slab traversals of this checkout against other
copies of ``csrc/sweep.cu`` (a parent commit's, variants of this one), in
turns in one process on the main paths' full-size inputs
(chip_smoke.py's), every result held bitwise against this checkout's.

    mkdir -p build/ab
    git archive <commit> src/repro_torch/kernels/sweep/csrc \
        | tar -x -C build/ab
    python tools/sweep_ab.py \
        build/ab/src/repro_torch/kernels/sweep/csrc/sweep.cu [more.cu ...]

Each fleet (the single queue's three-phase and single-slot fleets, the
market's, the regions'; 4,096 lanes x 1,114,112 events, no telemetry, env
or work state; ``--fleets split_market`` the market's on the split
stream) runs ``--rounds`` times in the order others, this, this,
others reversed, timed by CUDA events.  Only the build without states is
compiled, one nvcc a source, all started together.  The wrapper of this
checkout drives every library, so another source must take the launch
arguments it passes (an interface that grew only by trailing arguments,
which an older kernel never reads).  Needs one CUDA card and nvcc; prints
the card's name and power limit first and one JSON object last.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.sweep import sweep  # noqa: E402

BASE = (False, False, False)
SLAB_FLEETS = ["three_phase", "single_slot", "market", "region"]


def use(lib: _build.KernelLibrary) -> None:
    """Make the wrapper launch ``lib`` for the build without states."""
    sweep.LIBRARIES = {**ORIGINAL, BASE: lib}
    sweep._library.cache_clear()


ORIGINAL = dict(sweep.LIBRARIES)


def traversals(names: list[str]):
    """(name, call) of each main path asked for at full size: the single
    queue's two fleets, the market's and the regions' on the slab stream,
    and ``split_market``, the market's on the split stream."""
    plan, fleets = cs.tel_fleets()
    calls = {name: functools.partial(call, None)
             for name, _, _, call, *_ in fleets}
    split = cs.market_main_inputs(rng="split")
    calls["split_market"] = functools.partial(
        sweep.market_event_windows, *split, plan, rng="split")
    return [(name, calls[name]) for name in names]


def label_of(path: Path) -> str:
    """A source's label: its directory's name for a ``sweep.cu``, else its
    stem."""
    return path.parent.name if path.stem == "sweep" else path.stem


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="+",
                    help="the other copies of sweep.cu")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--fleets", nargs="+", default=SLAB_FLEETS,
                    help=f"of {SLAB_FLEETS + ['split_market']}")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    this = ORIGINAL[BASE]
    libs = {label_of(o): _build.KernelLibrary(
        f"sweep_{label_of(o)}", o.resolve(), this.extra_flags)
        for o in args.others}
    if "this" in libs or len(libs) != len(args.others):
        raise SystemExit("sweep_ab: the other sources need distinct labels, "
                         "none of them 'this'")
    libs["this"] = this
    for label, res in zip(libs, _build.build(*libs.values(), verbose=True)):
        print(f"built {label}: nvcc {res.seconds:.1f} s", flush=True)
        for kname in ("sweep_kernel", "market_kernel", "region_kernel"):
            for key, line in sorted(cs.sweep_ptxas(res.ptxas, kname).items()):
                print(f"  {label} {kname}<G {key[0]}, SPT {key[1]}>: {line}",
                      flush=True)
    others = list(libs)[:-1]
    order = others + ["this", "this"] + others[::-1]
    result = {"card": smi.stdout.strip().splitlines()[0]}
    for name, call in traversals(args.fleets):
        times = {label: [] for label in libs}
        outs = {}
        for label in libs:  # warm-up: a library's first launch loads it
            use(libs[label])
            call()
        for label in order * args.rounds:
            use(libs[label])
            ms, out = cs.cuda_ms(call)
            times[label].append(ms)
            outs.setdefault(label, out)
        use(this)
        mean = {label: float(np.mean(v)) for label, v in times.items()}
        result[name] = {"ms": times, "mean_ms": mean}
        for label in others:
            cs.hold_all(f"A/B {name} {label}", outs[label], outs["this"])
            shown = " / ".join(f"{v:.1f}" for v in times[label])
            print(f"A/B {name}: {label} {shown} ms: this/{label} "
                  f"{mean['this'] / mean[label]:.4f}; every field bitwise",
                  flush=True)
        shown = " / ".join(f"{v:.1f}" for v in times["this"])
        print(f"A/B {name}: this {shown} ms", flush=True)
    line = json.dumps(result)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
