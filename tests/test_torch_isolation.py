"""The port stands alone: it imports neither JAX nor the JAX package."""
import re
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_PROGRAM = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["repro"] = None
sys.path.insert(0, {src!r})
import numpy as np
import repro_torch
from repro_torch.core import Exponential, ThreePhaseKernel, run_sweep
out = run_sweep(Exponential(1 / 12), Exponential(1 / 24), ThreePhaseKernel(),
                {{"r": np.array([1.0, 2.5])}}, n_events=200, n_seeds=2,
                rmax=8, key=repro_torch.key(0), device="cpu")
assert out["avg_cost"].shape == (2, 2) and np.isfinite(out["avg_cost"]).all()
from repro_torch.core import ExponentialWait
from repro_torch.core.simulator import run_queue_sim, run_single_slot_sim
out = run_queue_sim(Exponential(1 / 12), Exponential(1 / 24), r=2.5,
                    n_events=200, rmax=8, key=repro_torch.key(0),
                    device="cpu")
assert np.isfinite(out["avg_cost"]) and out["jobs_arrived"] > 0
out = run_single_slot_sim(Exponential(1 / 12), Exponential(1 / 24),
                          ExponentialWait(0.37), n_events=200,
                          key=repro_torch.key(0), device="cpu")
assert np.isfinite(out["avg_delay"]) and out["jobs_completed"] > 0
from repro_torch.core import (NoticeAwareKernel, SpotMarket, SpotPool,
                              run_market_sweep)
from repro_torch.cluster.orchestrator import OnlineAdmissionController
market = SpotMarket(pools=(
    SpotPool(Exponential(1 / 48), price=0.5, hazard=0.05, notice=0.5),
    SpotPool(Exponential(1 / 48), price=0.2)))
out = run_market_sweep(Exponential(1 / 12), market, NoticeAwareKernel(0.05),
                       {{"r": np.array([1.0, 2.5])}}, n_events=200,
                       n_seeds=2, rmax=8, key=repro_torch.key(0),
                       device="cpu")
assert out["pool_served"].shape == (2, 2, 2)
assert np.isfinite(out["avg_cost_job"]).all()
assert OnlineAdmissionController(delta=1.0).choose_pool(market, [0, 0]) == 1
from repro_torch.core import (Region, RegionTopology, RoutingKernel,
                              run_region_sweep)
topology = RegionTopology(regions=(
    Region(Exponential(1 / 24), Exponential(1 / 48), price=0.5, hazard=0.05,
           notice=0.5, rmax=4),
    Region(Exponential(1 / 24), Exponential(1 / 48), price=0.2, rmax=2)))
out = run_region_sweep(topology,
                       RoutingKernel(NoticeAwareKernel(0.05), "least_loaded"),
                       {{"r": np.array([1.0, 2.5])}}, n_events=200,
                       n_seeds=2, key=repro_torch.key(0), device="cpu")
assert out["region_routed"].shape == (2, 2, 2)
assert np.isfinite(out["avg_cost_job"]).all()
assert OnlineAdmissionController(delta=1.0).choose_region(
    topology, [0, 0], rule="cheapest") == 1
from repro_torch.obs import Telemetry, device_trace_records, to_perfetto
out = run_region_sweep(topology,
                       RoutingKernel(NoticeAwareKernel(0.05), "least_loaded"),
                       {{"r": np.array([1.0, 2.5])}}, n_events=200,
                       n_seeds=2, key=repro_torch.key(0), device="cpu",
                       telemetry=Telemetry(trace_cap=8))
assert out["wait_hist"].shape == (2, 2, 64)
assert out["loc_defects"].shape == (2, 2, 2)
assert out["events"].sum() == 4 * 200
recs = device_trace_records(out["trace"], out["trace"]["time_windows"])
assert len(to_perfetto(recs)["traceEvents"]) > len(recs)
from repro_torch.core import (PanicKernel, inject_blackout, inject_storm,
                              EnvTimeline)
tl = inject_blackout(inject_storm(EnvTimeline.constant(), 5.0, 20.0,
                                  hazard_mult=4.0), 30.0, 60.0, loc=1,
                     n_locs=2)
out = run_market_sweep(Exponential(1 / 12), market,
                       PanicKernel(NoticeAwareKernel(0.05), drain_dead=True),
                       {{"r": np.array([1.0, 2.5])}}, n_events=200,
                       n_seeds=2, rmax=8, key=repro_torch.key(0),
                       device="cpu", env=tl)
assert out["storms_observed"].shape == (2, 2)
assert np.isfinite(out["avg_cost_job"]).all()
from repro_torch.core import CantBeLateKernel, WorkModel
from repro_torch.obs import SURVIVAL_INT_STATS
out = run_market_sweep(Exponential(1 / 12), market,
                       CantBeLateKernel(PanicKernel(NoticeAwareKernel(0.05),
                                                    drain_dead=True),
                                        slack_buffer=0.2),
                       {{"r": np.array([1.0, 2.5])}}, n_events=200,
                       n_seeds=2, rmax=8, key=repro_torch.key(0),
                       device="cpu", env=tl,
                       work=WorkModel.on_notice(0.2, total_work=3.0,
                                                restart_overhead=0.5,
                                                deadline=120.0, od_time=10.0))
assert set(SURVIVAL_INT_STATS) < set(out)
assert (out["jobs_ontime"] + out["deadline_misses"]
        == out["jobs_finished"]).all()
import importlib, pkgutil
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
from repro_torch.launch import serve
served = serve.main(["--requests", "2", "--max-new", "1"], device="cpu")
assert served["completed"] == 2
served = serve.main(["--arch", "mamba2-780m", "--requests", "2",
                     "--max-new", "1"], device="cpu")
assert served["completed"] == 2
import dataclasses, torch
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.registry import build_model
cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                          attn_impl="pallas")
model = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
loss, _ = model.loss(DataPipeline(cfg.vocab_size, 2, 32).next(device="cpu"))
assert torch.isfinite(loss) and 5.0 < float(loss) < 8.0
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("isolated")
"""


def test_port_runs_without_jax_or_the_jax_package():
    proc = subprocess.run([sys.executable, "-c",
                           _PROGRAM.format(src=str(SRC))],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("isolated")


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.MULTILINE)


def test_no_port_module_imports_jax_or_the_jax_package():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) >= 40
    offenders = [f"{path.relative_to(SRC)}: {m.group(0).strip()}"
                 for path in files
                 for m in _FORBIDDEN.finditer(path.read_text())]
    assert offenders == []
