"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Runs the batched server with the spot-aware frontend (the paper's admission
controller dispatching requests between spot slots and on-demand capacity)
on the GPU.  The flags are the JAX launcher's (``python -m
repro.launch.serve``), ``--smoke`` included: it is on by default and cannot
be turned off, so the launcher always serves the reduced config, as the
JAX one does (ROADMAP.md Queue 3).
"""
import argparse


def main(argv=None, device=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--delta", type=float, default=5.0)
    ap.add_argument("--k", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.cluster.orchestrator import OnlineAdmissionController
    from repro_torch.configs import get_config
    from repro_torch.core import Exponential
    from repro_torch.device import resolve_device
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import BatchedServer, SpotServingFrontend

    device = resolve_device(device, "repro_torch.launch.serve")
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=device, generator=torch.Generator(
        device).manual_seed(0))
    server = BatchedServer(model, max_batch=4,
                           max_len=args.prompt_len + args.max_new + 8,
                           device=device)
    ctl = OnlineAdmissionController(delta=args.delta, eta=0.1, r0=2.0,
                                    window_jobs=16)
    frontend = SpotServingFrontend(server, spot_process=Exponential(1 / 3.0),
                                   controller=ctl, k_cost=args.k)
    out = frontend.run_stream(Exponential(1 / 2.0),
                              n_requests=args.requests,
                              prompt_len=args.prompt_len,
                              max_new=args.max_new, vocab=cfg.vocab_size)
    for k, v in out.items():
        print(f"{k}: {v}")
    return out


if __name__ == "__main__":
    main()
