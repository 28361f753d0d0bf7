#!/usr/bin/env python3
"""Where the time of one flagship train step goes on a CUDA card (the
PyTorch/CUDA port, ``nif_tpu_torch``).

    python3 scripts/port_train_profile.py [--sobolev | --hessian | --linear]

The flagship NIFMultiScale under ``GroupedTrainer`` with Adam (lr 1e-4), on
the JAX bench's random batch G=32 x P=32768 (``nif_tpu_torch.utils.bench.
flagship_train_step``; with ``--sobolev``, ``flagship_sobolev_step``, whose
steps also take a random ``target_jac [G, P, 1, 3]``; with ``--hessian``,
``flagship_hessian_step``, whose steps also take a random symmetric
``target_hess [G, P, 1, 3, 3]`` at ``w_jac=0.1``, ``w_hess=0.01``; with
``--linear``, the JAX bench's NIF-linear model on the same batch,
``flagship_linear_step``). Each stage of ``GroupedTrainer.step`` is timed
alone with CUDA events (mean of 10 calls after warm-up; 5 with
``--hessian``): the input casts, the ParameterNet forward, the target
preparation of the Hessian step (symmetrized pair columns), the fused train
kernel's wrapper (K2, K6 with ``--sobolev``, K8 with ``--hessian`` or K4
with ``--linear``: prescale, workspace, kernel and the reduction), the
ParameterNet backward of ``d_wb`` (``d_a`` for NIF-linear), the Adam update;
then the whole step, on the device clock and on the host clock (each step
synchronized); with ``--linear`` also the eager step (autograd over the
eager trunk, then Adam), the yardstick of K4. Last, ``torch.profiler`` sums
device time by kernel over 5 steps and gives the device's busy share of that
window and the fused kernel's share of the busy time.
Prints plain text; nothing here is compared or asserted.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nif_tpu_torch.ops import fused_derivatives as fd  # noqa: E402
from nif_tpu_torch.ops import fused_hessian as fh  # noqa: E402
from nif_tpu_torch.ops import fused_linear as fl  # noqa: E402
from nif_tpu_torch.ops import fused_shapenet as fs  # noqa: E402
from nif_tpu_torch.training import GroupedTrainer  # noqa: E402
from nif_tpu_torch.utils.bench import (  # noqa: E402
    cuda_ms, flagship_hessian_step, flagship_linear_step, flagship_sobolev_step,
    flagship_train_step)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--sobolev", action="store_true",
                      help="profile the Sobolev step (K6) instead of the MSE step (K2)")
    mode.add_argument("--hessian", action="store_true",
                      help="profile the Hessian step (K8) instead of the MSE step (K2)")
    mode.add_argument("--linear", action="store_true",
                      help="profile the NIF-linear step (K4) instead of the MSE step (K2)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    G, P = 32, 32768
    if args.hessian:
        trainer, state, (t, x, u, jt, ht) = flagship_hessian_step(G, P)
        step_kw = {"target_jac": jt, "target_hess": ht}
    elif args.sobolev:
        trainer, state, (t, x, u, jt) = flagship_sobolev_step(G, P)
        step_kw = {"target_jac": jt}
    else:
        trainer, state, (t, x, u) = (flagship_linear_step if args.linear else
                                     flagship_train_step)(G, P)
        step_kw = {}
    model = trainer.model
    cfg = model.cfg_shape_net
    params = [p for _, p in model.param_items()]
    opt = state.opt_state

    tc, xc = model._compute(t), model._compute(x)
    wb, _ = model.pnet(tc)
    stages = {
        "cast t, x to bf16": lambda: (model._compute(t), model._compute(x)),
        "ParameterNet forward (t -> wb)": lambda: model.pnet(tc),
    }
    if args.hessian:
        def targets():  # so = 1, si = 3, every index selected, no weight
            return model._hessian_targets(ht, G, P, 3, 1, np.arange(1), np.arange(3), True, None)

        ht_flat = targets()[0]
        jt_flat = jt.transpose(2, 3).reshape(G, P, 3)  # column k*so + j
        stages["Hessian targets (symmetrized pair columns)"] = targets
        kernel_name = "K8 wrapper (prescale + kernel + reduce)"
        kernel = lambda: fh.shapenet_hessian_grads(  # noqa: E731
            wb, xc, u, jt_flat, ht_flat, cfg, "siren", w_jac=0.1, w_hess=0.01)
    elif args.linear:
        ws, bs = model._trunk_lists()
        ws, bs = [w.detach().to(xc.dtype) for w in ws], [b.detach().to(xc.dtype) for b in bs]
        bias = model.snet.bias.detach().to(xc.dtype)
        kernel_name = "K4 wrapper (prescale + kernel + reduce)"
        kernel = lambda: fl.niflinear_mse_grads(  # noqa: E731
            ws, bs, wb, bias, xc, u, model._trunk_cfg, model.so_dim)
    elif args.sobolev:
        jt_flat = jt.transpose(2, 3).reshape(G, P, 3)  # column k*so + j
        kernel_name = "K6 wrapper (prescale + kernel + reduce)"
        kernel = lambda: fd.shapenet_sobolev_grads(wb, xc, u, jt_flat, cfg, "siren")  # noqa: E731
    else:
        kernel_name = "K2 wrapper (prescale + kernel + reduce)"
        kernel = lambda: fs.shapenet_mse_grads(wb, xc, u, cfg, "siren")  # noqa: E731
    # NIF-linear: wb is a(t), its cotangent d_a goes back through the
    # ParameterNet; the trunk's grads come out of K4 itself
    d_wb = kernel()[3] if args.linear else kernel()[-1]
    back_params = list(model.pnet.params.parameters()) if args.linear else params
    grads = torch.autograd.grad(wb, back_params, d_wb, retain_graph=True)
    if args.linear:
        grads = grads + tuple(torch.zeros_like(p) for p in params[len(back_params):])

    def adam():
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()

    box = [state]

    def step():
        box[0], _ = trainer.step(box[0], t, x, u, **step_kw)

    stages.update({
        kernel_name: kernel,
        "ParameterNet backward (d_wb -> grads)": lambda: torch.autograd.grad(
            wb, back_params, d_wb, retain_graph=True),
        "Adam update": adam,
        "GroupedTrainer.step (whole)": step,
    })
    if args.linear:
        eager = GroupedTrainer(model, trainer.make_optimizer, fused=False)
        stages["eager step (autograd + Adam)"] = lambda: eager.step(box[0], t, x, u)
    reps = 5 if args.hessian else 10
    for name, fn in stages.items():
        print(f"{name:42s} {cuda_ms(fn, reps=reps):9.4f} ms")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"{'step, host clock, synchronized each step':42s} {host_ms:9.4f} ms "
          f"= {G * P / host_ms * 1e3:.4e} train points/s")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        a.record()
        for _ in range(5):
            step()
        b.record()
        torch.cuda.synchronize()
    window_us = a.elapsed_time(b) * 1e3
    # device-side kernels only: a CPU op's self device time repeats its
    # kernels', and a user annotation (e.g. the optimizer's step range) spans them
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"profiler window {window_us:.1f} us over 5 steps; device busy "
          f"{busy_us:.1f} us = {busy_us / window_us:.4f} of the window")
    top = max(events, key=lambda e: e.self_device_time_total)
    print(f"largest kernel {top.key[:60]}: {top.self_device_time_total / busy_us:.4f} of the "
          f"busy time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 5:10.1f} us/step  {e.count // 5:3d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
