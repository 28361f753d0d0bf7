#!/usr/bin/env python3
"""Time kernels of this checkout against another checkout's on one CUDA
card, in turns: the float32 K7 and K8 (the CUDA-core Hessian kernels,
``nif_tpu_torch/csrc/shapenet_hess.cu``), the float32 K6 (the CUDA-core
Sobolev train pass, ``csrc/shapenet_jac.cu``) and the float32 K4 (the
CUDA-core NIF-linear train pass, ``csrc/shapenet_linear.cu``) at the
flagship shape.

    python3 scripts/port_ab.py --other DIR [--kernel k4f32 k6f32 k7f32 k8f32] [--reps N]

``DIR`` is the root of another checkout (for example a parent commit,
unpacked with ``git archive`` under ``build/``). Each checkout's package
builds its own kernels into its own ``build/`` directory: first both at
once, then one process a turn in the order other, this, this, other, each
importing ``nif_tpu_torch`` from its checkout and timing each kernel
through the package's wrapper (CUDA events, mean of ``--reps`` calls
after one warm-up) on the same inputs, made with numpy from a seed: the
flagship chain (G=32, P=32768, width 128, two hidden layers, si=3, so=1),
float32, with Jacobian and Hessian targets for K8 and its float32-policy
weights (w_jac=0.1, w_hess=0.01), Jacobian targets for K6 (w_jac=0.1), and
for K4 the flagship NIF-linear trunk (width 128, two hidden layers, a
128-wide bottleneck, K=128, so=1) with a latent a, an output bias and value
targets. Defaults to the four. Prints each turn's times, each kernel's
mean over the two turns of each checkout with their ratio, the registers
and spills ptxas reported for each build's instances, and the card's name
and power limit. Nothing is asserted; the wrappers themselves raise on a
failed build or launch.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
G, P, SEED = 32, 32768, 211
SHAPE = dict(input_dim=3, output_dim=1, units=128, nlayers=2, activation="sine",
             use_resblock=False, omega_0=30.0)


# the libraries each kernel's turn builds
LIBRARIES = {"k4f32": "shapenet_linear", "k6f32": "shapenet_jac", "k7f32": "shapenet_hess",
             "k8f32": "shapenet_hess"}


def _inputs(torch, cfg):
    """wb [G, po] (scaled as the kernel tests do), x, and K8's value,
    Jacobian and unique-pair Hessian targets, f32 on the card."""
    import numpy as np

    from nif_tpu_torch.config import shapenet_param_count

    rng = np.random.default_rng(SEED)
    to = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    wb = rng.standard_normal((G, shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    return (to(wb), to(rng.standard_normal((G, P, 3))), to(rng.standard_normal((G, P, 1))),
            to(rng.standard_normal((G, P, 3))), to(rng.standard_normal((G, P, 6))))


def _linear_inputs(torch):
    """K4's trunk config, its chain-order weights and biases (SIREN-regime),
    a [G, K], the output bias, x and value targets, f32 on the card."""
    import numpy as np

    from nif_tpu_torch.config import ShapeNetConfig

    n, K, om = 128, 128, 30.0
    cfg = ShapeNetConfig(3, K, n, 2, "sine", False, om)
    rng = np.random.default_rng(SEED + 1)
    to = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()  # noqa: E731
    ws = [to(rng.standard_normal(s) * (0.3 / om)) for s in [(3, n), (n, n), (n, n), (n, K)]]
    bs = [to(rng.standard_normal(s) * (0.3 / om)) for s in [(n,), (n,), (n,), (K,)]]
    return (cfg, ws, bs, to(rng.standard_normal((G, K)) * 0.5),
            to(rng.standard_normal(1) * 0.1), to(rng.standard_normal((G, P, 3))),
            to(rng.standard_normal((G, P, 1))))


def child(root: Path, kernels, reps: int, build_only: bool) -> int:
    """One turn in a process of its own: import the package of ``root``,
    build, time; one JSON line."""
    sys.path.insert(0, str(root))
    import torch

    from nif_tpu_torch.config import ShapeNetConfig
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops import fused_derivatives as fd
    from nif_tpu_torch.ops import fused_hessian as fh
    from nif_tpu_torch.ops import fused_linear as fl
    from nif_tpu_torch.utils.bench import cuda_ms

    if not Path(_build.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {_build.__file__}, not the package under {root}")
    if build_only:
        ptxas = []
        for name in sorted({LIBRARIES[k] for k in kernels}):
            _build.build(name)
            ptxas += [ln.strip() for ln in (_build.BUILD_LOGS.get(name) or "").splitlines()
                      if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        print(json.dumps({"ptxas": ptxas}))
        return 0
    cfg = ShapeNetConfig(**SHAPE)
    wb, x, tgt, jt, ht = _inputs(torch, cfg)
    lcfg, ws, bs, a, bias, lx, ltgt = _linear_inputs(torch)
    runs = {"k7f32": lambda: fh.shapenet_fwd_hess_cuda(wb, x, cfg, "siren"),
            "k8f32": lambda: fh.shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht, cfg, "siren",
                                                            w_jac=0.1, w_hess=0.01),
            "k6f32": lambda: fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren",
                                                            w_jac=0.1),
            "k4f32": lambda: fl.niflinear_mse_grads_cuda(ws, bs, a, bias, lx, ltgt, lcfg, 1)}
    print(json.dumps({k: cuda_ms(runs[k], reps=reps, warmup=1) for k in kernels}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="the other checkout's root")
    ap.add_argument("--kernel", nargs="+", choices=sorted(LIBRARIES), default=sorted(LIBRARIES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        return child(args.child, args.kernel, args.reps, args.build_only)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    roots = {"other": args.other.resolve(), "this": ROOT}

    def turn(label, build_only=False):
        cmd = [sys.executable, str(Path(__file__).resolve()), "--other", str(args.other),
               "--child", str(roots[label]), "--reps", str(args.reps), "--kernel", *args.kernel]
        proc = subprocess.run(cmd + (["--build-only"] if build_only else []),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the {label} checkout's turn failed")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    builds = {}
    threads = [threading.Thread(target=lambda lb=lb: builds.update({lb: turn(lb, True)}))
               for lb in roots]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if set(builds) != set(roots):
        raise RuntimeError("a build failed (see its traceback above)")
    for label in roots:
        for line in builds[label]["ptxas"]:
            print(f"{label} build ptxas: {line}")
    times = {label: [] for label in roots}
    for label in ("other", "this", "this", "other"):
        ms = turn(label)
        times[label].append(ms)
        print(f"turn {label:5s}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()),
              flush=True)
    for k in args.kernel:
        mean = {label: sum(t[k] for t in times[label]) / 2 for label in roots}
        print(f"{k}: other {mean['other']:.4f} ms, this {mean['this']:.4f} ms, other / this "
              f"{mean['other'] / mean['this']:.3f} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
