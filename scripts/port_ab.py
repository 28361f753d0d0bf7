#!/usr/bin/env python3
"""Time kernels of this checkout against another checkout's on one CUDA
card, in turns: the float32 K7 and K8 (the CUDA-core Hessian kernels,
``nif_tpu_torch/csrc/shapenet_hess.cu``), the float32 K6 (the CUDA-core
Sobolev train pass, ``csrc/shapenet_jac.cu``), the float32 K4 (the
CUDA-core NIF-linear train pass, ``csrc/shapenet_linear.cu``), the float32
K1 and K5's float32 reverse body (``csrc/shapenet_fwd.cu``) at the flagship
shape, and the float32-policy calls that run the last two end to end.

    python3 scripts/port_ab.py --other DIR [--kernel k1f32 k4f32 k5f32 k6f32 k7f32 k8f32
                                            k5tan k5tanf32 apply_f32 predict_f32
                                            jaceval_f32 k1 k5 k1wg k5wg k1tc k5tc
                                            k2 k3 k2wg k3wg k2tc k3tc
                                            k7 k8 k7wg k8wg k7tc k8tc]
                                           [--reps N]

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
targets; K1 and K5 on the chain alone, and K5's tangent body (``k5tan`` in
bfloat16, ``k5tanf32``) on the same chain with so = 3, through the body
each checkout's wrapper picks (here: the tensor-core body of
``csrc/shapenet_jac_tc.cu`` for bfloat16, K6's forward half in
``csrc/shapenet_jac.cu`` for float32). The end-to-end entries run the
flagship model (``nif_tpu_torch.utils.bench``, random weights from seed 0)
under the float32 policy at G=32 x P=32768: ``apply_f32`` one
``apply_grouped`` on inputs on the card (mean of 20), ``predict_f32`` one
``predict_grouped`` from host arrays (mean of 5), ``jaceval_f32`` one
``GroupedTrainer.evaluate_sobolev`` with Jacobian targets (one K5 launch,
mean of 3), each on the device clock (CUDA events) and, as ``*_host``, on
the host clock around calls that each end in a synchronize. Defaults to
the six kernels. ``k2`` and ``k3`` are the bfloat16 K2 (unweighted, as the
train step calls it) and K3 on the flagship chain through the body each
checkout's wrapper routes it to (here the wgmma body of
``csrc/shapenet_bwd_wgmma.cu``, in a checkout before it the ``mma.sync`` body
of ``csrc/shapenet_bwd_tc.cu``); ``k2wg``/``k3wg`` and ``k2tc``/``k3tc`` name
the wgmma or the ``mma.sync`` body (both checkouts must have the private
launchers that name a body). ``k1`` and ``k5`` are the bfloat16 K1 and
K5's reverse body on the flagship chain through the body each checkout
routes it to (here the wgmma body of ``csrc/shapenet_fwd_wgmma.cu``, in a
checkout before it the ``mma.sync`` body of ``csrc/shapenet_fwd_tc.cu``);
``k1wg``/``k5wg`` and ``k1tc``/``k5tc`` name the body, so ``--other .``
times both bodies of this checkout, each turn a process. ``k7`` and ``k8``
are the bfloat16 K7 and K8 (K8 with Jacobian and Hessian targets and the
float32 weights above) on the flagship chain through the body each
checkout routes it to (here the wgmma body of ``csrc/shapenet_hess_wgmma.cu``,
in a checkout before it the ``mma.sync`` body of ``csrc/shapenet_hess_tc.cu``);
``k7wg``/``k8wg`` and ``k7tc``/``k8tc`` name the body. Prints each turn's times, each kernel's
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


# the libraries each entry's turn builds (K5's reverse body moved from
# shapenet_jac to shapenet_fwd, so both, for either checkout)
LIBRARIES = {"k1f32": ("shapenet_fwd",), "k4f32": ("shapenet_linear",),
             "k5f32": ("shapenet_fwd", "shapenet_jac"), "k6f32": ("shapenet_jac",),
             "k7f32": ("shapenet_hess",), "k8f32": ("shapenet_hess",),
             "apply_f32": ("shapenet_fwd",), "predict_f32": ("shapenet_fwd",),
             "jaceval_f32": ("shapenet_fwd", "shapenet_jac"),
             "k5tan": ("shapenet_jac", "shapenet_jac_tc"), "k5tanf32": ("shapenet_jac",),
             "k2": ("shapenet_bwd_tc", "shapenet_bwd_wgmma"),
             "k3": ("shapenet_bwd_tc", "shapenet_bwd_wgmma"),
             "k2wg": ("shapenet_bwd_wgmma",), "k3wg": ("shapenet_bwd_wgmma",),
             "k2tc": ("shapenet_bwd_tc",), "k3tc": ("shapenet_bwd_tc",),
             "k1": ("shapenet_fwd_tc", "shapenet_fwd_wgmma"),
             "k5": ("shapenet_fwd_tc", "shapenet_fwd_wgmma"),
             "k1wg": ("shapenet_fwd_wgmma",), "k5wg": ("shapenet_fwd_wgmma",),
             "k1tc": ("shapenet_fwd_tc",), "k5tc": ("shapenet_fwd_tc",),
             "k7": ("shapenet_hess_tc", "shapenet_hess_wgmma"),
             "k8": ("shapenet_hess_tc", "shapenet_hess_wgmma"),
             "k7wg": ("shapenet_hess_wgmma",), "k8wg": ("shapenet_hess_wgmma",),
             "k7tc": ("shapenet_hess_tc",), "k8tc": ("shapenet_hess_tc",)}
KERNELS = ["k1f32", "k4f32", "k5f32", "k6f32", "k7f32", "k8f32"]
END_TO_END = {"apply_f32": 20, "predict_f32": 5, "jaceval_f32": 3}  # calls a mean takes


def _host_ms(torch, fn, reps: int) -> float:
    """Mean host-clock ms of ``fn()`` over ``reps`` calls, each ending in a
    synchronize, after one warm-up call."""
    import time

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / reps * 1e3


def _end_to_end(torch, names):
    """The float32-policy flagship model's calls of ``names``, as
    ``{name: fn}``."""
    import numpy as np

    import nif_tpu_torch
    from nif_tpu_torch.serving import predict_grouped
    from nif_tpu_torch.training import GroupedTrainer
    from nif_tpu_torch.utils.bench import FLAGSHIP_PNET, FLAGSHIP_SHAPE

    model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, "float32", device="cuda",
                                        seed=0)
    rng = np.random.default_rng(SEED + 2)
    t = rng.standard_normal((G, 4)).astype(np.float32)
    x = rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)
    u = rng.standard_normal((G, P, 1)).astype(np.float32)
    jt = rng.standard_normal((G, P, 1, 3)).astype(np.float32)
    runs = {}
    if "apply_f32" in names:
        tc, xc = torch.from_numpy(t).cuda(), torch.from_numpy(x).cuda()

        def apply():
            with torch.inference_mode():
                return model.apply_grouped(tc, xc)

        runs["apply_f32"] = apply
    if "predict_f32" in names:
        runs["predict_f32"] = lambda: predict_grouped(model, t, x)
    if "jaceval_f32" in names:
        trainer = GroupedTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-4), w_jac=0.1)
        state = trainer.init(0)
        runs["jaceval_f32"] = lambda: trainer.evaluate_sobolev(state, t, x, u, jt)
    return runs


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
    from nif_tpu_torch.ops import fused_shapenet as fs
    from nif_tpu_torch.utils.bench import cuda_ms

    if not Path(_build.__file__).resolve().is_relative_to(root.resolve()):
        raise RuntimeError(f"imported {_build.__file__}, not the package under {root}")
    if build_only:
        ptxas = []
        for name in sorted({lib for k in kernels for lib in LIBRARIES[k]}):
            if not (_build.CSRC / f"{name}.cu").exists():  # a checkout before that source
                continue
            _build.build(name)
            ptxas += [ln.strip() for ln in (_build.BUILD_LOGS.get(name) or "").splitlines()
                      if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        print(json.dumps({"ptxas": ptxas}))
        return 0
    cfg = ShapeNetConfig(**SHAPE)
    wb, x, tgt, jt, ht = _inputs(torch, cfg)
    lcfg, ws, bs, a, bias, lx, ltgt = _linear_inputs(torch)
    tcfg = ShapeNetConfig(**{**SHAPE, "output_dim": 3})
    twb, tx = _inputs(torch, tcfg)[:2]
    twb16, tx16 = twb.bfloat16(), tx.bfloat16()
    wb16, x16, g16 = wb.bfloat16(), x.bfloat16(), (tgt * 0.1).bfloat16()
    runs = {"k7f32": lambda: fh.shapenet_fwd_hess_cuda(wb, x, cfg, "siren"),
            "k8f32": lambda: fh.shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht, cfg, "siren",
                                                            w_jac=0.1, w_hess=0.01),
            "k6f32": lambda: fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren",
                                                            w_jac=0.1),
            "k4f32": lambda: fl.niflinear_mse_grads_cuda(ws, bs, a, bias, lx, ltgt, lcfg, 1),
            "k1f32": lambda: fs.shapenet_fwd_cuda(wb, x, cfg, "siren"),
            "k5f32": lambda: fd.shapenet_fwd_jac_cuda(wb, x, cfg, "siren"),
            "k5tan": lambda: fd.shapenet_fwd_jac_cuda(twb16, tx16, tcfg, "siren"),
            "k5tanf32": lambda: fd.shapenet_fwd_jac_cuda(twb, tx, tcfg, "siren"),
            "k2": lambda: fs.shapenet_mse_grads_cuda(wb16, x16, tgt, cfg, "siren"),
            "k3": lambda: fs.shapenet_bwd_cuda(wb16, x16, g16, cfg, "siren"),
            "k1": lambda: fs.shapenet_fwd_cuda(wb16, x16, cfg, "siren"),
            "k5": lambda: fd.shapenet_fwd_jac_cuda(wb16, x16, cfg, "siren"),
            "k7": lambda: fh.shapenet_fwd_hess_cuda(wb16, x16, cfg, "siren"),
            "k8": lambda: fh.shapenet_hessian_grads_cuda(wb16, x16, tgt, jt, ht, cfg, "siren",
                                                         w_jac=0.1, w_hess=0.01)}
    if hasattr(fs, "_shapenet_mse_grads_on"):  # a checkout whose launchers name a body
        for body, tag in (("wgmma", "wg"), ("tc", "tc")):
            runs[f"k2{tag}"] = lambda b=body: fs._shapenet_mse_grads_on(b, wb16, x16, tgt, cfg,
                                                                          "siren")
            runs[f"k3{tag}"] = lambda b=body: fs._shapenet_bwd_on(b, wb16, x16, g16, cfg,
                                                                    "siren")
    if hasattr(fs, "_shapenet_fwd_on"):  # a checkout whose K1/K5 launchers name a body
        for body, tag in (("wgmma", "wg"), ("tc", "tc")):
            runs[f"k1{tag}"] = lambda b=body: fs._shapenet_fwd_on(b, wb16, x16, cfg, "siren")
            runs[f"k5{tag}"] = lambda b=body: fd._shapenet_fwd_jac_on(b, wb16, x16, cfg,
                                                                      "siren")
    if hasattr(fh, "_shapenet_hessian_grads_on"):  # a checkout whose K7/K8 launchers name a body
        for body, tag in (("wgmma", "wg"), ("tc", "tc")):
            runs[f"k7{tag}"] = lambda b=body: fh._shapenet_fwd_hess_on(b, wb16, x16, cfg, "siren")
            runs[f"k8{tag}"] = lambda b=body: fh._shapenet_hessian_grads_on(
                b, wb16, x16, tgt, jt, ht, cfg, "siren", w_jac=0.1, w_hess=0.01)
    e2e = _end_to_end(torch, [k for k in kernels if k in END_TO_END])
    out = {k: cuda_ms(runs[k], reps=reps, warmup=1) for k in kernels if k in runs}
    for k, fn in e2e.items():
        out[k] = cuda_ms(fn, reps=END_TO_END[k], warmup=1)
        out[f"{k}_host"] = _host_ms(torch, fn, END_TO_END[k])
    print(json.dumps(out))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True, help="the other checkout's root")
    ap.add_argument("--kernel", nargs="+", choices=sorted(LIBRARIES), default=KERNELS)
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
    for k in times["this"][0]:
        mean = {label: sum(t[k] for t in times[label]) / 2 for label in roots}
        print(f"{k}: other {mean['other']:.4f} ms, this {mean['this']:.4f} ms, other / this "
              f"{mean['other'] / mean['this']:.3f} ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
