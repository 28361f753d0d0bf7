#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``nif_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. Print the card's name and power limit; build the serving path's CUDA
   kernel from ``nif_tpu_torch/csrc``.
2. Hold each kernel against its plain PyTorch version on the card: K1 (the
   grouped ShapeNet forward) over the six chain configs of the JAX package's
   kernel tests at G=3, P=256, and the flagship chain at G=32, P=32768, in
   float32 and bfloat16.
3. Serve the flagship NIFMultiScale (``nif_tpu_torch.utils.bench``, random
   weights from a seed) through ``serving.predict_grouped``: a full request, a
   ragged one (point padding) and a 70-snapshot one (chunking). Check shapes,
   finiteness, agreement with the plain K1 and the eager path, and that the
   K1 launch count rose by the number of chunks served.
4. Time K1, its plain version and the end-to-end ``apply_grouped`` with CUDA
   events, and compute K1's bound on this card.

The last line is ``{"ok": true, "device": {...}}``; the line before it is the
``{"kernels": [...]}`` record. Exits non-zero without CUDA or without the
package beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, f32
# FLOP/s outside the tensor cores, device-memory bytes/s. A card set below
# its maximum power runs slower under load; its limit is printed beside.
PEAKS = {
    "H100 SXM": (989e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
}
# f32 operations of one bf16 sine activation: bias add, range reduction
# (mul, rint, sub), t*t, four Horner steps and the final product.
SINE_FLOPS = 14

# The chain configs of tests/test_pallas_kernel.py (variant, ShapeNetConfig args).
CASES = [
    ("siren", (3, 1, 128, 2, "sine", False, 30.0)),
    ("siren", (2, 2, 64, 1, "sine", True, 10.0)),
    ("siren", (1, 1, 16, 3, "sine", False, 5.0)),
    ("vanilla", (2, 3, 32, 2, "swish")),
    ("vanilla", (1, 1, 16, 1, "tanh")),
    ("vanilla", (2, 1, 64, 2, "relu")),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def chain_data(torch, cfg, G, P, dtype, seed):
    """SIREN-regime weights (0.3/omega_0 keeps omega*z bounded) and N(0,1)
    coordinates, made with numpy from a seed, on the card in ``dtype``."""
    from nif_tpu_torch.config import shapenet_param_count

    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, cfg.input_dim))
    to = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda", dtype)  # noqa: E731
    return to(wb), to(x)


def check_k1(torch, cfg, variant, G, P, dtype, seed) -> float:
    """Kernel vs plain version on one input; returns max |kernel - plain|.

    Tolerances: float32 rtol 2e-4, atol 1e-5 (the JAX package's kernel-test
    bound; both sides sum in f32, in different orders). bfloat16 max|d| <=
    1e-2 * max|plain| (about 2.5 bf16 ulps): a last-bit difference in an f32
    sum can flip the bf16 rounding of an activation before the next matmul."""
    from nif_tpu_torch.ops.fused_shapenet import (
        shapenet_fwd_cuda, shapenet_grouped_fused_reference)

    wb, x = chain_data(torch, cfg, G, P, dtype, seed)
    out = shapenet_fwd_cuda(wb, x, cfg, variant)
    ref = shapenet_grouped_fused_reference(wb, x, cfg, variant)
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"K1 {variant} {cfg}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError(f"K1 {variant} {cfg} {dtype}: non-finite output")
    err = float((o - r).abs().max())
    scale = float(r.abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(o, r, rtol=2e-4, atol=1e-5)
    elif err > 1e-2 * scale:
        raise AssertionError(f"K1 {variant} {cfg} bf16: max|d| {err} > 1e-2 * {scale}")
    log(f"K1 {variant:7s} si={cfg.input_dim} so={cfg.output_dim} n={cfg.units} "
        f"l={cfg.nlayers} res={cfg.use_resblock} G={G} P={P} {str(dtype):14s} "
        f"max|d|={err:.3e} max|plain|={scale:.3e}")
    return err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import nif_tpu_torch
    from nif_tpu_torch.config import ShapeNetConfig
    from nif_tpu_torch.ops import _build
    from nif_tpu_torch.ops.fused_shapenet import (
        shapenet_fwd_cuda, shapenet_grouped_fused_reference)
    from nif_tpu_torch.ops.shapenet import shapenet_grouped
    from nif_tpu_torch.serving import predict_grouped
    from nif_tpu_torch.utils import rel_l2
    from nif_tpu_torch.utils.bench import (FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                           FLAGSHIP_SHAPE, cuda_ms)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # ---- phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    log(f"card: {smi}")
    t0 = time.perf_counter()
    _build.build("shapenet_fwd")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOGS.get("shapenet_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    peak_mma, peak_f32, peak_bw = PEAKS["H100 PCIe" if "PCIe" in name else "H100 SXM"]

    # ---- phase 2: K1 against its plain version
    for i, (variant, args) in enumerate(CASES):
        for dtype in (torch.float32, torch.bfloat16):
            check_k1(torch, ShapeNetConfig(*args), variant, 3, 256, dtype, seed=i)
    flag_cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    check_k1(torch, flag_cfg, "siren", 32, 32768, torch.float32, seed=10)
    k1_err = check_k1(torch, flag_cfg, "siren", 32, 32768, torch.bfloat16, seed=11)

    # ---- phase 3: serve the flagship model
    model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET,
                                        mixed_policy=FLAGSHIP_POLICY, device="cuda", seed=0)
    if model.po_dim != 33665:
        raise AssertionError(f"flagship po_dim {model.po_dim} != 33665")
    info = model.fast_path_info(32768)
    log(f"fast path at P=32768: {info}")
    if info["path"] != "fused":
        raise AssertionError(f"flagship serving would not take the kernel: {info}")
    rng = np.random.default_rng(0)
    requests = [(32, 32768), (7, 1000), (70, 4096)]  # full, ragged P, chunked G
    chunks = sum(-(-G // min(32, G)) for G, _ in requests)
    inputs = [(rng.standard_normal((G, 4)).astype(np.float32),
               rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)) for G, P in requests]
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [predict_grouped(model, t, x) for t, x in inputs]
    serve_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"served {len(requests)} requests ({sum(G * P for G, P in requests)} points) "
        f"in {serve_s:.3f} s; launches {launches}, chunks {chunks}")
    if launches["shapenet_fwd"] != chunks:
        raise AssertionError(f"K1 launched {launches['shapenet_fwd']} times for {chunks} chunks")
    with torch.inference_mode():
        for (G, P), (t, x), out in zip(requests, inputs, outs):
            if out.shape != (G, P, 1) or out.dtype != np.float32:
                raise AssertionError(f"request G={G} P={P}: got {out.shape} {out.dtype}")
            if not np.isfinite(out).all():
                raise AssertionError(f"request G={G} P={P}: non-finite output")
            got = torch.from_numpy(out).cuda()
            wb = model.p_to_w(t)
            xc = model.policy.cast_to_compute(x, device=model.device)
            plain = shapenet_grouped_fused_reference(wb, xc, model.cfg_shape_net, "siren").float()
            eager = shapenet_grouped(wb, xc, model.cfg_shape_net, "siren").float()
            d_plain = float((got - plain).abs().max())
            d_eager = float((got - eager).abs().max())
            r_eager = float(rel_l2(got, eager))
            log(f"request G={G} P={P}: max|u|={float(plain.abs().max()):.4f} "
                f"max|d| vs plain K1 {d_plain:.3e}, vs eager {d_eager:.3e} "
                f"(rel-L2 {r_eager:.4f})")
            # The same function with the kernel's rounding points: tight.
            if d_plain > 1e-2 * float(plain.abs().max()):
                raise AssertionError(f"request G={G} P={P}: served output departs from plain K1")
            # The eager bf16 path rounds omega*(u@W) to bf16 at |z| up to ~30
            # (a 0.125-0.25 step in the sine's argument) and takes the exact
            # sine: 2-5% rel-L2 from the kernel at this width (H100 and CPU runs).
            if r_eager > 0.15 or d_eager > 0.3 * float(eager.abs().max()):
                raise AssertionError(f"request G={G} P={P}: served output departs from eager")

    # ---- phase 4: times at the flagship shape (bf16, as served)
    G, P = requests[0]
    t, x = inputs[0]
    with torch.inference_mode():
        wb = model.p_to_w(t)
        xc = model.policy.cast_to_compute(x, device=model.device)
        k1_ms = cuda_ms(lambda: shapenet_fwd_cuda(wb, xc, flag_cfg, "siren"), reps=20)
        plain_ms = cuda_ms(lambda: shapenet_grouped_fused_reference(
            wb, xc, flag_cfg, "siren"), reps=5, warmup=1)
        t_dev, x_dev = torch.from_numpy(t).cuda(), torch.from_numpy(x).cuda()
        e2e_ms = cuda_ms(lambda: model.apply_grouped(t_dev, x_dev), reps=20)
        t0 = time.perf_counter()
        for _ in range(3):
            predict_grouped(model, t, x)
        serve_ms = (time.perf_counter() - t0) / 3 * 1e3
    n, si, so, steps = flag_cfg.units, flag_cfg.input_dim, flag_cfg.output_dim, flag_cfg.nlayers
    mma_flops = 2 * G * P * (si * n + steps * n * n + n * so)
    sine_flops = SINE_FLOPS * G * P * n * (1 + steps)
    nbytes = (wb.numel() + xc.numel() + G * P * so) * 2
    t_ops = max(mma_flops / peak_mma, sine_flops / peak_f32) * 1e3
    t_bytes = nbytes / peak_bw * 1e3
    bound_ms = max(t_ops, t_bytes)
    log(f"K1 {k1_ms:.4f} ms (wrapper incl. omega prescale), plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms (products {mma_flops / 1e9:.1f} GFLOP -> "
        f"{mma_flops / peak_mma * 1e3:.4f} ms, sine {sine_flops / 1e9:.2f} GFLOP -> "
        f"{sine_flops / peak_f32 * 1e3:.4f} ms, {nbytes / 1e6:.2f} MB -> {t_bytes:.4f} ms); "
        f"library_ms null: no single PyTorch call computes this chain")
    log(f"end to end apply_grouped (f32 inputs on the card) G={G} P={P}: {e2e_ms:.4f} ms = "
        f"{G * P / e2e_ms * 1e3:.4e} points/s; predict_grouped from host arrays: "
        f"{serve_ms:.4f} ms = {G * P / serve_ms * 1e3:.4e} points/s")
    log(f"card: {smi}")
    log(json.dumps({"kernels": [{
        "name": "shapenet_fwd",
        "route": "cuda",
        "source": "nif_tpu_torch/csrc/shapenet_fwd.cu",
        "replaces": "nif_tpu/ops/pallas_shapenet.py:489",
        "launches": launches["shapenet_fwd"],
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
