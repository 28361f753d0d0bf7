#!/usr/bin/env python3
"""Where the time of one flagship ``apply_grouped`` goes on a CUDA card
(the PyTorch/CUDA port, ``nif_tpu_torch``).

    python3 scripts/port_serving_profile.py

The flagship NIFMultiScale (``nif_tpu_torch.utils.bench``, random weights
from seed 0) serves G=32 snapshots x P=32768 points. Each stage of
``apply_grouped`` is timed alone with CUDA events (mean of 20 calls after
warm-up): the input casts, the ParameterNet, the omega_0 prescale, the K1
kernel, the output cast; then the whole call. Last, ``torch.profiler`` sums
device time by kernel over 5 calls and gives the device's busy share of that
window. Prints plain text; nothing here is compared or asserted.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import nif_tpu_torch  # noqa: E402
from nif_tpu_torch.ops import fused_shapenet as fs  # noqa: E402
from nif_tpu_torch.utils.bench import (  # noqa: E402
    FLAGSHIP_PNET, FLAGSHIP_POLICY, FLAGSHIP_SHAPE, cuda_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    model = nif_tpu_torch.NIFMultiScale(FLAGSHIP_SHAPE, FLAGSHIP_PNET, FLAGSHIP_POLICY,
                                        device="cuda", seed=0)
    rng = np.random.default_rng(0)
    G, P = 32, 32768
    t = torch.from_numpy(rng.standard_normal((G, 4)).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.uniform(-1, 1, (G, P, 3)).astype(np.float32)).cuda()
    cfg = model.cfg_shape_net
    with torch.inference_mode():
        def cast(a):
            return model.policy.cast_to_compute(a, device=model.device)

        tc, xc = cast(t), cast(x)
        wb = model.pnet(tc)[0]
        u = fs.shapenet_fwd_cuda(wb, xc, cfg, "siren")
        stages = {
            "cast x to bf16": lambda: cast(x),
            "ParameterNet (t -> wb)": lambda: model.pnet(tc),
            "omega_0 prescale": lambda: fs._prescale(wb, cfg, "siren"),
            "K1 wrapper (prescale + kernel)": lambda: fs.shapenet_fwd_cuda(wb, xc, cfg, "siren"),
            "cast u to f32": lambda: u.to(torch.float32),
            "apply_grouped (whole)": lambda: model.apply_grouped(t, x),
        }
        for name, fn in stages.items():
            print(f"{name:34s} {cuda_ms(fn):9.4f} ms")
        model.apply_grouped(t, x)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.profile(activities=acts) as prof:
            a.record()
            for _ in range(5):
                model.apply_grouped(t, x)
            b.record()
            torch.cuda.synchronize()
    window_us = a.elapsed_time(b) * 1e3
    # device-side kernels only: a CPU op's self device time repeats its
    # kernels', and a user annotation (e.g. the optimizer's step range) spans them
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"profiler window {window_us:.1f} us over 5 calls; device busy "
          f"{busy_us:.1f} us = {busy_us / window_us:.4f} of the window")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 5:10.1f} us/call  {e.count // 5:3d}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
