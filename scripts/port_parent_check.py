#!/usr/bin/env python3
"""Hold the tensor-core K8 built from another checkout's sources against
this checkout's, on a CUDA card: the same flagship inputs through both
libraries must give the same bits, and the two are timed in turns.

    python3 scripts/port_parent_check.py --csrc DIR

``DIR`` holds the other checkout's ``nif_tpu_torch/csrc`` (for example that
of a parent commit, unpacked with ``git archive`` under ``build/``); its
``shapenet_hess_tc.cu`` is built with this checkout's nvcc flags into
``build/nif_tpu_torch/other/`` and must have this checkout's C interface.
Both libraries run ``shapenet_hessian_grads_cuda`` on the flagship chain
(G=32, P=32768, width 128, two hidden layers, si=3, bf16, random weights,
targets and point weights from a seed): the three terms and ``d_wb`` must
be bitwise equal (exit 1 otherwise). Then each is timed with CUDA events in
the order other, this, this, other, and the card's name and power limit are
printed beside the times.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nif_tpu_torch.config import ShapeNetConfig  # noqa: E402
from nif_tpu_torch.ops import _build  # noqa: E402
from nif_tpu_torch.ops import fused_hessian as fh  # noqa: E402
from nif_tpu_torch.utils.bench import FLAGSHIP_SHAPE, cuda_ms  # noqa: E402

NAME = "shapenet_hess_tc"


def build_other(csrc: Path) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "other" / f"lib{NAME}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(csrc / f"{NAME}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {csrc / NAME}.cu:\n{proc.stdout}")
    return ctypes.CDLL(str(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, required=True,
                    help="the other checkout's nif_tpu_torch/csrc directory")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    libs = {"other": build_other(args.csrc.resolve()), "this": _build.load_library(NAME)}
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    G, P = 32, 32768
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=203)
    tgt, w, jt, ht = chip_smoke.hessian_data(torch, cfg, G, P, seed=203)

    def run():
        return fh.shapenet_hessian_grads_cuda(wb, x, tgt, jt, ht, cfg, "siren", weight=w)

    def use(label):
        _build._LIBS[NAME] = libs[label]
        fh._library("tc")  # its argument types

    outs = {}
    for label in libs:
        use(label)
        outs[label] = [t.clone() for t in run()]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(outs["other"], outs["this"])]
    names = ("value_mse", "jac_mse", "hess_mse", "d_wb")
    print("bitwise equal: " + ", ".join(f"{n} {s}" for n, s in zip(names, same)))
    print("terms other " + ", ".join(f"{float(v):.9e}" for v in outs["other"][:3])
          + "; this " + ", ".join(f"{float(v):.9e}" for v in outs["this"][:3]))
    for label in ("other", "this", "this", "other"):
        use(label)
        print(f"K8 bf16 tc, {label:5s} build: {cuda_ms(run, reps=5, warmup=1):.4f} ms "
              f"({smi})", flush=True)
    use("this")
    return 0 if all(same) else 1


if __name__ == "__main__":
    sys.exit(main())
