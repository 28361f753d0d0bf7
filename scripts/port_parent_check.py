#!/usr/bin/env python3
"""Hold kernels built from another checkout's sources against this
checkout's, on a CUDA card: the same flagship inputs through both libraries
must give the same bits, and the two are timed in turns.

    python3 scripts/port_parent_check.py --csrc DIR [--kernel k1 k1wg k2 k2wg k3wg k2f32 k3f32
                                                            k5 k5wg k6 k7 k7wg k8 k8wg]

``DIR`` holds the other checkout's ``nif_tpu_torch/csrc`` (for example that
of a parent commit, unpacked with ``git archive`` under ``build/``). Each
kernel's source there (``shapenet_fwd_tc.cu`` for K1 and K5's reverse body
on ``mma.sync``, ``shapenet_fwd_wgmma.cu`` for the wgmma K1 and K5,
``shapenet_bwd_tc.cu`` for K2 on ``mma.sync``, ``shapenet_bwd_wgmma.cu``
for the wgmma K2 and K3, ``shapenet_bwd.cu`` for the float32 K2 and
K3 on the CUDA cores, ``shapenet_jac_tc.cu`` for K6, ``shapenet_hess_tc.cu``
for K7 and K8 on ``mma.sync``, ``shapenet_hess_wgmma.cu`` for the wgmma K7
and K8) is built with this checkout's nvcc
flags into ``build/nif_tpu_torch/other/``, all sources of both checkouts at
once, and must define the kernel's C entries with this checkout's
signatures (the other library takes this checkout's argument types, so an
older one may lack the entries of kernels this check is not asked for). Each kernel runs through
its wrapper on the flagship chain (G=32, P=32768, width 128, two hidden
layers, si=3, random weights, targets, point weights or output cotangent
from a seed; bf16 for the tensor-core kernels, f32 for k2f32 and k3f32):
every output must be bitwise equal (exit 1 otherwise). Then each is timed
with CUDA events in the order other, this, this, other, and the card's name
and power limit are printed beside the times.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
import threading
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from nif_tpu_torch.config import ShapeNetConfig  # noqa: E402
from nif_tpu_torch.ops import _build  # noqa: E402
from nif_tpu_torch.ops import fused_derivatives as fd  # noqa: E402
from nif_tpu_torch.ops import fused_hessian as fh  # noqa: E402
from nif_tpu_torch.ops import fused_shapenet as fs  # noqa: E402
from nif_tpu_torch.utils.bench import FLAGSHIP_SHAPE, cuda_ms  # noqa: E402

G, P, SEED = 32, 32768, 203


def _k1_on(body):
    """K1 on one bf16 body ("tc", the mma.sync one, or "wgmma")."""
    def case(cfg):
        wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=SEED)
        return lambda: (fs._shapenet_fwd_on(body, wb, x, cfg, "siren"),)
    return case


def _k5_on(body):
    """K5's reverse body on one bf16 body ("tc" or "wgmma")."""
    def case(cfg):
        wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=SEED)
        return lambda: fd._shapenet_fwd_jac_on(body, wb, x, cfg, "siren")
    return case


def _k2_on(body):
    """K2 on one bf16 body ("tc", the mma.sync one, or "wgmma")."""
    def case(cfg):
        wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=SEED)
        tgt, w, _ = chip_smoke.side_data(torch, cfg, G, P, seed=SEED)
        return lambda: fs._shapenet_mse_grads_on(body, wb, x, tgt, cfg, "siren", w)
    return case


def _k3wg(cfg):
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=SEED)
    g = chip_smoke.side_data(torch, cfg, G, P, seed=SEED)[2].to(torch.bfloat16)
    return lambda: fs._shapenet_bwd_on("wgmma", wb, x, g, cfg, "siren")


def _k2f32(cfg):
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.float32, seed=SEED)
    tgt, w, _ = chip_smoke.side_data(torch, cfg, G, P, seed=SEED)
    return lambda: fs.shapenet_mse_grads_cuda(wb, x, tgt, cfg, "siren", w)


def _k3f32(cfg):
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.float32, seed=SEED)
    g = chip_smoke.side_data(torch, cfg, G, P, seed=SEED)[2]
    return lambda: fs.shapenet_bwd_cuda(wb, x, g, cfg, "siren")


def _k6(cfg):
    wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=SEED)
    tgt, w, jt = chip_smoke.sobolev_data(torch, cfg, G, P, seed=SEED)
    return lambda: fd.shapenet_sobolev_grads_cuda(wb, x, tgt, jt, cfg, "siren", w_value=0.7,
                                                  w_jac=1.3, weight=w)


def _k7_on(body):
    """K7 on one bf16 body ("tc", the mma.sync one, or "wgmma")."""
    def case(cfg):
        wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=SEED)
        return lambda: fh._shapenet_fwd_hess_on(body, wb, x, cfg, "siren")
    return case


def _k8_on(body):
    """K8 on one bf16 body, with point weights."""
    def case(cfg):
        wb, x = chip_smoke.chain_data(torch, cfg, G, P, torch.bfloat16, seed=SEED)
        tgt, w, jt, ht = chip_smoke.hessian_data(torch, cfg, G, P, seed=SEED)
        return lambda: fh._shapenet_hessian_grads_on(body, wb, x, tgt, jt, ht, cfg, "siren",
                                                     weight=w)
    return case


# kernel: (library, its C entries, this checkout's loader (sets the argument
# types), the wrapper call on the flagship inputs, the names of its outputs)
KERNELS = {
    "k1": ("shapenet_fwd_tc", ("nif_shapenet_fwd_tc_workspace", "nif_shapenet_fwd_tc"),
           fs._fwd_tc_library, _k1_on("tc"), ("y",)),
    "k1wg": ("shapenet_fwd_wgmma", ("nif_shapenet_fwd_wg_workspace", "nif_shapenet_fwd_wg"),
             fs._fwd_wg_library, _k1_on("wgmma"), ("y",)),
    "k5": ("shapenet_fwd_tc", ("nif_shapenet_fwd_jac_tc_workspace", "nif_shapenet_fwd_jac_tc"),
           fs._fwd_tc_library, _k5_on("tc"), ("y", "jac")),
    "k5wg": ("shapenet_fwd_wgmma", ("nif_shapenet_fwd_jac_wg_workspace",
                                    "nif_shapenet_fwd_jac_wg"),
             fs._fwd_wg_library, _k5_on("wgmma"), ("y", "jac")),
    "k2": ("shapenet_bwd_tc", ("nif_shapenet_mse_tc_workspace", "nif_shapenet_mse_grads_tc"),
           fs._bwd_tc_library, _k2_on("tc"), ("loss", "d_wb")),
    "k2wg": ("shapenet_bwd_wgmma", ("nif_shapenet_mse_wg_workspace", "nif_shapenet_mse_grads_wg"),
             fs._bwd_wg_library, _k2_on("wgmma"), ("loss", "d_wb")),
    "k3wg": ("shapenet_bwd_wgmma", ("nif_shapenet_bwd_wg_workspace", "nif_shapenet_bwd_wg"),
             fs._bwd_wg_library, _k3wg, ("d_wb", "dx")),
    "k2f32": ("shapenet_bwd", ("nif_shapenet_bwd_workspace", "nif_shapenet_mse_grads"),
              fs._bwd_library, _k2f32, ("loss", "d_wb")),
    "k3f32": ("shapenet_bwd", ("nif_shapenet_bwd_workspace", "nif_shapenet_bwd"),
              fs._bwd_library, _k3f32, ("d_wb", "dx")),
    "k6": ("shapenet_jac_tc", ("nif_shapenet_sobolev_tc_workspace",
                               "nif_shapenet_sobolev_grads_tc"),
           lambda: fd._library("tc"), _k6, ("value_mse", "jac_mse", "d_wb")),
    "k7": ("shapenet_hess_tc", ("nif_shapenet_fwd_hess_tc_workspace", "nif_shapenet_fwd_hess_tc"),
           lambda: fh._library("tc"), _k7_on("tc"), ("y", "jac", "hess")),
    "k7wg": ("shapenet_hess_wgmma", ("nif_shapenet_fwd_hess_wg_workspace",
                                     "nif_shapenet_fwd_hess_wg"),
             lambda: fh._library("wgmma"), _k7_on("wgmma"), ("y", "jac", "hess")),
    "k8": ("shapenet_hess_tc", ("nif_shapenet_hess_tc_workspace", "nif_shapenet_hessian_grads_tc"),
           lambda: fh._library("tc"), _k8_on("tc"), ("value_mse", "jac_mse", "hess_mse", "d_wb")),
    "k8wg": ("shapenet_hess_wgmma", ("nif_shapenet_hess_wg_workspace",
                                     "nif_shapenet_hessian_grads_wg"),
             lambda: fh._library("wgmma"), _k8_on("wgmma"),
             ("value_mse", "jac_mse", "hess_mse", "d_wb")),
}


def build_other(csrc: Path, names) -> dict:
    """``{name: CDLL}`` of ``csrc/<name>.cu`` for every name, one nvcc each,
    all started together; a library is named by a hash of the other
    checkout's sources and reused when it is built."""
    outs, errors = {}, []
    digest = hashlib.sha256()
    for path in sorted(csrc.glob("*.cu*")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())

    def one(name):
        out = _build.BUILD_DIR / "other" / f"lib{name}-{digest.hexdigest()[:16]}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        outs[name] = out
        if out.exists():
            return
        tmp = out.with_suffix(".tmp.so")  # renamed into place when complete
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(tmp),
                               str(csrc / f"{name}.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {csrc / name}.cu:\n{proc.stdout}")
        else:
            tmp.replace(out)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise RuntimeError(errors[0])
    return {name: ctypes.CDLL(str(out)) for name, out in outs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, required=True,
                    help="the other checkout's nif_tpu_torch/csrc directory")
    ap.add_argument("--kernel", nargs="+", choices=sorted(KERNELS), default=["k8"],
                    help="the kernels to hold against the other build (default k8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    names = sorted({KERNELS[k][0] for k in args.kernel})
    # this checkout's libraries and the other's, all built at once
    other = {}
    th = threading.Thread(target=lambda: other.update(build_other(args.csrc.resolve(), names)))
    th.start()
    chip_smoke.build_all(names)
    th.join()
    if set(other) != set(names):
        raise RuntimeError("the other checkout's build failed (see above)")
    this = {name: _build.load_library(name) for name in names}
    cfg = ShapeNetConfig.from_dict(FLAGSHIP_SHAPE)
    ok = True
    for kernel in args.kernel:
        name, entries, load, make, out_names = KERNELS[kernel]
        load()  # this library's argument types
        for entry in (*entries, "nif_cuda_error_string"):  # ... given to the other library
            mine, theirs = getattr(this[name], entry), getattr(other[name], entry)
            theirs.argtypes, theirs.restype = mine.argtypes, mine.restype
        run = make(cfg)
        libs = {"other": other[name], "this": this[name]}

        def use(label):
            _build._LIBS[name] = libs[label]

        outs = {}
        for label in libs:
            use(label)
            outs[label] = [t.clone() for t in run()]
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(outs["other"], outs["this"])]
        ok = ok and all(same)
        print(f"{kernel.upper()} bitwise equal: "
              + ", ".join(f"{n} {s}" for n, s in zip(out_names, same)))
        scalars = [i for i, t in enumerate(outs["this"]) if t.dim() == 0]
        if scalars:
            print(f"{kernel.upper()} terms other "
                  + ", ".join(f"{float(outs['other'][i]):.9e}" for i in scalars)
                  + "; this " + ", ".join(f"{float(outs['this'][i]):.9e}" for i in scalars))
        for label in ("other", "this", "this", "other"):
            use(label)
            what = "f32 CUDA cores" if kernel.endswith("f32") else "bf16 tc"
            print(f"{kernel.upper()} {what}, {label:5s} build: "
                  f"{cuda_ms(run, reps=5, warmup=1):.4f} ms ({smi})", flush=True)
        use("this")
        del outs, run
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
