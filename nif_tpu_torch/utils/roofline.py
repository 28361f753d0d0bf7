"""Roofline accounting on the H100 (counterpart of ``nif_tpu/utils/roofline.py``).

Plain arithmetic on the configs and the shapes, whatever kernel implements
the work:

* :func:`flops_per_point`, :func:`pnet_flops` and :func:`step_report` are the
  JAX module's, with the same numbers; :func:`step_report` calls the share
  of the peak ``mfu`` (model FLOP utilization), where JAX says
  ``mxu_utilization``: the H100 has no MXU.
* :func:`kernel_cost` counts the work of each fused pass K1-K8 (products,
  element-wise f32 operations, bytes in and out once each) and
  :func:`kernel_bound_ms` turns a count into the least time the card could
  take, against :func:`card_peaks`. :func:`train_kernel_cost_model` is K2's
  entry under the JAX function's signature.

The K-numbers name the ``pl.pallas_call`` sites of
``nif_tpu/ops/pallas_shapenet.py`` (PERF.md §6): K1 the chain forward, K2
forward + MSE + backward, K3 the backward of ``apply_grouped``, K4
NIF-linear's trunk, K5 the Jacobian forward, K6 the Sobolev pass, K7 the
Hessian forward, K8 the Hessian pass.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..config import ParameterNetConfig, ShapeNetConfig, shapenet_param_count

__all__ = ["flops_per_point", "pnet_flops", "step_report", "train_kernel_cost_model",
           "card_peaks", "kernel_cost", "kernel_bound_ms", "PEAKS"]

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, f32
# FLOP/s outside the tensor cores, device-memory bytes/s. A card set below
# its maximum power runs slower under load.
PEAKS = {
    "H100 SXM": (989e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
}
# f32 operations of one bf16 sine activation: bias add, range reduction
# (mul, rint, sub), t*t, four Horner steps and the final product.
SINE_FLOPS = 14
# ... and of the sine with its derivative (K2, K3, K4, K5): the derivative
# adds three Horner steps and the factor 1/2pi.
SINE_GRAD_FLOPS = 21
# ... and of the curvature act'' beside act' (K6's backward): the range
# reduction again, the derivative's and the curvature's Horner steps and
# their scale factors.
SINE_GRAD2_FLOPS = 28
# ... of one sine with act' and act'' from one range reduction (K7's
# epilogues, K8's forward), and with act''' too (K8's backward).
SINE3_FLOPS = 28
SINE4_FLOPS = 34

_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")


def _chain_matmul_flops(cfg: ShapeNetConfig) -> int:
    """Forward FLOPs per coordinate point through the ShapeNet chain."""
    si, so, n, l = cfg.input_dim, cfg.output_dim, cfg.units, cfg.nlayers
    mats = (2 * l if cfg.use_resblock else l)
    return 2 * (si * n + mats * n * n + n * so)


def flops_per_point(cfg_s: ShapeNetConfig, training: bool = True) -> int:
    """ShapeNet FLOPs per point; training counts fwd + ~2x bwd."""
    fwd = _chain_matmul_flops(cfg_s)
    return fwd * 3 if training else fwd


def pnet_flops(cfg_p: ParameterNetConfig, cfg_s: ShapeNetConfig,
               n_groups: int, training: bool = True) -> int:
    """ParameterNet FLOPs per step (per group, times n_groups)."""
    po = shapenet_param_count(cfg_s, cfg_p.latent_dim)
    k, u, l = cfg_p.latent_dim, cfg_p.units, cfg_p.nlayers
    mats = (2 * l if cfg_p.use_resblock else l)
    fwd = 2 * (cfg_p.input_dim * u + mats * u * u + u * k + k * po)
    total = fwd * (3 if training else 1)
    return total * n_groups


def step_report(
    cfg_s: ShapeNetConfig,
    cfg_p: ParameterNetConfig,
    n_groups: int,
    points_per_group: int,
    step_seconds: float,
    peak_tflops: Optional[float] = None,
    training: bool = True,
) -> Dict[str, float]:
    """Summarize a measured step: points/s, TFLOP/s, utilization.

    ``peak_tflops``: the card's peak in TFLOP/s for the step's compute dtype
    (``card_peaks()[0] / 1e12`` for bf16 on the tensor cores,
    ``card_peaks()[1] / 1e12`` for float32); if given, adds ``mfu``, the
    step's model FLOPs a second over that peak. The JAX module names the same
    share ``mxu_utilization``.
    """
    pts = n_groups * points_per_group
    snet = flops_per_point(cfg_s, training) * pts
    pnet = pnet_flops(cfg_p, cfg_s, n_groups, training)
    total = snet + pnet
    out = {
        "points_per_sec": pts / step_seconds,
        "tflops_per_sec": total / step_seconds / 1e12,
        "snet_flops": float(snet),
        "pnet_flops": float(pnet),
        "pnet_fraction": pnet / total,
    }
    if peak_tflops:
        out["mfu"] = out["tflops_per_sec"] / peak_tflops
    return out


def card_peaks(name: Optional[str] = None) -> Tuple[float, float, float]:
    """``(bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores,
    bytes/s)`` of the card called ``name`` (default: CUDA device 0's name):
    the PCIe part's where the name says PCIe, else the SXM part's."""
    if name is None:
        import torch

        name = torch.cuda.get_device_name(0)
    return PEAKS["H100 PCIe" if "PCIe" in name else "H100 SXM"]


def _n_mats(cfg: ShapeNetConfig) -> int:
    """Hidden matrices of the chain: two a layer for resblocks."""
    return 2 * cfg.nlayers if cfg.use_resblock else cfg.nlayers


def kernel_cost(kernel: str, cfg: ShapeNetConfig, G: int, P: int, *, f32: bool = False,
                body: str = "reverse", so: Optional[int] = None) -> Dict[str, float]:
    """The work of one launch of ``kernel`` (``"K1"`` ... ``"K8"``) on the
    chain ``cfg`` over ``G`` groups of ``P`` points: ``{"products": FLOPs of
    the matrix products, "elementwise": f32 operations of the activations
    and epilogues, "bytes": each input read once and each output written
    once}``. ``cfg`` is a fully connected chain. ``f32``: the float32
    kernel (4-byte inputs and outputs; else 2-byte, bf16). ``body``: K5's
    ``"reverse"`` (so < si) or ``"tangent"`` (so >= si) body. ``so``: K4's
    outputs a point; its ``cfg`` is the trunk, whose ``output_dim`` is the
    bottleneck's so * K columns.

    Per point, with nm hidden matrices of width n (two a layer for
    resblocks) and po the chain's weights and biases
    (``shapenet_param_count``):

    * K1: the forward, 2 (si n + nm n^2 + n so); a sine an element.
    * K2 / K3: the forward, dW (the same again) and the cotangent through
      the hidden and last products, 2 (nm n^2 + n so), K3 also dx, 2 si n;
      a sine with its derivative an element; wb, x and the target (K3:
      g_out) in, d_wb (K3: and dx) out.
    * K4: the trunk's products forward (x @ W0, the hidden matrices, the
      bottleneck of nk = so K outputs), its weight grads and its du
      products (no dx), 2 (2 (si n + nm n^2 + n nk) + nm n^2 + n nk); the
      sine with derivative and 5 nk for the contraction, d_a and d_phi.
      ``f32``: the float32 kernel's bottleneck backward is matrix-vector
      work (d_phi = go_o a is an outer product for each output o): u_last^T
      go and go (W_bot a)^T, 2 n so MACs a point, and W_bot a and the outer
      product a (u_last^T go), n nk MACs each once a group.
    * K5, reverse: the forward and so dx sweeps, 2 (nm n^2 + n si) each;
      tangent: the value stream and si tangent streams through the hidden
      and last products, 2 (si n + (1 + si)(nm n^2 + n so)) (the first
      layer's tangents are W0's rows); per element the sine with its slope
      (tangent: and one product a tangent); wb, x in, y and jac out.
    * K6: three passes (forward, dW, dS) of the 1 + si stacked streams
      through the hidden and last products and x @ W0 on the value rows in
      the forward and in dW0 (no dx); act, act', act'' and 6 si tangent
      operations an element; wb, x and the value and Jacobian targets in,
      d_wb out.
    * K7: the hidden and last products over ns = 1 + si + si (si + 1) / 2
      streams and x @ W0 on the value rows; K8: three passes of those and x
      @ W0 forward and in dW0; act to act''' and the stream epilogues; y,
      jac and the pair columns out (K7), the three targets in and d_wb out
      (K8).
    """
    if kernel not in _KERNELS:
        raise ValueError(f"kernel must be one of {_KERNELS}, got {kernel!r}")
    if cfg.connectivity != "full":
        raise ValueError("kernel_cost counts a fully connected chain (K4: its trunk, "
                         f"output_dim so * K), not connectivity {cfg.connectivity!r}")
    n, si, out = cfg.units, cfg.input_dim, cfg.output_dim
    nm = _n_mats(cfg)
    po = shapenet_param_count(cfg, None)
    pts = G * P
    elems = pts * n * (1 + nm)
    e = 4 if f32 else 2
    if kernel == "K1":
        products = 2 * pts * (si * n + nm * n * n + n * out)
        act = SINE_FLOPS * elems
        nbytes = e * (G * po + pts * (si + out))
    elif kernel in ("K2", "K3"):
        dx = kernel == "K3"
        fwd = 2 * pts * (si * n + nm * n * n + n * out)
        du = 2 * pts * (nm * n * n + n * out) + (2 * pts * si * n if dx else 0)
        products = 2 * fwd + du
        act = SINE_GRAD_FLOPS * elems
        nbytes = e * (2 * G * po + pts * si + pts * out + (pts * si if dx else 0))
    elif kernel == "K4":
        if so is None:
            raise ValueError("K4 needs so, the outputs a point (cfg.output_dim is so * K)")
        nk = out
        if f32:
            products = (2 * pts * (2 * (si * n + nm * n * n) + n * nk + nm * n * n + 2 * n * so)
                        + 2 * 2 * G * n * nk)
        else:
            products = 2 * pts * (2 * (si * n + nm * n * n + n * nk) + nm * n * n + n * nk)
        act = SINE_GRAD_FLOPS * elems + 5 * pts * nk
        K = nk // so
        nbytes = e * (po + G * K + so + pts * (si + so)) + 4 * (po + G * K + so + 1)
    elif kernel == "K5":
        if body == "reverse":
            products = (2 * pts * (si * n + nm * n * n + n * out)
                        + out * 2 * pts * (nm * n * n + n * si))
            act = elems * SINE_GRAD_FLOPS
        elif body == "tangent":
            products = 2 * pts * (si * n + (1 + si) * (nm * n * n + n * out))
            act = elems * (SINE_GRAD_FLOPS + si)
        else:
            raise ValueError(f"K5's body is 'reverse' or 'tangent', got {body!r}")
        nbytes = e * (G * po + pts * (si + out + out * si))
    elif kernel == "K6":
        products = (3 * 2 * pts * (1 + si) * (nm * n * n + n * out)
                    + 2 * 2 * pts * si * n)
        act = elems * (SINE_GRAD_FLOPS + SINE_GRAD2_FLOPS + 6 * si)
        nbytes = e * (2 * G * po + pts * (si + out + si * out))
    else:  # K7, K8
        npairs = si * (si + 1) // 2
        ns = 1 + si + npairs
        stacked = 2 * pts * ns * (nm * n * n + n * out)
        first = 2 * pts * si * n
        epilogue = si + 4 * npairs  # a tangent's product, a pair's three and a sum
        if kernel == "K8":
            products = 3 * stacked + 2 * first
            act = elems * (SINE3_FLOPS + SINE4_FLOPS + 3 * epilogue)
            nbytes = e * (2 * G * po + pts * (si + out + si * out + npairs * out))
        else:
            products = stacked + first
            act = elems * (SINE3_FLOPS + epilogue)
            nbytes = e * (G * po + pts * (si + out + si * out + npairs * out))
    return {"products": float(products), "elementwise": float(act), "bytes": float(nbytes)}


def kernel_bound_ms(cost: Dict[str, float], peaks: Tuple[float, float, float],
                    f32: bool = False) -> Tuple[float, str]:
    """``(least ms, "operations" or "bytes")`` of a :func:`kernel_cost` on a
    card of ``peaks`` (:func:`card_peaks`): bf16, the larger of the products
    over the tensor-core peak and the element-wise operations over the f32
    peak; ``f32`` (no TF32: the products stay off the tensor cores), both
    together over the f32 peak; the bytes over the bandwidth where that is
    larger."""
    peak_mma, peak_f32, peak_bw = peaks
    if f32:
        t_ops = (cost["products"] + cost["elementwise"]) / peak_f32 * 1e3
    else:
        t_ops = max(cost["products"] / peak_mma, cost["elementwise"] / peak_f32) * 1e3
    t_bytes = cost["bytes"] / peak_bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def train_kernel_cost_model(
    cfg_s: ShapeNetConfig,
    n_groups: int,
    points_per_group: int,
    compute_itemsize: int = 2,
) -> Dict[str, float]:
    """Cost of ONE fused train-kernel step (``shapenet_mse_grads``, K2):
    :func:`kernel_cost` ``("K2", ...)`` under the JAX function's signature,
    in the card's units: ``mma_flops`` (the products), ``f32_ops`` (the
    activations), ``hbm_bytes`` (``compute_itemsize`` 2: the bf16 kernel's
    bytes, 4: the float32 kernel's) and ``points``.

    The JAX model's ``mxu_flops`` leaves out the products its kernel runs on
    the VPU, x @ W0 and an so = 1 last layer's forward and cotangent; the
    port counts every product, so ``mma_flops = mxu_flops + 2 G P n (si + 2
    so)``. Its ``vpu_ops`` counts the TPU kernel's own instruction mix and
    has no counterpart here.
    """
    if compute_itemsize not in (2, 4):
        raise ValueError(f"compute_itemsize is 2 (bf16) or 4 (float32), got {compute_itemsize}")
    cost = kernel_cost("K2", cfg_s, n_groups, points_per_group, f32=compute_itemsize == 4)
    return {
        "mma_flops": cost["products"],
        "f32_ops": cost["elementwise"],
        "hbm_bytes": cost["bytes"],
        "points": float(n_groups * points_per_group),
    }
