"""Tutorial 8 — Sobolev training: match derivatives, not just values.

Covers (reference tutorial/8_revisit_multi_scale_NIF_with_sobolov_training
.ipynb, README.md:234-237): feeding du/dx targets alongside u removes
spurious high-frequency signals; the separate loss terms are monitored
per-epoch (the reference uses custom Keras metrics — here the loss returns
a terms dict).

``--grouped`` runs the same problem through the scalable grouped layout
(``model.sobolev_value_and_grad``): the hypernetwork evaluates once per
time snapshot, and on the card the whole step core (forward + Jacobian +
both MSE terms + backward) is one launch of the fused Sobolev train kernel
(the float32 policy runs its CUDA-core form) — the layout that scales
Sobolev training to million-point groups. ``--trainer`` runs it through
``GroupedTrainer.fit_resident`` and ``--hessian`` adds d2u/dx2 targets
(one launch of the fused Hessian train kernel a step).

Runs on the card by default; ``--device cpu`` runs it without one.
"""
import argparse

import numpy as np
import torch

import nif_tpu_torch
from nif_tpu_torch.demo import TravelingWaveHighFreq
from nif_tpu_torch.demo.datasets import traveling_wave_dudx
from nif_tpu_torch.ops import sobolev_loss
from nif_tpu_torch.optimizers import adam

_CFG_S = {
    "connectivity": "full", "input_dim": 1, "output_dim": 1, "units": 30,
    "nlayers": 2, "weight_init_factor": 0.01, "omega_0": 30.0,
    "activation": "sine", "use_resblock": False,
}
_CFG_P = {"input_dim": 1, "latent_dim": 1, "units": 30, "nlayers": 2,
          "activation": "swish", "use_resblock": False, "omega_0": 30.0}


def _pointwise_problem():
    """The reference's tutorial-8 data: the K=400 wave packet with its
    exact analytic du/dx, chained through both normalizations: ``(inputs
    [N, 2], targets [N, 1], target_jac [N, 1, 1])``."""
    tw = TravelingWaveHighFreq()
    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)
    lo = tw.n_p + tw.n_x
    x_raw = tw.data_raw[:, 1]
    t_raw = tw.data_raw[:, 0]
    dudx_raw = traveling_wave_dudx(t_raw, x_raw, tw.wavenumber)
    # chain rule through both normalizations: d u_norm / d x_norm
    dudx_norm = dudx_raw * tw.std[1] / tw.std[lo]
    return inputs, targets, dudx_norm.reshape(-1, 1, 1).astype(np.float32)


def _print_terms(e, epochs, total, terms):
    if e % max(epochs // 10, 1) == 0:
        print(
            f"epoch {e:5d}  total {float(total):.3e}  "
            f"value {float(terms['value_mse']):.3e}  "
            f"jac {float(terms['jacobian_mse']):.3e}"
        )


def main(epochs=1000, w_jac=0.1, seed=0, device="cuda"):
    inputs, targets, target_jac = _pointwise_problem()
    model = nif_tpu_torch.NIFMultiScale(_CFG_S, _CFG_P, device=device, seed=seed)
    params = [p for _, p in model.param_items()]
    opt = adam(1e-4)(params)

    inp, tgt, tj = (torch.as_tensor(a, device=model.device)
                    for a in (inputs, targets, target_jac))
    for e in range(epochs):
        with torch.enable_grad():
            total, terms = sobolev_loss(
                model.apply, inp, tgt, target_jac=tj, w_jac=w_jac, x_index=[1]
            )
            grads = torch.autograd.grad(total, params)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        total, terms = total.detach(), {k: v.detach() for k, v in terms.items()}
        _print_terms(e, epochs, total, terms)
    return float(terms["value_mse"])


def _grouped_problem(n_xg=256, G=10):
    """Shared grouped tutorial-8 problem: (t, x, u, target_jac) with the
    analytic du/dx_norm chained through both normalizations.

    The K=400 packet needs grid spacing below pi/400 ~ 0.0079 to be
    resolvable, so the grouped variant samples the same field at n_x=256."""
    tw = TravelingWaveHighFreq(n_t=G, n_x=n_xg)
    data = np.asarray(tw.data, np.float32)  # normalized [t, x, u], t-major
    t = data[::n_xg, 0:1]
    x = data[:, 1:2].reshape(G, n_xg, 1)
    u = data[:, 2:3].reshape(G, n_xg, 1)
    lo = tw.n_p + tw.n_x
    dudx_raw = traveling_wave_dudx(
        tw.data_raw[:, 0], tw.data_raw[:, 1], tw.wavenumber)
    tj = (dudx_raw * tw.std[1] / tw.std[lo]).reshape(
        G, n_xg, 1, 1).astype(np.float32)
    return t, x, u, tj


def main_grouped(epochs=1000, w_jac=0.1, seed=0, n_xg=256, device="cuda"):
    """Grouped-layout Sobolev training: one hypernet eval per snapshot, the
    step's core one fused Sobolev kernel launch on the card."""
    t, x, u, tj = _grouped_problem(n_xg)
    model = nif_tpu_torch.NIFMultiScale(_CFG_S, _CFG_P, device=device, seed=seed)
    params = [p for _, p in model.param_items()]
    opt = adam(1e-4)(params)
    tg, xg, ug, tjg = (torch.as_tensor(a, device=model.device) for a in (t, x, u, tj))

    for e in range(epochs):
        total, terms, g = model.sobolev_value_and_grad(
            tg, xg, ug, target_jac=tjg, w_jac=w_jac
        )
        for (path, p) in model.param_items():
            grad = g
            for k in path:
                grad = grad[k]
            p.grad = grad
        opt.step()
        _print_terms(e, epochs, total, terms)
    return float(terms["value_mse"])


def main_trainer(epochs=1000, w_jac=0.1, seed=0, n_xg=256, device="cuda"):
    """The product path: ``GroupedTrainer`` in Sobolev mode.

    Identical objective to :func:`main_grouped`, but the loop is the
    trainer's — pass ``target_jac`` to ``fit_resident`` and every
    device-resident step (replayed as a CUDA graph on the card) trains value
    + jacobian MSE through the fused Sobolev kernel, with padded tails,
    meshes, and checkpoints composing like any other grouped run."""
    from nif_tpu_torch.training import GroupedTrainer

    G = 10
    t, x, u, tj = _grouped_problem(n_xg, G=G)
    model = nif_tpu_torch.NIFMultiScale(_CFG_S, _CFG_P, device=device)
    trainer = GroupedTrainer(model, adam(1e-4), w_jac=w_jac, seed=seed)
    state = trainer.init(seed)
    state = trainer.fit_resident(state, t, x, u, target_jac=tj,
                                 epochs=epochs, group_batch=G,
                                 point_batch=n_xg,
                                 verbose_every=max(epochs // 10, 1))
    print(f"path={trainer.history['sobolev_path']}  "
          f"final loss {trainer.history['loss'][-1]:.3e}")
    return trainer.history["loss"][-1]


def main_hessian(epochs=1000, w_jac=0.1, w_hess=1e-3, seed=0, n_xg=256, device="cuda"):
    """SECOND-order Sobolev training: supervise u, du/dx AND d2u/dx2 with the
    packet's analytic derivatives. On the card the whole step core —
    forward, Jacobian and Hessian tangent streams, all three MSE terms, and
    the backward — is one launch of the fused Hessian train kernel."""
    from nif_tpu_torch.demo.datasets import traveling_wave_d2udx2
    from nif_tpu_torch.training import GroupedTrainer

    G = 10
    t, x, u, tj = _grouped_problem(n_xg, G=G)
    tw = TravelingWaveHighFreq(n_t=G, n_x=n_xg)
    lo = tw.n_p + tw.n_x
    d2_raw = traveling_wave_d2udx2(
        tw.data_raw[:, 0], tw.data_raw[:, 1], tw.wavenumber)
    # chain rule through both normalizations: d2 u_n / d x_n^2
    th = (d2_raw * tw.std[1] ** 2 / tw.std[lo]).reshape(
        G, n_xg, 1, 1, 1).astype(np.float32)

    model = nif_tpu_torch.NIFMultiScale(_CFG_S, _CFG_P, device=device)
    trainer = GroupedTrainer(model, adam(1e-4), w_jac=w_jac, w_hess=w_hess, seed=seed)
    state = trainer.init(seed)
    state = trainer.fit_resident(state, t, x, u, target_jac=tj,
                                 target_hess=th, epochs=epochs,
                                 group_batch=G, point_batch=n_xg,
                                 verbose_every=max(epochs // 10, 1))
    print(f"path={trainer.history['sobolev_path']}  "
          f"final loss {trainer.history['loss'][-1]:.3e}")
    # per-term metrics incl. the second-order one — on the card the
    # evaluation rides the fused forward-over-forward kernel
    m = trainer.evaluate_sobolev(state, t, x, u, tj, target_hess=th)
    print("  " + "  ".join(f"{k}={v:.3e}" for k, v in sorted(m.items())))
    return trainer.history["loss"][-1]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--w-jac", type=float, default=0.1)
    ap.add_argument("--w-hess", type=float, default=1e-3)
    ap.add_argument("--grouped", action="store_true",
                    help="grouped layout + fused Sobolev train core")
    ap.add_argument("--trainer", action="store_true",
                    help="GroupedTrainer Sobolev mode (target_jac)")
    ap.add_argument("--hessian", action="store_true",
                    help="second-order Sobolev: + d2u/dx2 targets "
                         "(fused second-order kernel on the card)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.hessian:
        main_hessian(args.epochs, args.w_jac, args.w_hess, device=args.device)
    elif args.trainer:
        main_trainer(args.epochs, args.w_jac, device=args.device)
    elif args.grouped:
        main_grouped(args.epochs, args.w_jac, device=args.device)
    else:
        main(args.epochs, args.w_jac, device=args.device)
