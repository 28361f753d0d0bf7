"""The port's point-wise tutorials (``nif_tpu_torch/examples`` 02, 03, 04,
06 and 11; 01 has a file of its own, ``test_torch_examples_lbfgs.py``) on the CPU at the budgets and thresholds of
``tests/test_examples.py``, the stage functions of 04 and 11 against the
JAX package's calls on carried-across parameters (float32: rtol 1e-5, atol
1e-6), and ``optimizers.cosine_decay_schedule`` against optax's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nif_tpu
from nif_tpu.ops import output_and_jacobian as jax_output_and_jacobian
from nif_tpu.ops import output_jacobian_hessian as jax_output_jacobian_hessian
from nif_tpu.ops import output_jacobian_hessian_grouped as jax_hessian_grouped
from nif_tpu_torch.convert import from_jax_params
from nif_tpu_torch.optimizers import cosine_decay_schedule

from _torch_examples import port_example

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def test_tutorial_2_multiscale():
    mod = port_example("02_multi_scale_nif")
    mse = mod.main(epochs=30, batch_size=512, device="cpu")
    assert mse < 2.0


def test_tutorial_3_linear():
    mod = port_example("03_multi_scale_linear_nif")
    mse = mod.main(epochs=20, batch_size=1024, device="cpu")
    assert mse < 2.0


def test_tutorial_4_gradients():
    mod = port_example("04_gradients")
    mean_dudx = mod.main(epochs=30, device="cpu")
    assert mean_dudx >= 0


def test_tutorial_6_regularization():
    mod = port_example("06_regularization")
    mse = mod.run_one("l2_reg", 1e-5, epochs=20, device="cpu")
    assert mse < 2.0


def test_tutorial_11_rom_workflow():
    mod = port_example("11_rom_workflow")
    err = mod.main(epochs=150, device="cpu")
    assert np.isfinite(err)


def _carried(mod_model, jax_model, seed=0):
    params = jax_model.init(jax.random.key(seed))
    from_jax_params(mod_model, jax.tree_util.tree_map(np.asarray, params))
    return params


def _close(mine, ref):
    np.testing.assert_allclose(np.asarray(mine.detach().cpu() if isinstance(mine, torch.Tensor)
                                          else mine, np.float64),
                               np.asarray(ref, np.float64), **TOL)


def test_tutorial_4_derivatives_stage_matches_jax():
    """The Jacobian and Hessian block on parameters carried across from the
    JAX model of the same config, against the JAX package's calls."""
    import nif_tpu_torch
    from nif_tpu_torch.demo import TravelingWave

    mod = port_example("04_gradients")
    jax_model = nif_tpu.NIF(mod.cfg, mod.cfg_p)
    model = nif_tpu_torch.NIF(mod.cfg, mod.cfg_p, device="cpu")
    params = _carried(model, jax_model, seed=3)
    tw = TravelingWave()
    with torch.no_grad():
        out = mod.derivatives(model, tw)

    inputs = jnp.asarray(np.asarray(tw.data[:, :2], np.float32))
    fn = lambda inp: jax_model.apply(params, inp)  # noqa: E731
    y, jac = jax_output_and_jacobian(fn, inputs[:100])
    _, dudx = jax_output_and_jacobian(fn, inputs[:100], x_index=[1])
    y2, jac2, hess = jax_output_jacobian_hessian(fn, inputs[:10])
    inp = np.asarray(tw.data[:, :2], np.float32)
    t_g = np.unique(inp[:, :1], axis=0)
    x_g = np.broadcast_to(np.unique(inp[:, 1:], axis=0), (len(t_g), tw.n_x_grid, 1))
    yg, jg, hg = jax_hessian_grouped(jax_model, params, jnp.asarray(t_g), jnp.asarray(x_g))
    for key, ref in (("y", y), ("jac", jac), ("dudx", dudx), ("y2", y2), ("jac2", jac2),
                     ("hess", hess), ("yg", yg), ("jg", jg), ("hg", hg)):
        assert tuple(out[key].shape) == tuple(ref.shape), key
        _close(out[key], ref)
    assert float(jnp.max(jnp.abs(hg))) > 0


def test_tutorial_11_rom_stages_match_jax():
    """Steps 2-4 (encode, finer decode, latent rollout) on carried-across
    parameters, against the JAX package's subnetwork calls as the JAX
    example makes them (the numpy ``lstsq`` rollout kept)."""
    import nif_tpu_torch
    from nif_tpu.utils import rel_l2 as jax_rel_l2
    from nif_tpu_torch.demo import TravelingWave

    mod = port_example("11_rom_workflow")
    cfg_s = {"input_dim": 1, "output_dim": 1, "units": 30, "nlayers": 2, "activation": "swish"}
    cfg_p = {"input_dim": 1, "latent_dim": 2, "units": 30, "nlayers": 2, "activation": "swish"}
    jax_model = nif_tpu.NIF(cfg_s, cfg_p)
    model = nif_tpu_torch.NIF(cfg_s, cfg_p, device="cpu")
    params = _carried(model, jax_model)
    tw = TravelingWave(n_t=20, n_x=100)
    with torch.no_grad():
        out = mod.rom_stages(model, tw)

    inputs = np.asarray(tw.data[:, :2], np.float32)
    targets = np.asarray(tw.u, np.float32)
    t_grid = np.unique(inputs[:, :1], axis=0)
    latents = np.asarray(jax_model.p_to_lr(params, t_grid))
    x_fine = np.linspace(0, 1, 400, endpoint=False)[:, None].astype(np.float32)
    x_fine_n = ((x_fine - tw.mean[1]) / tw.std[1]).astype(np.float32)
    wb = jax_model.lr_to_w(params, latents[5:6])
    u_fine = jax_model.x_to_u_given_w(np.broadcast_to(x_fine_n, (400, 1)),
                                      np.broadcast_to(wb, (400, wb.shape[1])))
    A, *_ = np.linalg.lstsq(latents[:-1], latents[1:], rcond=None)
    z_roll = [latents[0]]
    for _ in range(len(latents) - 1):
        z_roll.append(z_roll[-1] @ A)
    z_roll = np.stack(z_roll)
    x_train = np.unique(inputs[:, 1:2], axis=0)
    errs = []
    for i in range(len(t_grid)):
        wb_i = jax_model.lr_to_w(params, z_roll[i: i + 1])
        u_i = jax_model.x_to_u_given_w(x_train, np.broadcast_to(wb_i, (len(x_train), wb_i.shape[1])))
        errs.append(float(jax_rel_l2(np.asarray(u_i), targets[np.isclose(inputs[:, 0], t_grid[i, 0])])))
    _close(out["latents"], latents)
    _close(out["u_fine"], u_fine)
    _close(out["z_roll"], z_roll)
    _close(out["errs"], errs)


@pytest.mark.parametrize("alpha", [0.0, 0.1])
@pytest.mark.parametrize("decay_steps", [7, 1000, 123457])
def test_cosine_decay_schedule_equals_optax(decay_steps, alpha):
    mine = cosine_decay_schedule(2e-4, decay_steps, alpha=alpha)
    ref = optax.cosine_decay_schedule(2e-4, decay_steps, alpha=alpha)
    jitted = jax.jit(ref)
    for step in (0, 1, decay_steps // 2, decay_steps, 2 * decay_steps):
        assert mine(step) == float(ref(step)), step
        # under jit (as an optax update runs it) XLA may reorder the f32
        # product and quotient: one ulp at most
        np.testing.assert_allclose(mine(step), float(jitted(jnp.int32(step))), rtol=2 ** -23)


def test_cosine_decay_schedule_advances_at_the_optimizers_count():
    from nif_tpu_torch.optimizers import adam

    sched = cosine_decay_schedule(1e-3, 10)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = adam(sched)([p])
    lrs = []
    for _ in range(12):
        p.grad = torch.ones(3)
        opt.step()
        lrs.append(opt.param_groups[0]["lr"])
    assert lrs == [sched(k) for k in range(12)]
    with pytest.raises(ValueError, match="positive decay_steps"):
        cosine_decay_schedule(1e-3, 0)
