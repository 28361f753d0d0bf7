#!/usr/bin/env python3
"""The int8 ROM decode's error at the NIF-linear flagship's width, in the
JAX package and in the port, on the same parameters (CPU):

    JAX_PLATFORMS=cpu python3 scripts/int8_decode_error.py [--seeds 3] [--P 4096] [--G 64]

For each policy and seed, the JAX model draws the parameters
(``init(jax.random.key(seed))``), the port loads them (``from_jax_params``),
and both decode ``G`` snapshots onto one ``P``-point mesh (numpy inputs from
seed 7): rel-L2 of ``rom_decode_int8`` against ``apply_shared_mesh`` in
each package, and the rel-L2 that int8 rounding of the port's operands
predicts (each entry's rounding uniform over one step). A CPU script: it
measures arithmetic, not time.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import nif_tpu  # noqa: E402
from nif_tpu import compression as jc  # noqa: E402
import nif_tpu_torch  # noqa: E402
from nif_tpu_torch import compression as tc  # noqa: E402
from nif_tpu_torch.compression.quantization import _quantize_rows  # noqa: E402
from nif_tpu_torch.convert import from_jax_params  # noqa: E402
from nif_tpu_torch.models.parameter_net import parameter_net_apply  # noqa: E402
from nif_tpu_torch.utils.bench import FLAGSHIP_PNET, LINEAR_SHAPE  # noqa: E402


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def predicted(model, pack, t) -> float:
    """The rel-L2 int8 rounding adds: per entry of the field, variance
    ``sum_k a_k^2 s_phi^2 / 12 + phi_k^2 s_a^2 / 12``, over the float
    decode of the same operands."""
    P, so, K = pack["shape"]
    with torch.no_grad():
        phi = model.x_to_phi(pack["x"]).float().reshape(P * so, K).double()
        a = parameter_net_apply(model.pnet.params, t, model.cfg_parameter_net,
                                model.pnet_kind)[0].float()
        _, s_a = _quantize_rows(a)
        a = a.double()
        noise = ((a ** 2).sum(1)[:, None] * pack["s_phi"].double()[None, :] ** 2
                 + s_a.double()[:, None] ** 2 * (phi ** 2).sum(1)[None, :]) / 12
        field = a @ phi.T + pack["bias"].double()
    return float(torch.sqrt(noise.sum()) / torch.linalg.vector_norm(field))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--P", type=int, default=4096)
    ap.add_argument("--G", type=int, default=64)
    args = ap.parse_args()
    torch.set_num_threads(4)
    rng = np.random.default_rng(7)
    t = rng.standard_normal((args.G, 4)).astype(np.float32)
    x = rng.standard_normal((args.P, 3)).astype(np.float32)
    print(f"NIF-linear flagship (so=1, K=128), G={args.G} x P={args.P}; rel-L2 of the int8 "
          f"decode vs apply_shared_mesh")
    print("policy          seed  JAX         port        int8 rounding predicts")
    for policy in ("float32", "mixed_bfloat16"):
        for seed in range(args.seeds):
            jm = nif_tpu.NIFMultiScaleLastLayerParameterized(LINEAR_SHAPE, FLAGSHIP_PNET,
                                                             mixed_policy=policy)
            params = jm.init(jax.random.key(seed))
            tm = nif_tpu_torch.NIFMultiScaleLastLayerParameterized(
                LINEAR_SHAPE, FLAGSHIP_PNET, policy, device="cpu")
            from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
            jpack = jc.quantize_shared_mesh(jm, params, jnp.asarray(x))
            j_rel = rel_l2(jc.rom_decode_int8(jm, params, jpack, jnp.asarray(t)),
                           jm.apply_shared_mesh(params, jnp.asarray(t), jnp.asarray(x)))
            pack = tc.quantize_shared_mesh(tm, x)
            with torch.no_grad():
                t_rel = rel_l2(tc.rom_decode_int8(tm, pack, t), tm.apply_shared_mesh(t, x))
            pred = predicted(tm, dict(pack, x=x), torch.from_numpy(t))
            print(f"{policy:15s} {seed:4d}  {j_rel:.4e}  {t_rel:.4e}  {pred:.4e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
