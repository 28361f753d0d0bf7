"""The deep plain chain ``ShapeNetConfig(3, 1, 128, 7, "sine", False,
30.0)`` in bfloat16: the reference's K1 (``nif_tpu.ops.pallas_shapenet.
shapenet_grouped_fused``, the Pallas kernel in interpret mode) against the
committed fixture ``tests/data/k1_deep_chain_bf16.npz`` and the port's plain
K1 (``shapenet_grouped_fused_reference``) on the CPU.

The fixture holds the reference's output at G = 2, P = 96 for each of the
stored seeds (0-31 and 51), on weights and x made with numpy from the seed
(as the card tests make theirs), as bf16 bits, so the card test of the
routed ``mma.sync`` K1 at this chain
(``tests/test_torch_kernels_cuda.py::test_k1_deep_plain_chain_against_the_
reference_fixture``) holds the kernel against the reference where JAX is
absent. The reference itself sits 2.18e-3 to 7.32e-2 of max|plain| from
plain K1 over these seeds (``REFERENCE_GAPS``): seven sine layers at
omega_0 = 30 amplify a bf16 rounding that flips with the order of an f32
sum, so two right bf16 chains land that far apart (the float32 chain sits
0.54-1.43 of max|plain| from both).

Rewrite the fixture (after a deliberate change of the reference) with
``JAX_PLATFORMS=cpu python tests/test_torch_k1_deep_chain.py``.
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nif_tpu.config as jcfg
import nif_tpu.ops.pallas_shapenet as jps
import nif_tpu_torch.config as tcfg
from nif_tpu_torch.ops import fused_shapenet as fs

torch.set_num_threads(1)

DEEP = (3, 1, 128, 7, "sine", False, 30.0)
G, P = 2, 96
SEEDS = tuple(range(32)) + (51,)
FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "k1_deep_chain_bf16.npz"
# the reference's distance from plain K1 at this chain, in max|plain|, a seed each
REFERENCE_GAPS = {
    0: 0.06775700934579439, 1: 0.0049261083743842365, 2: 0.004347826086956522,
    3: 0.013100436681222707, 4: 0.010187224669603524, 5: 0.033854166666666664,
    6: 0.024019607843137256, 7: 0.004166666666666667, 8: 0.036036036036036036,
    9: 0.03550469483568075, 10: 0.027292576419213975, 11: 0.04924242424242424,
    12: 0.012658227848101266, 13: 0.011405109489051095, 14: 0.002183406113537118,
    15: 0.031746031746031744, 16: 0.0045045045045045045, 17: 0.0731981981981982,
    18: 0.015748031496062992, 19: 0.012218045112781954, 20: 0.005208333333333333,
    21: 0.01991150442477876, 22: 0.004201680672268907, 23: 0.011642156862745098,
    24: 0.017045454545454544, 25: 0.01951219512195122, 26: 0.04372427983539095,
    27: 0.010822510822510822, 28: 0.01393581081081081, 29: 0.0046641791044776115,
    30: 0.021475770925110133, 31: 0.00744047619047619, 51: 0.0171875,
}


def _inputs(seed):
    """wb' and x in bf16, made as the card tests' ``_data`` makes them."""
    cfg = tcfg.ShapeNetConfig(*DEEP)
    rng = np.random.default_rng(seed)
    wb = rng.standard_normal((G, tcfg.shapenet_param_count(cfg, 0))) * (0.3 / cfg.omega_0)
    x = rng.standard_normal((G, P, cfg.input_dim))
    return (torch.from_numpy(wb.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))


def _reference_bits():
    """The reference's K1 in bf16 (interpret mode) for every seed, as uint16
    bits [seeds, G, P, 1]: one call over the seeds' groups side by side,
    which gives each group the bits it gets alone (groups share nothing)."""
    wb, x = (torch.cat(t) for t in zip(*map(_inputs, SEEDS)))
    out = jps.shapenet_grouped_fused(jnp.asarray(wb.float().numpy(), jnp.bfloat16),
                                     jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                     jcfg.ShapeNetConfig(*DEEP), "siren", True)
    bits = torch.from_numpy(np.array(jnp.asarray(out, jnp.float32))).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return bits.reshape(len(SEEDS), G, P, -1)


def _trunc32(v):
    """f64 -> f32, rounded toward zero."""
    f = v.float()
    return torch.where(f.double().abs() > v.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _blocked_chain(wb, x, add):
    """The deep chain with plain K1's rounding points, each product summed
    over blocks of 16 k: a block's sum of exact bf16 products is taken
    exactly, then ``add`` = "truncate" adds it to the running f32 sum
    rounding toward zero (the tensor core's own accumulate), "nearest" rounds
    it toward zero alone (a product on a zero accumulator) and adds it by an
    f32 add, which rounds to nearest (the mma.sync K1's hidden products);
    "exact" sums the whole product exactly and rounds it once."""
    cfg = tcfg.ShapeNetConfig(*DEEP)
    parts = fs.unpack_shapenet_weights(fs._prescale(wb, cfg, "siren"), cfg)
    act = fs._activation(cfg, "siren", torch.bfloat16)

    def product(u, w):
        u, w = u.to(torch.bfloat16).double(), w.to(torch.bfloat16).double()
        if add == "exact":
            return (u @ w).float()
        acc = torch.zeros(u.shape[:-1] + w.shape[-1:], dtype=torch.float32)
        for k in range(0, u.shape[-1], 16):
            block = u[..., k:k + 16] @ w[..., k:k + 16, :]
            acc = (_trunc32(acc.double() + block) if add == "truncate"
                   else acc + _trunc32(block))
        return acc

    u = act(product(x, parts["w_first"]) + parts["b_first"].float().unsqueeze(-2))
    for w, b in zip(parts["w_hidden"], parts["b_hidden"]):
        u = act(product(u, w) + b.float().unsqueeze(-2))
    out = product(u, parts["w_last"]) + parts["b_last"].float().unsqueeze(-2)
    return out.to(torch.bfloat16)


def _model_gaps():
    """{seed: (reference, "truncate", "nearest", "exact") distance from
    plain K1 in max|plain|}."""
    cfg = tcfg.ShapeNetConfig(*DEEP)
    gaps = {}
    for seed in SEEDS:
        wb, x = _inputs(seed)
        plain = fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren").float()
        scale = float(plain.abs().max())
        gaps[seed] = tuple(float((o.float() - plain).abs().max()) / scale for o in (
            _fixture_out(seed), *(_blocked_chain(wb, x, add)
                                   for add in ("truncate", "nearest", "exact"))))
    return gaps


def _fixture_out(seed):
    with np.load(FIXTURE) as z:
        assert tuple(z["chain"]) == tuple(str(a) for a in DEEP)
        assert tuple(z["seeds"]) == SEEDS and (int(z["G"]), int(z["P"])) == (G, P)
        bits = z["out_bits"][SEEDS.index(seed)]
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def test_the_committed_fixture_is_the_reference_output():
    bits = _reference_bits()
    with np.load(FIXTURE) as z:
        assert z["out_bits"].dtype == np.uint16 and z["out_bits"].shape == (len(SEEDS), G, P, 1)
        assert np.array_equal(z["out_bits"], bits)


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_k1_sits_the_recorded_gap_from_the_reference(seed):
    """Plain K1 on a seed's inputs sits its recorded gap from the reference
    (2.18e-3 to 7.32e-2 of max|plain| over the seeds), while at the flagship
    depth the two agree within the port's 2-ulp bound
    (``test_torch_shapenet.py``); the float32 chain sits far from both, so
    the gap is the bf16 chain's own rounding, not either implementation's."""
    wb, x = _inputs(seed)
    cfg = tcfg.ShapeNetConfig(*DEEP)
    plain = fs.shapenet_grouped_fused_reference(wb, x, cfg, "siren").float()
    ref = _fixture_out(seed).float()
    scale = float(plain.abs().max())
    gap = float((ref - plain).abs().max()) / scale
    assert gap == REFERENCE_GAPS[seed]
    f32 = fs.shapenet_grouped_fused_reference(wb.float(), x.float(), cfg, "siren")
    assert float((f32 - plain).abs().max()) / scale > 0.5
    assert float((f32 - ref).abs().max()) / scale > 0.5


def test_a_truncating_accumulate_doubles_the_chains_scatter():
    """The chain with each product's blocks added the tensor core's way
    (rounding toward zero) sits about twice as far from plain K1 as the
    reference does (median over the seeds 1.9x) and past the reference's
    largest gap; added by f32 adds that round to nearest, within the
    reference's scatter (median and largest no larger). The card test holds
    the mma.sync K1, which adds its blocks to nearest, to the reference's
    largest gap over the seeds, not to each seed's own: the chain summed
    exactly, right by construction, stays within the largest but sits past
    max(that seed's gap, 1e-2) at some seeds."""
    gaps = np.array(list(_model_gaps().values()))
    ref, trunc, nearest, exact = gaps.T
    assert np.median(trunc) > 1.5 * np.median(ref) and trunc.max() > ref.max()
    assert np.median(nearest) <= np.median(ref) and nearest.max() <= ref.max()
    assert exact.max() <= ref.max() and (exact > np.maximum(ref, 1e-2)).any()


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["--models"]:
        gaps = _model_gaps()
        print("seed: reference / truncate / nearest / exact, distance from plain K1 in "
              "max|plain|")
        for seed, row in gaps.items():
            print(f"{seed}: " + " / ".join(f"{v:.4e}" for v in row))
        rows = np.array(list(gaps.values()))
        print("median " + " / ".join(f"{v:.4e}" for v in np.median(rows, 0)))
        print("largest " + " / ".join(f"{v:.4e}" for v in rows.max(0)))
        sys.exit()
    np.savez(FIXTURE, out_bits=_reference_bits(), seeds=np.array(SEEDS), G=G, P=P,
             chain=np.array([str(a) for a in DEEP]))
    print(f"wrote {FIXTURE}")
