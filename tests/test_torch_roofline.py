"""``nif_tpu_torch.utils.roofline`` against ``nif_tpu.utils.roofline`` and
against the bounds of PERF.md §6.

The JAX module's counts (``flops_per_point``, ``pnet_flops``,
``step_report``) are plain arithmetic on the configs: the port's must equal
them exactly over a grid of chains and hypernetworks. The kernel cost model
(``kernel_cost``, ``kernel_bound_ms``) has no JAX counterpart; it is held to
the bounds and product counts PERF.md §6 records at the shapes
``chip_smoke.py`` measures (flagship G=32 x P=32768 on the published H100
SXM peaks), to the decimals printed there.
"""
import importlib.util
import itertools
import pathlib

import pytest

from nif_tpu import config as jcfg
from nif_tpu.utils import roofline as jroof
from nif_tpu_torch import config as tcfg
from nif_tpu_torch.utils import flops_per_point, step_report
from nif_tpu_torch.utils import roofline as troof
from nif_tpu_torch.utils.bench import FLAGSHIP_SHAPE

REPO = pathlib.Path(__file__).resolve().parents[1]

# (activation, resblock) x input_dim: each case sweeps so, widths, latents
# and the (G, P) of a small batch and of the flagship step.
_CHAINS = list(itertools.product([("sine", False), ("sine", True), ("swish", False),
                                  ("swish", True)], [1, 2, 3, 4]))
_SHAPES = [(2, 16), (32, 32768)]
_IDS = [f"{a}-{'res' if r else 'plain'}-si{si}" for (a, r), si in _CHAINS]


def _pair(cls_name, **kw):
    return getattr(jcfg, cls_name)(**kw), getattr(tcfg, cls_name)(**kw)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("chain, si", _CHAINS, ids=_IDS)
def test_counts_and_step_report_equal_jax(chain, si):
    activation, resblock = chain
    n_cases = 0
    for so, width, nlayers in itertools.product([1, 2, 3], [8, 30, 128, 256], [1, 2]):
        js, ts = _pair("ShapeNetConfig", input_dim=si, output_dim=so, units=width,
                       nlayers=nlayers, activation=activation, use_resblock=resblock)
        for training in (True, False):
            assert flops_per_point(ts, training) == jroof.flops_per_point(js, training)
        for latent, p_res in itertools.product([8, 30, 128], [False, True]):
            jp, tp = _pair("ParameterNetConfig", input_dim=si + 1, latent_dim=latent,
                           units=width, nlayers=2, use_resblock=p_res)
            for (G, P), training in itertools.product(_SHAPES, (True, False)):
                assert (troof.pnet_flops(tp, ts, G, training)
                        == jroof.pnet_flops(jp, js, G, training))
                for peak in (None, 989.0, 67.0):
                    want = jroof.step_report(js, jp, G, P, 4.0288e-3, peak, training)
                    got = step_report(ts, tp, G, P, 4.0288e-3, peak, training)
                    if peak:
                        want["mfu"] = want.pop("mxu_utilization")
                    assert got == want
                    n_cases += 1
    assert n_cases == 3 * 4 * 2 * 3 * 2 * 2 * 2 * 3


# PERF.md §6 at chip_smoke.py's shapes: (kernel, shape) -> (bf16 bound ms,
# f32 bound ms, bf16 products GFLOP, f32 products GFLOP).
_TABLE = {
    ("K1", "flagship"): (0.0841, 1.1258, 69.8, 69.8),
    ("K2", "flagship"): (0.2109, 3.2393, 208.6, 208.6),
    ("K3", "flagship"): (0.2117, 3.2513, 209.4, 209.4),
    ("K4", "linear"): (0.3143, 3.7581, 310.8, 242.7),
    ("K5", "flagship"): (0.1409, 2.2056, 139.3, 139.3),
    ("K5", "tangent"): (0.2820, 4.3070, 278.9, 278.9),
    ("K6", "flagship"): (0.8387, 12.7827, 829.5, 829.5),
    ("K7", "flagship"): (0.6984, 10.6393, 690.7, 690.7),
    ("K8", "flagship"): (2.0943, 31.7735, 2071.2, 2071.2),
}


@pytest.mark.parametrize("kernel, shape", list(_TABLE), ids=[f"{k}-{s}" for k, s in _TABLE])
def test_kernel_bounds_reproduce_the_table(kernel, shape):
    smoke = _smoke()
    if shape == "flagship":
        cfg, kw = tcfg.ShapeNetConfig.from_dict(FLAGSHIP_SHAPE), {}
    elif shape == "tangent":
        cfg, kw = tcfg.ShapeNetConfig(*smoke.TANGENT_SHAPE), {"body": "tangent"}
    else:  # K4 on the NIF-linear trunk of chip_smoke's first LINEAR_CASES entry
        si, so, K, n, layers, res, om = smoke.LINEAR_CASES[0]
        cfg, kw = tcfg.ShapeNetConfig(si, so * K, n, layers, "sine", res, om), {"so": so}
    peaks = troof.card_peaks("NVIDIA H100 80GB HBM3")
    want = _TABLE[(kernel, shape)]
    for f32, ms_want, gf_want in ((False, want[0], want[2]), (True, want[1], want[3])):
        cost = troof.kernel_cost(kernel, cfg, 32, 32768, f32=f32, **kw)
        ms, by = troof.kernel_bound_ms(cost, peaks, f32)
        assert (round(ms, 4), by, round(cost["products"] / 1e9, 1)) == (ms_want, "operations",
                                                                         gf_want)
        assert smoke.kernel_bound(kernel, cfg, 32, 32768, peaks, f32, **kw) == (
            ms, by, cost["products"] / 1e9)


def test_kernel_bound_ms_takes_bytes_when_they_bind():
    cost = {"products": 1e9, "elementwise": 1e8, "bytes": 1e10}
    peaks = troof.PEAKS["H100 SXM"]
    assert troof.kernel_bound_ms(cost, peaks) == (1e10 / 3.35e12 * 1e3, "bytes")
    assert troof.kernel_bound_ms(cost, peaks, f32=True) == (1e10 / 3.35e12 * 1e3, "bytes")
    cost["bytes"] = 1.0  # bf16: the activations bind, over the f32 peak
    assert troof.kernel_bound_ms(cost, peaks) == (1e8 / 67e12 * 1e3, "operations")
    assert troof.kernel_bound_ms(cost, peaks, f32=True) == (1.1e9 / 67e12 * 1e3, "operations")
    cost["elementwise"] = 1e7  # ... here the products, over the tensor-core peak
    assert troof.kernel_bound_ms(cost, peaks) == (1e9 / 989e12 * 1e3, "operations")


@pytest.mark.parametrize("si, so", [(1, 1), (3, 1), (2, 3)])
def test_k1_counts_two_matrices_a_resblock_layer(si, so):
    G, P, n, layers = 3, 64, 16, 2
    plain = tcfg.ShapeNetConfig(si, so, n, layers, "sine", False)
    res = tcfg.ShapeNetConfig(si, so, n, layers, "sine", True)
    c_plain = troof.kernel_cost("K1", plain, G, P)
    c_res = troof.kernel_cost("K1", res, G, P)
    assert c_res["products"] == 2 * G * P * (si * n + 2 * layers * n * n + n * so)
    assert c_res["products"] - c_plain["products"] == 2 * G * P * layers * n * n
    assert c_res["elementwise"] == troof.SINE_FLOPS * G * P * n * (1 + 2 * layers)
    assert c_res["bytes"] == 2 * (G * tcfg.shapenet_param_count(res, None) + G * P * (si + so))


@pytest.mark.parametrize("name, part", [
    ("NVIDIA H100 PCIe", "H100 PCIe"),
    ("NVIDIA H100 80GB HBM3", "H100 SXM"),
    ("NVIDIA H100 SXM5 80GB", "H100 SXM"),
])
def test_card_peaks_picks_the_part_by_name(name, part):
    assert troof.card_peaks(name) == troof.PEAKS[part]


@pytest.mark.parametrize("chain, si", _CHAINS[:8], ids=_IDS[:8])
def test_train_kernel_cost_model_against_jax(chain, si):
    activation, resblock = chain
    for so, n, (G, P), itemsize in itertools.product([1, 2, 3], [16, 128], _SHAPES, (2, 4)):
        js, ts = _pair("ShapeNetConfig", input_dim=si, output_dim=so, units=n, nlayers=2,
                       activation=activation, use_resblock=resblock)
        want = jroof.train_kernel_cost_model(js, G, P, itemsize)
        got = troof.train_kernel_cost_model(ts, G, P, itemsize)
        assert got["points"] == want["points"]
        assert got["mma_flops"] == want["mxu_flops"] + 2 * G * P * n * (si + 2 * so)
        cost = troof.kernel_cost("K2", ts, G, P, f32=itemsize == 4)
        assert (got["mma_flops"], got["f32_ops"], got["hbm_bytes"]) == (
            cost["products"], cost["elementwise"], cost["bytes"])
        assert set(got) == {"mma_flops", "f32_ops", "hbm_bytes", "points"}


def test_kernel_cost_refuses_what_it_cannot_count():
    cfg = tcfg.ShapeNetConfig(3, 1, 16, 2, "sine")
    with pytest.raises(ValueError, match="one of"):
        troof.kernel_cost("K9", cfg, 1, 1)
    with pytest.raises(ValueError, match="needs so"):
        troof.kernel_cost("K4", cfg, 1, 1)
    with pytest.raises(ValueError, match="reverse"):
        troof.kernel_cost("K5", cfg, 1, 1, body="forward")
    with pytest.raises(ValueError, match="fully connected"):
        troof.kernel_cost("K1", tcfg.ShapeNetConfig(3, 1, 16, 2, "sine",
                                                    connectivity="last_layer"), 1, 1)
    with pytest.raises(ValueError, match="compute_itemsize"):
        troof.train_kernel_cost_model(cfg, 1, 1, compute_itemsize=8)
