"""Data and tensor parallelism across the cards of one host over NCCL, at
the flagship's full width (the multi-card counterpart of ``chip_smoke.py``
phases 3n and 3o, which run on one card).

On N = 2 and N = all cards, one rank a card: data-parallel
``GroupedTrainer.step`` x5 on the flagship step's G=32 x P=32768 global
batch against the one-process step (each rank also runs that on its card),
parameters equal across ranks bit for bit; the row-parallel head on a
('data', 'model') = (N/2, 2) mesh against data parallelism; ZeRO-1 on the
point-wise ``Trainer`` against the replicated one; a full-batch
``fit_resident`` whose CUDA graph holds the NCCL ``all_reduce`` against the
one-process one; host-clock and replayed step times. Then ``train
--data-parallel`` under torchrun on all cards against one process, once a
policy (``mixed_policy`` in its ``config.json``), at the flagship's
training rate: the same global batches, so every epoch line within
``CLI_LOSS_REL`` of the policy's. Other bounds are ``chip_smoke.py``'s
(BF16_LOSS_REL, BF16_REL of max|p|). Prints one JSON line a check and exits
non-zero if one fails. Needs two cards or more; ``--device cpu`` runs the
CLI check alone on four gloo ranks of the CPU over a 64 x 256 wave::

    python3 scripts/port_multi_gpu.py [--only cards|cli] [--policy float32 mixed_bfloat16]
        [--device cpu]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

RESIDENT_P = 32768
# ``train --data-parallel`` under torchrun against one process, every epoch
# line, by policy: float32 to its sum order; bf16 within BF16_LOSS_REL (each
# rank rounds its own groups' partial sums to bf16 before the f32 average,
# one process the whole batch's once). At FLAGSHIP_TRAIN_LR the six steps
# are stable; at 10x that rate one process against itself with the rate
# moved by one float32 ulp drifts 1e-3 by the last epoch, as far as a rank
# fault moves it (PERF.md §6).
CLI_LOSS_REL = {"float32": 1e-5, "mixed_bfloat16": cs.BF16_LOSS_REL}
CPU_RANKS, CPU_P = 4, 256


def ranks_cards(seed: int) -> dict:
    """One rank of a run over N cards (its own process, its own card)."""
    import torch
    import torch.distributed as dist

    from nif_tpu_torch.parallel import collectives, make_mesh

    cs._tf32_off(torch)
    n = dist.get_world_size()
    t, x, u = cs.traveling_wave(cs.MESH_G, cs.MESH_P, seed)
    out = {"world": n}
    dp = make_mesh()
    tr, state = cs._mesh_trainer(torch, dp, seed)
    out["dp_losses"], out["dp_ms"] = cs._steps(torch, tr, state, (t, x, u), cs.MESH_STEPS)
    dp_params, out["dp_digest"] = cs._flat_params(tr.model)
    del tr, state
    one, ostate = cs._mesh_trainer(torch, None, seed)
    out["one_losses"], out["one_ms"] = cs._steps(torch, one, ostate, (t, x, u), cs.MESH_STEPS)
    one_params, _ = cs._flat_params(one.model)
    out["dp_vs_one"] = cs._param_gap(dp_params, one_params)
    del one, ostate
    tp = make_mesh(axis_names=("data", "model"), mesh_shape=(n // 2, 2))
    ttr, tstate = cs._mesh_trainer(torch, tp, seed, shard_model_axis=True)
    out["tp_losses"], out["tp_ms"] = cs._steps(torch, ttr, tstate, (t, x, u), cs.MESH_STEPS)
    tp_params, out["tp_digest"] = cs._flat_params(ttr.model)
    out["tp_vs_dp"] = cs._param_gap(tp_params, dp_params)
    del ttr, tstate
    rows = np.concatenate([np.repeat(t[:2], 8192, 0), x[:2, :8192].reshape(-1, 3)],
                          1).astype(np.float32)
    target = u[:2, :8192].reshape(-1, 1)
    zero = {}
    for name, shard in (("replicated", False), ("zero1", True)):
        ptr, pstate = cs._mesh_trainer(torch, dp, seed, "Trainer", shard_opt_state=shard)
        ptr.fit(pstate, rows, target, epochs=1, batch_size=4096)
        zero[name] = (ptr.history["loss"], cs._flat_params(ptr.model)[0])
    out["zero1_losses"] = [zero["replicated"][0], zero["zero1"][0]]
    out["zero1_vs_replicated"] = cs._param_gap(zero["zero1"][1], zero["replicated"][1])
    res = {}
    for name, m in (("mesh", dp), ("one", None)):
        rtr, rstate = cs._mesh_trainer(torch, m, seed, capturable=True)
        before = dict(collectives.COUNTS)
        rtr.fit_resident(rstate, t, x, u, epochs=6, group_batch=cs.MESH_G, point_batch=RESIDENT_P)
        res[name] = {"losses": rtr.history["loss"], "form": rtr.history["resident_graph"],
                     "step_ms": rtr.history["resident_step_ms"],
                     "all_reduce": {k: collectives.COUNTS[k] - before[k] for k in before},
                     "params": cs._flat_params(rtr.model)[0]}
        del rtr, rstate
    out["resident"] = {k: {kk: vv for kk, vv in v.items() if kk != "params"}
                       for k, v in res.items()}
    out["resident_gap"] = cs._param_gap(res["mesh"]["params"], res["one"]["params"])
    return out


def _rel(a, b):
    return float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))


def check_cards(n: int, smi: str) -> bool:
    from nif_tpu_torch.parallel.launch import run_ranks

    t0 = time.perf_counter()
    rs = run_ranks(f"{os.path.abspath(__file__)}:ranks_cards", n, {"seed": 23},
                   backend="nccl", device="cuda", timeout=900)
    r = rs[0]
    ok = (len({x["dp_digest"] for x in rs}) == 1 and len({x["tp_digest"] for x in rs}) == 1
          and _rel(r["dp_losses"], r["one_losses"]) <= cs.BF16_LOSS_REL
          and r["dp_vs_one"] <= cs.BF16_REL
          and _rel(r["tp_losses"], r["dp_losses"]) <= cs.BF16_LOSS_REL
          and r["tp_vs_dp"] <= cs.BF16_REL
          and _rel(r["zero1_losses"][1], r["zero1_losses"][0]) <= cs.BF16_LOSS_REL
          and r["zero1_vs_replicated"] <= cs.BF16_REL
          and r["resident"]["mesh"]["form"] == "step"
          and r["resident"]["mesh"]["all_reduce"] == {"all_reduce": 2, "captured": 1}
          and _rel(r["resident"]["mesh"]["losses"], r["resident"]["one"]["losses"])
          <= cs.BF16_LOSS_REL and r["resident_gap"] <= cs.BF16_REL)
    print(json.dumps({"check": f"{n} cards over NCCL", "ok": ok,
                      "seconds": time.perf_counter() - t0, "card": smi,
                      "loss_rel_dp_one": _rel(r["dp_losses"], r["one_losses"]),
                      "loss_rel_tp_dp": _rel(r["tp_losses"], r["dp_losses"]),
                      "ranks": rs}), flush=True)
    return ok


def check_cli(n: int, smi: str, policy: str, device: str = "cuda") -> bool:
    """``train --data-parallel`` under torchrun on ``n`` ranks against one
    process, the flagship under ``policy`` over a 64 x 32768 traveling wave
    (64 x ``CPU_P`` on the CPU)."""
    from nif_tpu_torch.data import GroupedDataset
    from nif_tpu_torch.parallel.launch import rank_env
    from nif_tpu_torch.utils.bench import FLAGSHIP_PNET, FLAGSHIP_SHAPE, FLAGSHIP_TRAIN_LR

    P = cs.CLI_P if device == "cuda" else CPU_P
    d = tempfile.mkdtemp(prefix="nif_cli_cards_")
    t, x, u = cs.traveling_wave(cs.CLI_G, P, 21)
    GroupedDataset.create_from_arrays(t, x, u, os.path.join(d, "snaps"), groups_per_file=32)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"cfg_shape_net": FLAGSHIP_SHAPE, "cfg_parameter_net": FLAGSHIP_PNET,
                   "mixed_policy": policy}, f)
    args = ["-m", "nif_tpu_torch", "train", "--config", os.path.join(d, "config.json"),
            "--data", os.path.join(d, "snaps"), "--model", "multiscale",
            "--epochs", str(cs.CLI_EPOCHS), "--lr", str(FLAGSHIP_TRAIN_LR),
            "--group-batch", "32", "--point-batch", str(P), "--data-parallel",
            "--device", device]
    env = rank_env() if device == "cpu" else dict(os.environ, PYTHONPATH=REPO)
    runs = {}
    for name, cmd in (("one", [sys.executable] + args),
                      ("torchrun", [sys.executable, "-m", "torch.distributed.run",
                                    "--nproc-per-node", str(n), "--no-python",
                                    sys.executable] + args)):
        t0 = time.perf_counter()
        p = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith(("epoch", "final loss"))]
        runs[name] = {"rc": p.returncode, "seconds": time.perf_counter() - t0, "lines": lines,
                      "err": p.stderr[-2000:] if p.returncode else ""}
    losses = [[float(ln.split()[-1]) for ln in runs[k]["lines"]] for k in ("torchrun", "one")]
    gaps = ([_rel(a, b) for a, b in zip(*losses)]
            if all(r["rc"] == 0 for r in runs.values()) else [])
    ok = (len(gaps) == cs.CLI_EPOCHS + 1 == len(losses[1])
          and max(gaps) <= CLI_LOSS_REL[policy])
    print(json.dumps({"check": f"cli --data-parallel under torchrun on {n} {device} ranks, "
                      f"{policy}", "ok": ok, "card": smi, "rel_per_line": gaps,
                      "bound": CLI_LOSS_REL[policy], "runs": runs}), flush=True)
    return ok


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["cards", "cli"], default=None,
                    help="run only the mesh checks or only the CLI under torchrun")
    ap.add_argument("--policy", nargs="+", choices=sorted(CLI_LOSS_REL),
                    default=sorted(CLI_LOSS_REL), help="the CLI check's policies, in turn")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help=f"cpu: the CLI check alone on {CPU_RANKS} gloo ranks of the CPU")
    args = ap.parse_args()
    if args.device == "cpu":
        return 0 if all([check_cli(CPU_RANKS, "cpu", policy, "cpu")
                         for policy in args.policy]) else 1
    n = torch.cuda.device_count()
    if n < 2:
        print(f"port_multi_gpu: needs two cards or more, found {n}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    # the CLI alone runs the fused K1 geometry and both K2s (the model's
    # gate asks the forward libraries)
    cs.build_all(["shapenet_fwd", "shapenet_fwd_tc", "shapenet_fwd_wgmma", "shapenet_bwd",
                  "shapenet_bwd_tc"]
                 if args.only == "cli" else
                 ["shapenet_fwd", "shapenet_fwd_tc", "shapenet_fwd_wgmma", "shapenet_bwd",
                  "shapenet_bwd_tc", "shapenet_jac", "shapenet_jac_tc", "shapenet_hess",
                  "shapenet_hess_tc", "shapenet_linear", "shapenet_linear_tc"])
    oks = [] if args.only == "cli" else [check_cards(k, smi) for k in sorted({2, n})]
    if args.only != "cards":
        oks += [check_cli(n, smi, policy) for policy in args.policy]
    return 0 if all(oks) else 1


if __name__ == "__main__":
    sys.exit(main())
