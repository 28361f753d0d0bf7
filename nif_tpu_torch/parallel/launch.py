"""Run a function on N local ranks, one process each, and collect what each
returns: the harness behind the multi-rank tests and the card smoke test.

``run_ranks("pkg.module:function", world, kwargs)`` (or
``"path/to/file.py:function"``) starts ``world``
processes of ``python -m nif_tpu_torch.parallel.launch``; each joins the
process group over ``tcp://127.0.0.1:<free port>`` (``init_distributed``
with the given backend and device), calls ``function(**kwargs)`` and writes
its JSON-able result. Every rendezvous and collective has ``timeout``
seconds, and so has the wait for each process: a rank that fails or hangs
fails the call (all ranks are killed), its output in the error.
"""
from __future__ import annotations

import argparse
import faulthandler
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import tempfile
from typing import Any, Dict, List, Optional

__all__ = ["free_port", "rank_env", "run_ranks", "spawn_all"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env() -> Dict[str, str]:
    """The environment of a rank process: the repository on ``PYTHONPATH``
    and one CPU thread (ranks share the host's cores)."""
    run_env = dict(os.environ)
    run_env["PYTHONPATH"] = _REPO + (":" + run_env["PYTHONPATH"]
                                     if run_env.get("PYTHONPATH") else "")
    run_env["OMP_NUM_THREADS"] = "1"
    return run_env


def spawn_all(cmds: List[List[str]], env: Dict[str, str], timeout: float, what: str) -> List[str]:
    """Start every command at once and wait for all, each at most ``timeout``
    seconds; returns their output. When one fails or times out, every one
    still running is killed and ``RuntimeError`` carries all outputs."""
    procs = [subprocess.Popen(c, env=env, cwd=_REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    logs: List[str] = []
    timed_out = False
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs[len(logs):]:
            logs.append(p.communicate()[0])
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if timed_out or bad:
        detail = "\n".join(f"--- process {r} (rc={p.returncode}):\n{logs[r][-3000:]}"
                           for r, p in enumerate(procs))
        raise RuntimeError(f"{what} failed (processes {bad}"
                           f"{', timed out' if timed_out else ''}):\n{detail}")
    return logs


def run_ranks(target: str, world: int, kwargs: Optional[Dict[str, Any]] = None,
              backend: str = "gloo", device: str = "cpu", timeout: float = 300.0) -> List[Any]:
    """``[result of rank 0, ..., rank world-1]`` of ``target(**kwargs)``
    run on ``world`` local ranks (``device`` a rank: ``"cuda"`` gives rank r
    the card r, ``"cuda:0"`` puts every rank on one card, as two ranks over
    gloo can share it). Raises ``RuntimeError`` with the ranks' output when one fails."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="nif_ranks_") as tmp:
        arg_path = os.path.join(tmp, "kwargs.json")
        with open(arg_path, "w") as f:
            json.dump(kwargs or {}, f)
        outs = [os.path.join(tmp, f"rank_{r}.json") for r in range(world)]
        cmds = [[sys.executable, "-m", "nif_tpu_torch.parallel.launch", "--target", target,
                 "--rank", str(r), "--world", str(world), "--port", str(port),
                 "--backend", backend, "--device", device, "--timeout", str(timeout),
                 "--kwargs", arg_path, "--out", outs[r]]
                for r in range(world)]
        spawn_all(cmds, rank_env(), timeout, f"{target} on {world} ranks")
        results = []
        for out in outs:
            with open(out) as f:
                results.append(json.load(f))
        return results


def _resolve(target: str):
    """``"pkg.module:function"`` or ``"path/to/file.py:function"``."""
    module, name = target.rsplit(":", 1)
    if module.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(module))[0], module)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    return getattr(mod, name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--target", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--kwargs", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from .mesh import init_distributed

    torch.set_num_threads(1)
    # a rank that hangs prints every thread's stack before the parent's
    # wait runs out
    faulthandler.dump_traceback_later(max(args.timeout - 10.0, 1.0), exit=True)
    # one host: a bare "cuda" gives rank r the card r
    init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank,
                     local_device_ids=[args.rank], backend=args.backend, device=args.device,
                     timeout=args.timeout)
    try:
        with open(args.kwargs) as f:
            kwargs = json.load(f)
        result = _resolve(args.target)(**kwargs)
        with open(args.out, "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
