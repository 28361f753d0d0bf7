"""A one-rank process group for the port's in-process mesh tests: the
gloo backend on the CPU over an in-memory store (no port), torn down when
the block ends, so no other test sees an initialized group."""
import contextlib

import torch.distributed as dist


@contextlib.contextmanager
def one_rank_mesh(**kw):
    from nif_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(device="cpu")
    try:
        yield make_mesh(**kw)
    finally:
        dist.destroy_process_group()
