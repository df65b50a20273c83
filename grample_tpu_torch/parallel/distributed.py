"""Ranks of a multi-host run: ``torch.distributed`` over gloo.

Counterpart of ``jax.distributed.initialize()`` (reference
``grample_tpu/cli.py:101-107``) and of the collectives of
``grample_tpu.parallel.mesh`` (the ``psum`` of a window's counts over the
chains axis, ``:149-151``, and of the PSRF moments over both axes,
``:201-203``).  N processes, typically one per host, each owning the
devices it sees, run one ``(variants, chains)`` chain mesh together
(``parallel.mesh``).

**Splitting one host.**  Give each process its own cards with
``CUDA_VISIBLE_DEVICES``: four rank processes on a host of four NVIDIA
H100s, rank ``i`` seeing card ``i`` (its ``cuda:0``), form a 2x2 world
mesh under ``--mesh auto`` whose MAR equals one process's byte for byte
and whose ranks take the same adapt steps (``chip_smoke.py`` 8e).
Without it every rank claims every card it sees: under ``--mesh auto``
the mesh then has a position per (rank, card) pair, two or more on each
card, and an explicit ``VxC`` grid takes the first ``V*C`` of those, all
of rank 0's first, so later ranks may own none.

**Why gloo.**  The port reduces on the host: a window's count delta
reaches the host at ``flush`` whatever the mesh, and the PSRF moments are
a few [V] vectors.  Every payload is a small host array (a flush's fold
of an 18-variant run on a 916-var binary net is 18 x 917 x 2 int64, 264
KB), so a host transport costs nothing a device one would save, and gloo
also runs two ranks on one card, which NCCL refuses.

Without a process group every helper is the one-process identity: rank
0 of a world of 1, reductions return their input.  Nothing here falls
back to one process when a process group exists and a collective fails:
the failure raises.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: torchrun's variables that ``init_distributed`` needs; its ``LOCAL_RANK``
#: picks nothing here: a process owns every device it sees
ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

#: How long a collective waits for the other ranks before it raises.  A
#: rank waits out the others' longest step between two collectives: a
#: tick of device work (``engine.TICK_WORK_SECS``), an adapt step, or rank
#: 0's checkpoint write, which the others do not make.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group that torchrun's environment describes.

    Call it before any device query.  A missing variable raises
    ``ValueError`` naming it: a rank never runs a world of its own.
    """
    missing = [k for k in ENV_VARS if not os.environ.get(k)]
    if missing:
        raise ValueError(
            f"--distributed needs {', '.join(ENV_VARS)} in the environment (as torchrun "
            f"sets them); missing: {', '.join(missing)}")
    dist.init_process_group("gloo", init_method="env://", timeout=timeout)


def shutdown() -> None:
    """Leave the process group ``init_distributed`` joined."""
    dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def world_devices(local: Sequence) -> Tuple[List[torch.device], List[int]]:
    """The devices of every rank in rank order, as ``jax.devices()`` orders
    hosts, and the rank that owns each: ``local`` is this rank's list."""
    mine = [str(torch.device(d)) for d in local]
    if world() == 1:
        return [torch.device(d) for d in mine], [0] * len(mine)
    every: list = [None] * world()
    dist.all_gather_object(every, mine)
    devices = [torch.device(d) for lst in every for d in lst]
    owners = [r for r, lst in enumerate(every) for _ in lst]
    return devices, owners


def allreduce_sum(arr: np.ndarray) -> np.ndarray:
    """The element-wise sum of ``arr`` over every rank.  Exact for integer
    arrays, and for any array whose entries are each nonzero on at most
    one rank (a gather by sum)."""
    if world() == 1:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr))
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.numpy()


def from_main(values: Sequence[float]) -> np.ndarray:
    """Rank 0's ``values`` (a short float64 vector) on every rank: how the
    ranks agree on what rank 0 read from its clock."""
    t = torch.tensor(np.asarray(values, dtype=np.float64))
    if world() > 1:
        dist.broadcast(t, src=0)
    return t.numpy()
