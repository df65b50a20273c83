"""Chains sharded over several devices, of one process or of several.

Counterpart of ``grample_tpu.parallel.mesh``.  The devices form a 2-D
grid ``("variants", "chains")``:

  - ``variants`` shards the variant slot axis N in contiguous blocks of
    ``slot_cap / vdim`` slots: each row of the grid holds its own
    variants' sweep tensors;
  - ``chains`` shards the micro-chain axis C in contiguous blocks of
    ``cpv / cdim`` chains: pure data parallelism over Gibbs chains.

The reference is one program that runs the sweep under ``shard_map`` and
reduces with ``psum``.  The port launches a window on each of its
devices in turn from Python: launches are asynchronous and a sweep needs
no communication, so the devices run side by side (on four NVIDIA H100
80GB HBM3 at 700.00 W a 256-sweep window of 262144 chains a card took
68.8 ms of wall against 67.8 ms on one card; ``chip_smoke.py`` 8b).  The reductions
happen where the unsharded group already has them, on the host: each
shard's window delta stays on its device until ``flush`` adds it into
the float64 totals, and the PSRF moments of the shards (two [V] vectors
and a count each) are summed before ``psrf_from_moments``.

**One process or several.**  A mesh built without ``ranks`` belongs to
one process, which holds every shard.  A mesh over the devices of several
processes (``ranks``: the owner of each grid position, from
``parallel.distributed.world_devices``) gives each process the shards of
its own positions only; every host read of the group is then a
collective over ``torch.distributed`` that every rank makes, in the same
order, because every rank makes the same calls on the group: ``flush``
all-reduces the sum of its pending deltas once, the moments and the RB
blanket indices are filled by their owners and all-reduced (each entry
has one owner, so the sum is exact), and ``state``, ``halves`` and one
slot's states are gathered the same way.  The shards' moments are summed
in grid order after the reduction, so every rank, and a one-process
group on a mesh of the same shape, gets the same float32 PSRF.  The
wall-clock decisions that drive these calls are rank 0's
(``sampler.engine``).

**Draws do not depend on the mesh.**  The sweep's hash cell is ``seed +
65537 * variant + 257 * (chain // cb)`` mod 2^32 (``ops.gibbs_torch.
window_cell``, the same in the CUDA kernel).  A shard that starts at
variant ``v0`` and chain ``c0`` is launched with ``shard_seed``: the
window's seed plus ``65537 * v0 + 257 * (c0 // cb)``, so its local cells
are the unsharded window's cells, provided ``cb`` divides the local chain
width (``cb = hash_block(cpv // cdim)``).  A sharded group therefore
equals a ``ChainGroup`` with the same ``cb`` and slot capacity bit for
bit on state, halves and totals, on any mesh and over any number of
processes, and a checkpoint written on one mesh resumes on another (the
snapshot carries ``cb``).  The reference instead folds the shard's grid
position into its key (``mesh.py:131-136``), so its draws change with
the mesh.

**What this class replaces.**  ``ChainGroup`` issues every window, and
counts its launches, over the launches that ``launches`` yields; here one
per shard that holds a slot of the active prefix, each shard the holder
of its own ``state`` and ``halves``, so the base class's window loop,
warm-up, tempered burn-in, launch counters, ``_window_delta`` (one delta
per active shard, in shard order) and ``flush`` (their sum, reduced over
the processes by ``_reduce``) serve both classes.  What is left here is
the geometry: the slot-wise placement (``_place``, ``_write_slots``,
``_scatter``), the reduction, the host reads (``state``, ``halves``,
``_slot_state``, ``_rb_index_rows``) and the PSRF moments.  ``state``
and ``halves`` are read-only properties that gather the shards to the
host, for the rare readers (a checkpoint, a restack, a test); nothing on
the hot path reads them, and an assignment raises.  ``kstack`` is, per
grid row, the row's ``ops.sweep.SweepStack`` on this process's devices of
the row (None for a row of other processes): the chain shards of a row
share the row's tensors, one copy per device, made when the row changes
and not per window.

A device may appear several times in a mesh (``chain_mesh(devices=...)``):
its shards then run one after the other on one stream.  That virtual mesh
is how the tests run a 2x2 grid on the CPU and the smoke run on one card;
its times say nothing about scaling.

A shard whose slice of the active slot prefix is empty launches nothing.
Contiguous variant blocks therefore leave a grid row idle while the
prefix is short (2 variants in a capacity of 4 on a 2x2 mesh both sit in
row 0), and unbalanced while it fills the first row: an adaptive run on
a 2x2 mesh of H100s (700.00 W) that grew to 10 variants in 16 slots held 8 active
slots in row 0 and 2 in row 1, and the row-1 cards were busy a third as
long (``chip_smoke.py`` 8d).  An interleaved layout would break the seed
arithmetic above.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from grample_tpu_torch.metrics.psrf import convergence_moments, psrf_from_moments
from grample_tpu_torch.ops.sweep import SweepStack, hash_block
from grample_tpu_torch.parallel import distributed
from grample_tpu_torch.sampler.chains import ChainGroup, _rb_indices, shard_seed  # noqa: F401

VARIANT_AXIS = "variants"
CHAIN_AXIS = "chains"


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """A ``(variants, chains)`` grid of devices: ``devices[vi][ci]``, owned
    by the ranks ``ranks[vi][ci]``, or by this one process (``ranks``
    None)."""

    devices: tuple
    ranks: Optional[tuple] = None

    @property
    def shape(self) -> dict:
        return {VARIANT_AXIS: len(self.devices), CHAIN_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def owns(self, vi: int, ci: int) -> bool:
        """Whether this process holds grid position (vi, ci)."""
        return self.ranks is None or self.ranks[vi][ci] == distributed.rank()

    def local_devices(self) -> list:
        """This process's distinct devices, in grid order: one for a
        virtual mesh, as many as the grid for a mesh of real cards."""
        return list(dict.fromkeys(dev for vi, row in enumerate(self.devices)
                                  for ci, dev in enumerate(row) if self.owns(vi, ci)))


def chain_mesh(n_devices: Optional[int] = None, variant_ways: int = 0,
               devices: Optional[Sequence] = None,
               ranks: Optional[Sequence[int]] = None) -> ChainMesh:
    """Build the ``(variants, chains)`` device mesh.

    Without ``devices`` the mesh takes ``cuda:0 .. cuda:n-1``.  ``devices``
    is an explicit list that may name one device several times (a virtual
    mesh, see the module doc); ``ranks``, beside it, names the process
    that owns each (``distributed.world_devices``), for a mesh over the
    devices of several processes.  ``n_devices`` takes the first so many
    and raises when there are fewer.  ``variant_ways`` splits the grid
    between the axes; by default variants get the largest power of two
    ``vw`` with ``vw * vw * 4 <= n`` (reference ``mesh.py:63-68``).
    """
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"a mesh of {n_devices} devices needs that many; "
                             f"this {'world' if ranks else 'machine'} has {len(devs)}")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("no CUDA device for a mesh: name the devices")
    if variant_ways <= 0:
        variant_ways = 1
        while variant_ways * variant_ways * 4 <= n:
            variant_ways *= 2
    if n % variant_ways != 0:
        raise ValueError(f"{n} devices not divisible by variant_ways={variant_ways}")
    cways = n // variant_ways

    def grid(seq):
        return tuple(tuple(seq[vi * cways:(vi + 1) * cways]) for vi in range(variant_ways))

    return ChainMesh(grid(devs), None if ranks is None else grid(list(ranks)[:n]))


@dataclasses.dataclass
class Shard:
    """One device's block of slots and chains."""

    vi: int
    ci: int
    device: torch.device
    v0: int  # first slot
    c0: int  # first chain
    state: torch.Tensor  # [n_local, c_local, V+1] int32
    halves: torch.Tensor  # [n_local, 2, c_local, V+1, K] int32


class ShardedChainGroup(ChainGroup):
    """``ChainGroup`` whose tensors live in shards over a device mesh.

    Drop-in for :class:`ChainGroup`: the engine, the adaptive controller
    and the checkpoints are unchanged.  ``chains_per_variant`` must be a
    multiple of the mesh's ``chains`` extent; the slot capacity is
    rounded up to a multiple of its ``variants`` extent.  ``device`` is
    accepted, so that one factory can build either class, and ignored:
    the mesh names the devices.  Over the devices of several processes,
    each holds the shards of its own grid positions and every process
    makes the same calls (see the module doc).
    """

    def __init__(self, base_model, chains_per_variant: int, converge_window: int,
                 device=None, *, mesh: Optional[ChainMesh] = None, **kw):
        self.mesh = mesh or chain_mesh()
        self.shards: List[Shard] = []
        self._placed = 0  # the slot capacity the shards were cut for
        super().__init__(base_model, chains_per_variant, converge_window,
                         self.mesh.devices[0][0], **kw)
        cdim = self.mesh.shape[CHAIN_AXIS]
        if self.cpv % cdim != 0:
            raise ValueError(f"chains_per_variant={self.cpv} not divisible by mesh "
                             f"chains axis {cdim}")
        self.cb = hash_block(self.local_chains)

    # ---- geometry --------------------------------------------------------
    @property
    def local_chains(self) -> int:
        return self.cpv // self.mesh.shape[CHAIN_AXIS]

    @property
    def local_slots(self) -> int:
        return self.slot_cap // self.mesh.shape[VARIANT_AXIS]

    def _round_cap(self, slot_cap: int) -> int:
        vdim = self.mesh.shape[VARIANT_AXIS]
        return -(-max(slot_cap, 1) // vdim) * vdim

    def _row(self, vi: int) -> List[Shard]:
        """This process's shards of grid row ``vi``."""
        return [sh for sh in self.shards if sh.vi == vi]

    def _reduce(self, arr: np.ndarray) -> np.ndarray:
        """``arr`` summed over the mesh's processes (one process: as is)."""
        return arr if self.mesh.ranks is None else distributed.allreduce_sum(arr)

    def launches(self):
        """(shard, first slot, first chain, active slots, the row's sweep
        stack) for every shard of this process that holds a slot of the
        active prefix."""
        nact = max(1, self.num_variants)
        for sh in self.shards:
            na = min(nact - sh.v0, self.local_slots)
            if na > 0:
                yield sh, sh.v0, sh.c0, na, self.kstack[sh.vi]

    # ---- the whole tensors, for the rare readers -------------------------
    def _gather(self, name: str, inner: tuple, tail: tuple):
        """Host copy [Ncap, *inner, C, *tail] of every shard's tensor
        ``name``, at the capacity the shards were cut for (a restack reads
        it before it cuts anew).  Each process fills its own blocks, and
        the blocks of the others arrive by a sum (one owner per entry)."""
        if not self._placed:
            return None
        out = np.zeros((self._placed, *inner, self.cpv, *tail), dtype=np.int32)
        for sh in self.shards:
            block = getattr(sh, name).cpu().numpy()
            out[(slice(sh.v0, sh.v0 + block.shape[0]), *[slice(None)] * len(inner),
                 slice(sh.c0, sh.c0 + self.local_chains))] = block
        return torch.from_numpy(self._reduce(out))

    @property
    def state(self):
        """Host copy [Ncap, C, V+1] of every shard's chain states."""
        return self._gather("state", (), (self.v1,))

    @property
    def halves(self):
        """Host copy [Ncap, 2, C, V+1, K] of every shard's window halves."""
        return self._gather("halves", (2,), (self.v1, self.kdim))

    def _slot_state(self, slot: int) -> np.ndarray:
        vi, loc = divmod(slot, self.local_slots)
        out = np.zeros((self.cpv, self.v1), dtype=np.int32)
        for sh in self._row(vi):
            out[sh.c0:sh.c0 + self.local_chains] = sh.state[loc].cpu().numpy()
        return self._reduce(out)

    # ---- placement -------------------------------------------------------
    def _place(self, stack: dict, state: np.ndarray) -> None:
        old = self.state
        if old is not None:
            n = min(old.shape[0], self.slot_cap)
            state[:n] = old[:n].numpy()
        self._scatter(torch.as_tensor(state), None)
        nl = self.local_slots
        self.kstack = []
        for vi in range(self.mesh.shape[VARIANT_AXIS]):
            devs = list(dict.fromkeys(sh.device for sh in self._row(vi)))
            self.kstack.append(  # the rows of other processes stay None
                SweepStack({k: v[vi * nl:(vi + 1) * nl] for k, v in stack.items()},
                           self.route, devs) if devs else None)

    def _scatter(self, state, halves) -> None:
        """Rebuild this process's shards from whole tensors (any device);
        ``halves`` None starts the window halves at zero."""
        nl, cl = self.local_slots, self.local_chains
        self.shards = []
        self._placed = self.slot_cap
        for vi, row in enumerate(self.mesh.devices):
            for ci, dev in enumerate(row):
                if not self.mesh.owns(vi, ci):
                    continue
                rows, cols = slice(vi * nl, (vi + 1) * nl), slice(ci * cl, (ci + 1) * cl)
                hv = (torch.zeros((nl, 2, cl, self.v1, self.kdim), dtype=torch.int32, device=dev)
                      if halves is None else halves[rows, :, cols].to(dev).contiguous())
                self.shards.append(Shard(vi, ci, dev, vi * nl, ci * cl,
                                         state[rows, cols].to(dev).contiguous(), hv))

    def _write_slots(self, slots, stack, state: np.ndarray) -> None:
        nl, cl = self.local_slots, self.local_chains
        for vi in range(self.mesh.shape[VARIANT_AXIS]):
            sel = [i for i, s in enumerate(slots) if s // nl == vi]
            if not sel:
                continue
            loc = [slots[i] - vi * nl for i in sel]
            if stack is not None and self.kstack[vi] is not None:
                self.kstack[vi].write(loc, {k: v[sel] for k, v in stack.items()})
            for sh in self._row(vi):
                sh.state[loc] = torch.as_tensor(
                    np.ascontiguousarray(state[sel][:, sh.c0:sh.c0 + cl]), device=sh.device)

    def restore_device_state(self, state, halves):
        """Checkpointed tensors [Ncap, ...] (any device or numpy) go back
        into shards on the mesh."""
        state = torch.as_tensor(state, dtype=torch.int32)
        halves = torch.as_tensor(halves, dtype=torch.int32)
        if state.shape[0] != self.slot_cap or halves.shape[0] != self.slot_cap:
            raise ValueError(f"tensors of {state.shape[0]} slots for a group of "
                             f"{self.slot_cap}")
        self._scatter(state, halves)

    # ---- estimation ------------------------------------------------------
    def _rb_index_rows(self, states, slots, rest, strides) -> np.ndarray:
        if states is not None:  # another group's chains
            return super()._rb_index_rows(states, slots, rest, strides)
        nl, cl = self.local_slots, self.local_chains
        out = np.zeros((len(slots), self.cpv), dtype=np.int64)
        for vi in range(self.mesh.shape[VARIANT_AXIS]):
            sel = np.nonzero(slots // nl == vi)[0]
            if not sel.size:
                continue
            for sh in self._row(vi):
                out[sel, sh.c0:sh.c0 + cl] = _rb_indices(
                    sh.state,
                    torch.as_tensor(slots[sel] - sh.v0, device=sh.device),
                    torch.as_tensor(rest[sel], device=sh.device),
                    torch.as_tensor(strides[sel], device=sh.device),
                ).cpu().numpy()
        return self._reduce(out)

    def moments(self, merged: np.ndarray, measure: str = "hellinger") -> tuple:
        """The PSRF moments ``(sum_w [V], sum_b [V], m)`` of all active
        chains: each shard's own (``metrics.psrf.convergence_moments``, on
        its device), summed on the host in grid order, where the reference
        reduces with ``psum`` over both axes (``mesh.py:201-203``)."""
        v = self.caps.num_vars
        vdim, cdim = self.mesh.shape[VARIANT_AXIS], self.mesh.shape[CHAIN_AXIS]
        per = np.zeros((vdim * cdim, 2 * v + 1), dtype=np.float32)  # by grid position
        for sh, _v0, _c0, na, _ in self.launches():
            dev = sh.device
            h = sh.halves[:na, :, :, :v, :]  # [na, 2, c_local, V, K]
            m_chains = na * self.local_chains
            mo = convergence_moments(
                h[:, 0].reshape(m_chains, v, self.kdim),
                h[:, 1].reshape(m_chains, v, self.kdim),
                torch.as_tensor(merged, dtype=torch.float32, device=dev),
                torch.as_tensor(self.base.cards, dtype=torch.int32, device=dev),
                torch.ones(m_chains, dtype=torch.bool, device=dev),
                measure=measure,
            )
            per[sh.vi * cdim + sh.ci] = torch.cat([mo[0], mo[1], mo[2][None]]).cpu().numpy()
        per = torch.from_numpy(self._reduce(per))
        nact = max(1, self.num_variants)
        live = per[[vi * cdim + ci for vi in range(vdim) for ci in range(cdim)
                    if vi * self.local_slots < nact]]
        return tuple(live[:, cols].contiguous().sum(dim=0)
                     for cols in (slice(0, v), slice(v, 2 * v), 2 * v))

    def convergence(self, measure: str = "hellinger",
                    merged: Optional[np.ndarray] = None) -> np.ndarray:
        if merged is None:
            merged = self.merged_marginals()
        converged = (self.base.fixed >= 0) | self.collapsed_any()
        vals = psrf_from_moments(*self.moments(merged, measure), float(self.cw),
                                 torch.as_tensor(converged))
        return vals.numpy().astype(np.float64)
