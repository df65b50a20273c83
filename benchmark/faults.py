"""Faults planted under the timed path, to show that ``correct`` sees them.

Each fault of :data:`FAULTS` wraps the port's sweep
(``grample_tpu_torch.ops.sweep.window``, which every group's window goes
through on either route) and breaks one thing the cells' answers rest
on:

* ``stuck``: every site's draw keeps its value; the state comes back
  unchanged, and the counts are those of that state every sweep;
* ``altered``: the counts turned over (outcome k counted as K - 1 - k)
  where the window produces them;
* ``half``: the counts of half the chains left out, so the estimate is
  the mean over the rest while the run still claims every site update.

The fault of :data:`MESH_FAULTS` wraps the device mesh's count merge
(``grample_tpu_torch.parallel.mesh.ShardedChainGroup._window_delta``),
which only a cell whose mix shards the chains runs:

* ``shard``: the last active shard's window counts left out of the host
  sum, as if one card's exchange were lost, while the run still claims
  its site updates.

    python3 -m benchmark.faults --fault half --workload <cell> --seed <n> --seconds <s>

runs one cell as ``benchmark.run`` does, with the fault planted, and
prints its result line and the numbers compared.  The benchmark's own
runs never plant one.
"""

from __future__ import annotations

import sys

import torch


def stuck(orig):
    """The sweep with every site's draw keeping its value (the plain
    versions write the state they are given in place, so the real window
    runs on a copy, for the counts' shape)."""

    def window(kst, state_p, seed, num_sweeps, half_point, count, cb, route="kernel"):
        _, counts = orig(kst, state_p.clone(), seed, num_sweeps, half_point, count, cb, route)
        if counts is not None and count:
            n, _, k, rows, _ = counts.shape
            oh = torch.nn.functional.one_hot(state_p[:, :rows, :].long(), k).permute(0, 3, 1, 2)
            counts = torch.stack([oh * half_point, oh * (num_sweeps - half_point)],
                                 dim=1).to(counts.dtype)
        return state_p, counts

    return window


def altered(orig):
    """The sweep with its counts turned over.  A var collapsed by an adapt
    step takes its estimate from the RB mixture of chain states, not from
    counts, so every slot is turned: whichever vars stay plain show it."""

    def window(kst, state_p, seed, num_sweeps, half_point, count, cb, route="kernel"):
        st, counts = orig(kst, state_p, seed, num_sweeps, half_point, count, cb, route)
        if counts is not None and count:
            counts = counts.flip(2)
        return st, counts

    return window


def half(orig):
    """The sweep with the counts of the second half of its chains (the
    last axis of ``[N, 2, K, slots, C]``) left out."""

    def window(kst, state_p, seed, num_sweeps, half_point, count, cb, route="kernel"):
        st, counts = orig(kst, state_p, seed, num_sweeps, half_point, count, cb, route)
        if counts is not None and count:
            counts = counts.clone()
            counts[..., counts.shape[-1] // 2:] = 0
        return st, counts

    return window


def shard(orig):
    """The mesh's window deltas, one a shard, with the last left out."""

    def window_delta(self):
        return orig(self)[:-1]

    return window_delta


#: faults of the sweep, which every cell can have
FAULTS = {"stuck": stuck, "altered": altered, "half": half}
#: faults of the device mesh's count merge, which a sharded cell can have
MESH_FAULTS = {"shard": shard}


def target(name: str) -> tuple:
    """(object, attribute name, wrapper) of fault ``name``."""
    if name in MESH_FAULTS:
        from grample_tpu_torch.parallel.mesh import ShardedChainGroup

        return ShardedChainGroup, "_window_delta", MESH_FAULTS[name]
    from grample_tpu_torch.ops import sweep

    return sweep, "window", FAULTS[name]


def plant(name: str):
    """Wrap what fault ``name`` breaks in it; returns the original."""
    owner, attr, wrap = target(name)
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    return orig


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--fault")
    name = argv[i + 1]
    del argv[i:i + 2]
    plant(name)
    from benchmark import run

    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
