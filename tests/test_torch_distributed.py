"""Chains sharded over the ranks of a ``torch.distributed`` world
(``parallel.distributed``): two gloo ranks on the CPU, spawned with
``torch.multiprocessing``, against one process.

A run over ranks draws what one process draws (``shard_seed``), so the
group is held bit for bit against a ``ChainGroup``; the engine's ranks
must take the same decisions, which rank 0's clock makes; a checkpoint
written by the ranks resumes in one process.  The ranks join through a
file in the test's own directory (or, for the CLI, torchrun's variables
with a port the system picked), never a fixed port, and every join has a
deadline, so that a hang fails the test.  The spawned ranks import this
module, so it imports JAX only inside the test that needs the JAX
package's sampler.
"""

import datetime
import json
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import grample_tpu_torch.pgm.discrete as port_pgm
from grample_tpu_torch import cli
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.parallel import ShardedChainGroup, chain_mesh, distributed
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.sampler.checkpoint import load_checkpoint, save_checkpoint
from grample_tpu_torch.sampler.collapse import collapse_var
from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.uai.writer import write_mar, write_model

from tests import torch_models

WORLD = 2
#: seconds a test waits for its ranks, and a rank for a collective
JOIN_SECS = 120
SHAPES = {"1x2": (1, 2), "2x1": (2, 1)}


def _run_ranks(fn, *args):
    """``fn(rank, *args)`` in ``WORLD`` spawned processes; a rank's
    exception fails the test with its traceback, and ranks still running
    after ``JOIN_SECS`` are killed and fail it too."""
    ctx = mp.start_processes(fn, args=args, nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_SECS
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"ranks still running after {JOIN_SECS} s")


def _join(rank, tmp):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'pg')}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=JOIN_SECS))


def _world_mesh(shape):
    devices, ranks = distributed.world_devices(["cpu"])
    return chain_mesh(variant_ways=SHAPES[shape][0], devices=devices, ranks=ranks)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_grid(tmp_path):
    """The 4x4 grid (``grid(side=4)``) and its exact ``.MAR``."""
    m = torch_models.grid(port_pgm, 4, seed=3)
    path = str(tmp_path / "grid4.uai")
    with open(path, "w") as fh:
        fh.write(write_model(m))
    truth = exact_marginals(m)
    with open(path + ".MAR", "w") as fh:
        fh.write(write_mar([truth[i, :2] for i in range(m.num_vars)]))
    return path, truth


# ---- without a process group ----------------------------------------------------

def test_helpers_are_the_identity_in_one_process():
    assert not dist.is_initialized()
    assert (distributed.rank(), distributed.world(), distributed.is_main()) == (0, 1, True)
    arr = np.arange(6, dtype=np.int64).reshape(2, 3)
    assert distributed.allreduce_sum(arr) is arr
    np.testing.assert_array_equal(distributed.from_main([1.5, 2.0]), [1.5, 2.0])
    devices, ranks = distributed.world_devices(["cpu", "cpu"])
    assert devices == [torch.device("cpu")] * 2 and ranks == [0, 0]
    mesh = chain_mesh(variant_ways=2, devices=devices, ranks=ranks)
    assert mesh.ranks == ((0,), (0,)) and mesh.owns(1, 0)
    assert chain_mesh(devices=devices).ranks is None
    with pytest.raises(ValueError, match="world has 2"):
        chain_mesh(n_devices=4, devices=devices, ranks=ranks)


def test_engine_needs_the_process_group(tmp_path):
    path, _ = _write_grid(tmp_path)
    engine = Engine(EngineConfig(model_path=path, device="cpu", mesh="1x2", distributed=True))
    with pytest.raises(RuntimeError, match="init_distributed"):
        engine.run()


# ---- the group, bit for bit ------------------------------------------------------

def _drive(g, m):
    """Deferred and immediate windows, a tempered burn, two restacks (one
    with states transplanted from a plain slot, one redrawn from the
    merged estimate), RB snapshots; returns the PSRF of two measures."""
    g.add_variants([m, m])
    g.warmup()
    g.burn_annealed(6, stages=2)
    g.advance(defer=True)
    g.advance(7, defer=True)
    g.flush()
    g.add_variants([collapse_var(m, 0)[0]], burn_sweeps=2, init_states=g.plain_slot_states())
    for _ in range(2):
        g.advance()
        g.rb_accumulate()
    g.add_variants([collapse_var(m, v)[0] for v in (6, 9)], burn_sweeps=2,
                   warm_marginals=g.merged_marginals())
    for _ in range(2):
        g.advance(defer=True)
        g.rb_accumulate()
    return [g.convergence(measure) for measure in ("hellinger", "js")]


def _group_rank(rank, tmp, shape):
    _join(rank, tmp)
    m = torch_models.build(port_pgm, "grid4_evid")
    kw = dict(chains_per_variant=32, converge_window=12, seed=9, collapse_headroom=True)
    g = ShardedChainGroup(m, mesh=_world_mesh(shape), **kw)
    # one process: the same grid over two devices, and no mesh at all
    v = ShardedChainGroup(m, mesh=chain_mesh(variant_ways=SHAPES[shape][0],
                                             devices=["cpu"] * WORLD), **kw)
    p = ChainGroup(m, device="cpu", **kw)
    p.cb = g.cb
    psrf_g, psrf_v, psrf_p = (_drive(x, m) for x in (g, v, p))
    owned = [(vi, ci) for vi in range(SHAPES[shape][0]) for ci in range(SHAPES[shape][1])
             if vi * SHAPES[shape][1] + ci == rank]
    assert [(sh.vi, sh.ci) for sh in g.shards] == owned  # each rank holds its own shard
    assert g.slot_cap == p.slot_cap == 8 and g._step == p._step
    assert torch.equal(g.state, p.state) and torch.equal(g.halves, p.halves)
    np.testing.assert_array_equal(g.totals, p.totals)
    assert (g.total_samples, g.total_sweeps) == (p.total_samples, p.total_sweeps)
    np.testing.assert_array_equal(g.merged_marginals(), p.merged_marginals())
    assert set(g._rb_sum) == set(p._rb_sum) == {(2, 0), (3, 6), (4, 9)}
    for name in ("_rb_sum", "_rbp_sum"):
        for key, val in getattr(p, name).items():
            np.testing.assert_array_equal(getattr(g, name)[key], val)
    assert g._rb_n == p._rb_n and g._rbp_w == p._rbp_w and g._rbp_snaps == p._rbp_snaps
    # the shards' moments are summed in grid order on every rank: the
    # PSRF equals a one-process group's on a mesh of the same shape bit
    # for bit; the unsharded group sums its float32 distances in another
    # order
    for a, b, c in zip(psrf_g, psrf_v, psrf_p):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=1e-5)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_group_over_ranks_equals_one_process(tmp_path, shape):
    """A ``ShardedChainGroup`` over two ranks (``1x2``, ``2x1``) equals,
    on every rank, a ``ChainGroup`` with the same ``cb`` and slot
    capacity: state, halves, totals, merged marginals and RB mixtures
    bit for bit."""
    _run_ranks(_group_rank, str(tmp_path), shape)


# ---- the engine -----------------------------------------------------------------

def _cli_rank(rank, port, argv, tmp):
    torch.set_num_threads(2)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    out = [f"--mar-out={os.path.join(tmp, f'rank{rank}.MAR')}",
           f"--trace={os.path.join(tmp, f'rank{rank}.trace')}"]
    assert cli.main(argv + out + ["--distributed", "--mesh", "1x2"]) == 0


def _trace_marginals(path):
    records = [json.loads(ln) for ln in open(path) if ln.startswith('{"ID"')]
    return {r["ID"]: r["Marginal"] for r in records}


def test_cli_simple_over_ranks_equals_one_process(tmp_path):
    """``sample -s simple --distributed --mesh 1x2`` from torchrun's
    variables, stopped by ``-i`` after its first window: rank 0's
    marginals equal a one-process unsharded run's exactly (2048 chains a
    variant keep the hash width of the half on each rank), and rank 0
    alone wrote the trace and the MAR."""
    path, _ = _write_grid(tmp_path)
    argv = ["sample", "-m", path, "-o", "-s", "simple", "--device", "cpu", "--vchains", "2048",
            "-b", str(16 * 8), "-w", str(16 * 8), "-i", "1", "-e", "11"]
    _run_ranks(_cli_rank, _free_port(), argv, str(tmp_path))
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("rank")) == \
        ["rank0.MAR", "rank0.trace"]
    one = [f"--mar-out={tmp_path / 'one.MAR'}", f"--trace={tmp_path / 'one.trace'}"]
    assert cli.main(argv + one) == 0
    assert open(tmp_path / "rank0.MAR").read() == open(tmp_path / "one.MAR").read()
    assert _trace_marginals(tmp_path / "rank0.trace") == _trace_marginals(tmp_path / "one.trace")


def _adaptive_cfg(path, **kw):
    return EngineConfig(model_path=path, device="cpu", use_solution=True, sampler="adaptive",
                        burnin=16 * 30, converge_window=16 * 16, chains=2,
                        chains_per_variant=256, chain_adds=2, max_secs=4.0, seed=5,
                        status_secs=1e-6, **kw)


def _adaptive_rank(rank, tmp, path):
    _join(rank, tmp)
    lines = []
    res = Engine(_adaptive_cfg(path, mesh="2x1", distributed=True), log=lines.append).run()
    np.savez(os.path.join(tmp, f"adaptive{rank}.npz"), marginals=res.marginals,
             collapsed=np.array(res.collapsed), samples=res.samples, variants=res.variants,
             adapts=np.array([ln for ln in lines if ln.startswith("ADAPT: ")]),
             runtime=res.runtime)


def test_adaptive_engine_over_ranks(tmp_path):
    """``-s adaptive -a 2`` for 4 s on a ``2x1`` world mesh: both ranks
    take the same adapt steps and end with the same variants, collapsed
    vars, samples, runtime and marginals; the marginals are within 5
    sigma of exact and of the JAX package's adaptive sampler on the same
    model, run in one process."""
    path, truth = _write_grid(tmp_path)
    _run_ranks(_adaptive_rank, str(tmp_path), path)
    ranks = [np.load(tmp_path / f"adaptive{r}.npz") for r in range(WORLD)]
    for key in ("marginals", "collapsed", "samples", "variants", "runtime"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
    # an adapt step's line ends with its own host seconds
    assert [ln.split(" in ")[0] for ln in ranks[0]["adapts"]] == \
        [ln.split(" in ")[0] for ln in ranks[1]["adapts"]]
    assert len(ranks[0]["adapts"]) >= 1 and ranks[0]["collapsed"].size >= 2
    # every free var is counted by >= 512 chains for >= 16 sweeps a window
    # over >= 10 windows (a 4x4 grid mixes within ~8 sweeps), and a
    # collapsed var averages its exact conditional over >= 384 chains a
    # snapshot: n_eff >= 1700 (tests/test_torch_adaptive.py::
    # test_adaptive_engine_vs_exact), 5 sigma(H) = 5 / sqrt(8 n_eff)
    bound = 5.0 / np.sqrt(8 * 1700)
    cards = np.full(16, 2)
    port = ranks[0]["marginals"]
    assert hellinger(port, truth, cards).max() < bound

    from grample_tpu.sampler.engine import Engine as RefEngine
    from grample_tpu.sampler.engine import EngineConfig as RefEngineConfig

    ref_cfg = RefEngineConfig(**{k: getattr(_adaptive_cfg(path), k) for k in (
        "model_path", "use_solution", "sampler", "burnin", "converge_window", "chains",
        "chains_per_variant", "chain_adds", "max_secs", "seed", "status_secs")})
    ref = RefEngine(ref_cfg, log=lambda _s: None).run()
    assert hellinger(ref.marginals, truth, cards).max() < bound
    assert hellinger(port, ref.marginals, cards).max() < np.sqrt(2) * bound


# ---- checkpoints ----------------------------------------------------------------

def _windows(g, m):
    g.add_variants([m, m, collapse_var(m, 4)[0]], burn_sweeps=2)
    g.burn(6)
    for _ in range(2):
        g.advance()
        g.rb_accumulate()


def _save_rank(rank, tmp):
    _join(rank, tmp)
    m = torch_models.build(port_pgm, "grid3")
    g = ShardedChainGroup(m, 32, 12, mesh=_world_mesh("2x1"), seed=9, collapse_headroom=True)
    _windows(g, m)
    save_checkpoint(os.path.join(tmp, "ck.npz"), g)  # every rank: the gathers are collectives
    dist.barrier()
    assert os.path.exists(os.path.join(tmp, "ck.npz"))


def test_checkpoint_from_ranks_resumes_in_one_process(tmp_path):
    """Saved by two ranks on ``2x1``, loaded by one process into an
    unsharded group: the continuation equals the group that was never
    saved, bit for bit (``tests/test_torch_checkpoint.py::
    test_kill_and_resume_bit_exact``)."""
    _run_ranks(_save_rank, str(tmp_path))
    m = torch_models.build(port_pgm, "grid3")
    a = ChainGroup(m, 32, 12, "cpu", seed=9, collapse_headroom=True)
    _windows(a, m)
    b, meta = load_checkpoint(str(tmp_path / "ck.npz"), m)
    assert type(b) is ChainGroup and meta["cb"] == a.cb == b.cb and b.slot_cap == a.slot_cap
    for x in (a, b):
        x.advance()
        x.rb_accumulate()
    assert torch.equal(a.state, b.state) and torch.equal(a.halves, b.halves)
    np.testing.assert_array_equal(a.totals, b.totals)
    assert (a._step, a.total_samples, a.total_sweeps) == (b._step, b.total_samples, b.total_sweeps)
    assert a._rb_count == b._rb_count and a._rb_n == b._rb_n and a._rbp_w == b._rbp_w
    for key, val in a._rb_sum.items():
        np.testing.assert_array_equal(b._rb_sum[key], val)
    np.testing.assert_array_equal(a.merged_marginals(), b.merged_marginals())
