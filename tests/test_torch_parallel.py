"""Chains sharded over a device mesh in the port (``parallel.mesh``), on
virtual meshes of ``cpu`` devices: mirrors of ``tests/test_parallel.py``,
sharded groups held bit for bit against unsharded ones, the PSRF moments
against the reference's collective version, checkpoints that cross meshes
and packages, and engine runs under ``mesh``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import grample_tpu.parallel.mesh as ref_mesh
import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.sampler.checkpoint as ref_checkpoint
import grample_tpu.sampler.collapse as ref_collapse
import grample_tpu_torch.pgm.discrete as port_pgm
from grample_tpu.sampler.chains import ChainGroup as RefChainGroup
from grample_tpu_torch import cli
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.parallel import (
    CHAIN_AXIS,
    VARIANT_AXIS,
    ShardedChainGroup,
    chain_mesh,
    shard_seed,
)
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.sampler.chains import ChainGroup, window_seed
from grample_tpu_torch.sampler.checkpoint import load_checkpoint, save_checkpoint
from grample_tpu_torch.sampler.collapse import collapse_var
from grample_tpu_torch.sampler.engine import Engine, EngineConfig

from tests import torch_models
from tests.test_torch_adaptive import _random_window
from tests.test_torch_checkpoint import _assert_same_snapshot
from tests.test_torch_engine import _write_net

MESHES = {"1x1": (1, 1), "1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}


def cpu_mesh(shape):
    vdim, cdim = MESHES[shape] if isinstance(shape, str) else shape
    return chain_mesh(variant_ways=vdim, devices=["cpu"] * (vdim * cdim))


def _sharded(m, shape, cpv, cw, seed, **kw):
    return ShardedChainGroup(m, chains_per_variant=cpv, converge_window=cw, seed=seed,
                             mesh=cpu_mesh(shape), **kw)


def _pair(m, shape, cpv=32, cw=12, seed=9, **kw):
    """A sharded group on ``shape`` and an unsharded one with its ``cb``."""
    g = _sharded(m, shape, cpv, cw, seed, **kw)
    p = ChainGroup(m, chains_per_variant=cpv, converge_window=cw, device="cpu", seed=seed, **kw)
    p.cb = g.cb
    return g, p


def _assert_equal(g, p):
    """State, halves and totals bit for bit; PSRF to float32 rounding."""
    assert g.slot_cap == p.slot_cap and g._step == p._step
    assert torch.equal(g.state, p.state)
    assert torch.equal(g.halves, p.halves)
    np.testing.assert_array_equal(g.totals, p.totals)
    assert (g.total_samples, g.total_sweeps) == (p.total_samples, p.total_sweeps)
    np.testing.assert_array_equal(g.merged_marginals(), p.merged_marginals())
    for measure in ("hellinger", "js"):
        np.testing.assert_allclose(g.convergence(measure), p.convergence(measure), rtol=1e-5)


# ---- the mesh ---------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_rule_matches_reference(monkeypatch, n):
    """The default split of ``n`` devices between the axes (and its
    refusal) is the reference's."""
    real = jax.devices()[0]
    monkeypatch.setattr(ref_mesh.jax, "devices", lambda: [real] * n)
    try:
        want = dict(ref_mesh.chain_mesh().shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            chain_mesh(devices=["cpu"] * n)
        return
    mesh = chain_mesh(devices=["cpu"] * n)
    assert mesh.shape == want and mesh.size == n


@pytest.mark.parametrize("devices,n_devices,ranks,rank,want", [
    (["cpu"] * 4, None, None, 0, ["cpu"]),  # a virtual mesh: one device
    ([f"cuda:{i}" for i in range(4)], None, None, 0, [f"cuda:{i}" for i in range(4)]),
    (["cuda:0"] * 4, None, [0, 1, 2, 3], 2, ["cuda:0"]),  # a rank per card, each its cuda:0
    # two ranks that each see both cards, and a mesh of two: rank 0's alone
    (["cuda:0", "cuda:1"] * 2, 2, [0, 0, 1, 1], 1, []),
], ids=["virtual", "cards", "rank-per-card", "rank-owns-none"])
def test_mesh_local_devices(monkeypatch, devices, n_devices, ranks, rank, want):
    """This process's distinct devices, as the engine's ``device mesh:``
    line names them (no CUDA call: a mesh only names its devices)."""
    import grample_tpu_torch.parallel.distributed as port_distributed

    monkeypatch.setattr(port_distributed, "rank", lambda: rank)
    mesh = chain_mesh(n_devices=n_devices, devices=devices, ranks=ranks)
    assert mesh.local_devices() == [torch.device(d) for d in want]


def test_mesh_shapes():
    """``tests/test_parallel.py::test_mesh_shapes``."""
    mesh = chain_mesh(devices=["cpu"] * 2)
    assert set(mesh.shape) == {VARIANT_AXIS, CHAIN_AXIS} == {"variants", "chains"}
    assert mesh.size == 2 and mesh.devices == ((torch.device("cpu"),) * 2,)
    with pytest.raises(ValueError, match="not divisible"):
        chain_mesh(variant_ways=3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="has 2"):
        chain_mesh(n_devices=4, devices=["cpu"] * 2)
    assert chain_mesh(n_devices=1, devices=["cpu"] * 2).size == 1
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            chain_mesh()


@pytest.mark.parametrize("seed,v0,block0", [(5, 0, 0), (2**31 - 1, 3, 7), (-2**31, 127, 127),
                                            (-1, 1, 0)])
def test_shard_seed_reproduces_the_cell(seed, v0, block0):
    """A shard's local cell (variant i, block b) under ``shard_seed`` is
    the unsharded window's cell (v0 + i, block0 + b), mod 2^32."""
    from grample_tpu_torch.ops.gibbs_torch import window_cell

    s = shard_seed(seed, v0, block0)
    assert -2**31 <= s < 2**31
    for i, b in ((0, 0), (2, 5)):
        assert window_cell(s, i, b) == window_cell(seed, v0 + i, block0 + b)


# ---- mirrors of tests/test_parallel.py --------------------------------------

@pytest.mark.parametrize("shape", sorted(MESHES))
def test_sharded_advance_vs_exact(shape):
    m = torch_models.chain_model(port_pgm, 12345)
    truth = exact_marginals(m)
    cdim = MESHES[shape][1]
    g = _sharded(m, shape, 64 * cdim, 100, 1)
    g.add_variant(m)
    g.add_variant(m)
    g.burn(50)
    for _ in range(4):
        g.advance()
    assert g.total_samples == g.num_chains * 4 * 100 * m.num_vars
    assert hellinger(g.merged_marginals(), truth, m.cards).max() < 0.03


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_sharded_matches_unsharded_semantics(shape):
    """Same API surface, same count bookkeeping, collapse override intact."""
    m = torch_models.chain_model(port_pgm, 12345)
    g = _sharded(m, shape, 8 * MESHES[shape][1], 50, 2)
    g.add_variant(m)
    variant, exact = collapse_var(m, 2)
    g.add_variant(variant)
    g.advance()
    merged = g.merged_marginals()
    np.testing.assert_allclose(merged[2] / merged[2].sum(), exact, rtol=1e-7)
    assert bool(g.collapsed_any()[2])
    assert g.totals[1, 2].sum() == 0  # collapsed var never sampled


@pytest.mark.parametrize("shape", sorted(MESHES))
def test_sharded_convergence_scores(shape):
    m = torch_models.chain_model(port_pgm, 12345)
    m.apply_evidence({3: 1})
    g, g2 = _pair(m, shape, cpv=32 * MESHES[shape][1], cw=100, seed=3)
    g.add_variant(m)
    g.add_variant(m)
    g.burn(100)
    g.advance()
    scores = g.convergence()
    assert scores.shape == (m.num_vars,)
    assert scores[3] == 1.0  # evidence-fixed scores exactly 1.0
    free = scores[:3]
    assert np.all(free > 0.5) and np.all(free < 3.0)
    # the sharded PSRF agrees with the unsharded formula on identical
    # half-window counts
    g2.add_variants([m, m])
    g2.restore_device_state(g.state, g.halves)
    g2.totals = g.totals.copy()
    np.testing.assert_allclose(scores, g2.convergence(), rtol=1e-4, atol=1e-5)


def test_sharded_cpv_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        _sharded(torch_models.chain_model(port_pgm, 0), "1x2", 3, 10, 0)


# ---- sharded equals unsharded, bit for bit ----------------------------------

def _drive_plain(g, m):
    g.add_variants([m, m])
    g.warmup()
    g.burn(6)
    g.advance()
    g.advance(defer=True)
    g.advance(7, defer=True)
    g.flush()


def _drive_collapse(g, m):
    g.add_variants([m, m])
    g.add_variant(collapse_var(m, 4)[0], burn_sweeps=2)
    g.burn(5)
    for _ in range(2):
        g.advance()
        g.rb_accumulate()


def _drive_restack(g, m):
    """Five variants from a capacity of 2: two restacks on the way, one of
    them with new states transplanted from a plain slot."""
    g.add_variants([m, m])
    g.advance()
    g.add_variants([collapse_var(m, 0)[0]], burn_sweeps=2,
                   init_states=g.plain_slot_states())
    g.advance()
    warm = g.merged_marginals()
    g.add_variants([collapse_var(m, v)[0] for v in (6, 9)], burn_sweeps=2, warm_marginals=warm)
    assert g.slot_cap == 8
    g.advance()


def _drive_annealed(g, m):
    g.reserve(4)
    g.add_variants([m, m, m])
    g.burn_annealed(23, stages=4)
    g.advance()


DRIVES = {"plain": (_drive_plain, {}), "collapse": (_drive_collapse, {"collapse_headroom": True}),
          "restack": (_drive_restack, {"collapse_headroom": True}),
          "annealed": (_drive_annealed, {})}


@pytest.mark.parametrize("shape", ["1x2", "2x1", "2x2"])
@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_sharded_equals_unsharded(shape, drive):
    """The same calls on a sharded group and on a ``ChainGroup`` with the
    same ``cb`` leave the same state, halves and totals, exactly."""
    run, kw = DRIVES[drive]
    m = torch_models.build(port_pgm, "grid4_evid")
    g, p = _pair(m, shape, **kw)
    assert g.cb == 32 // MESHES[shape][1]
    for x in (g, p):
        run(x, m)
    _assert_equal(g, p)
    assert g._rb_sum.keys() == p._rb_sum.keys()
    for key in p._rb_sum:
        np.testing.assert_array_equal(g._rb_sum[key], p._rb_sum[key])


def test_sharded_equals_unsharded_card3():
    m = torch_models.build(port_pgm, "grid3_card3_evid")
    g, p = _pair(m, "2x2", cpv=16)
    for x in (g, p):
        _drive_plain(x, m)
    _assert_equal(g, p)


def test_rb_accumulate_equal_on_both():
    """Own-chain and plain-donor RB snapshots of a sharded group equal the
    unsharded group's; a slot's donor states come back whole."""
    m = torch_models.build(port_pgm, "grid4_evid")
    g, p = _pair(m, "2x2", collapse_headroom=True)
    for x in (g, p):
        x.reserve(4)
        x.add_variants([m, collapse_var(m, 4)[0], m, collapse_var(m, 9)[0]])
        x.burn(4)
        for _ in range(3):
            x.advance()
            x.rb_accumulate()
    assert set(g._rb_sum) == {(1, 4), (3, 9)} and set(g._rbp_sum) == {4, 9}
    for name in ("_rb_sum", "_rbp_sum"):
        for key, val in getattr(p, name).items():
            np.testing.assert_array_equal(getattr(g, name)[key], val)
    assert g._rb_n == p._rb_n and g._rbp_w == p._rbp_w and g._rbp_snaps == p._rbp_snaps
    np.testing.assert_array_equal(g.merged_marginals(), p.merged_marginals())
    np.testing.assert_array_equal(g.plain_slot_states(), p.plain_slot_states())
    np.testing.assert_array_equal(g._slot_state(2), p.state[2].numpy())
    # donors from another group's chains take the unsharded path
    g.rb_accumulate_external(p.state, p.cpv, n_slots=1)
    p.rb_accumulate_external(p.state, p.cpv, n_slots=1)
    for key, val in p._rbp_sum.items():
        np.testing.assert_array_equal(g._rbp_sum[key], val)


def test_idle_rows_launch_nothing():
    """Two variants in a capacity of 4 on a 2x2 mesh sit in row 0: row 1
    has no active slot and is not advanced."""
    m = torch_models.build(port_pgm, "grid3")
    g = _sharded(m, "2x2", 8, 6, 1)
    g.reserve(4)
    g.add_variants([m, m])
    assert [(sh.vi, sh.ci, na) for sh, _, _, na, _ in g.launches()] == [(0, 0, 2), (0, 1, 2)]
    before = [sh.state.clone() for sh in g.shards]
    g.advance()
    assert [torch.equal(sh.state, b) for sh, b in zip(g.shards, before)] == \
        [False, False, True, True]
    assert all(int(sh.halves.sum()) == 0 for sh in g.shards[2:])
    g.add_variant(m)
    assert [na for _, _, _, na, _ in g.launches()] == [2, 2, 1, 1]


def test_state_is_read_only():
    """``state`` and ``halves`` are gathered copies: an assignment is a
    bug in a sharded group and raises."""
    m = torch_models.build(port_pgm, "grid3")
    g = _sharded(m, "1x2", 8, 6, 1)
    assert g.state is None and g.halves is None
    g.add_variants([m, m])
    assert g.state.shape == (2, 8, 10) and g.halves.shape == (2, 2, 8, 10, 2)
    with pytest.raises(AttributeError):
        g.state = g.state
    with pytest.raises(ValueError, match="slots"):
        g.restore_device_state(g.state[:1], g.halves[:1])


def test_rows_keep_their_own_capacity():
    """Each mesh row pads its compact lists for its own variants; the
    chain shards of a row share one copy per device."""
    m = torch_models.build(port_pgm, "star10")  # collapsed centre: 256-row tables
    g = _sharded(m, "2x2", 8, 6, 1, collapse_headroom=True)
    g.reserve(4)
    g.add_variants([m, m, m, collapse_var(m, 0)[0]])
    assert len(g.kstack) == 2 and all(list(row.tensors) == [torch.device("cpu")]
                                      for row in g.kstack)
    widths = [row.tensors[torch.device("cpu")]["c_tables"].shape[1] for row in g.kstack]
    assert widths[1] > widths[0]
    p = ChainGroup(m, 8, 6, "cpu", seed=1, collapse_headroom=True)
    p.cb = g.cb
    p.reserve(4)
    p.add_variants(list(g.variants))
    for x in (g, p):
        x.advance()
    _assert_equal(g, p)


# ---- PSRF moments against the reference's collective version -----------------

@pytest.mark.parametrize("measure", ["hellinger", "js", "maxabs", "meanabs"])
def test_moments_match_reference(measure):
    """The summed shard moments equal ``sharded_convergence_moments`` on
    carried-over halves (rtol 1e-4, as ``tests/test_parallel.py:101``)."""
    m = torch_models.build(port_pgm, "grid4_evid")
    g = _sharded(m, "2x2", 16, 20, 3)
    g.reserve(4)
    g.add_variants([m, m, m])
    g.burn(5)
    g.advance()
    merged = g.merged_marginals()
    sum_w, sum_b, chains = g.moments(merged, measure)
    v = m.num_vars
    mpad = np.zeros((g.v1, g.kdim), dtype=np.float32)
    mpad[:v] = merged
    mesh = ref_mesh.chain_mesh()
    rw, rb, rm = ref_mesh.sharded_convergence_moments(
        mesh, jnp.asarray(g.halves.numpy().astype(np.float32)), jnp.asarray(mpad),
        jnp.asarray(np.append(m.cards, 1), dtype=jnp.int32),
        jnp.asarray(np.arange(4) < 3), measure=measure)
    assert float(chains) == float(rm) == 3 * 16
    np.testing.assert_allclose(sum_w.numpy(), np.asarray(rw)[:v], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sum_b.numpy(), np.asarray(rb)[:v], rtol=1e-4, atol=1e-6)
    converged = (m.fixed >= 0) | g.collapsed_any()
    want = ref_mesh.psrf_from_moments(rw[:v], rb[:v], rm, float(g.cw), jnp.asarray(converged))
    np.testing.assert_allclose(g.convergence(measure, merged), np.asarray(want), rtol=1e-4)


# ---- checkpoints cross meshes and packages ----------------------------------

def _ck_group(m, shape):
    g = (_sharded(m, shape, 32, 12, 9, collapse_headroom=True) if shape else
         ChainGroup(m, 32, 12, "cpu", seed=9, collapse_headroom=True))
    g.cb = 8  # what a 1x4 mesh of 32 chains takes
    g.add_variants([m, m])
    g.add_variant(collapse_var(m, 4)[0], burn_sweeps=2)
    g.burn(6)
    for _ in range(2):
        g.advance()
        g.rb_accumulate()
    return g


@pytest.mark.parametrize("dst", ["1x4", "2x2", "3x1", "off"])
@pytest.mark.parametrize("src", ["2x2", "off"])
def test_checkpoint_crosses_meshes(tmp_path, src, dst):
    """A snapshot written on one mesh resumes on another (or on none) and
    runs on exactly as the group that was never saved; a mesh that rounds
    the slot capacity up pads the snapshot."""
    shapes = {"1x4": (1, 4), "2x2": (2, 2), "3x1": (3, 1), "off": None}
    m = torch_models.build(port_pgm, "grid3")
    a = _ck_group(m, shapes[src])
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, a)

    def make(model, **kw):
        if shapes[dst] is None:
            return ChainGroup(model, **kw)
        return ShardedChainGroup(model, mesh=cpu_mesh(shapes[dst]), **kw)

    b, meta = load_checkpoint(path, m, make_group=make)
    assert meta["cb"] == 8 and b.cb == 8
    assert b.slot_cap == (6 if dst == "3x1" else 4)
    assert isinstance(b, ShardedChainGroup) == (dst != "off")
    n = a.slot_cap
    assert torch.equal(b.state[:n], a.state) and torch.equal(b.halves[:n], a.halves)
    for x in (a, b):
        x.advance()
        x.rb_accumulate()
        x.add_variant(collapse_var(m, 1)[0], burn_sweeps=2,
                      warm_marginals=x.merged_marginals())
        x.advance()
    assert torch.equal(b.state[:n], a.state) and torch.equal(b.halves[:n], a.halves)
    np.testing.assert_array_equal(b.totals[:n], a.totals)
    assert (a._step, a.total_samples, a.total_sweeps) == (b._step, b.total_samples,
                                                          b.total_sweeps)
    assert a._rb_n == b._rb_n and a._rbp_w == b._rbp_w
    np.testing.assert_array_equal(a.merged_marginals(), b.merged_marginals())
    np.testing.assert_allclose(a.convergence(), b.convergence(), rtol=1e-5)


def test_checkpoint_keeps_own_cb_when_it_does_not_divide(tmp_path):
    m = torch_models.build(port_pgm, "grid3")
    a = ChainGroup(m, 32, 12, "cpu", seed=9)
    a.add_variants([m, m])
    a.advance()
    assert a.cb == 32
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, a)
    b, _ = load_checkpoint(path, m, make_group=lambda model, **kw: ShardedChainGroup(
        model, mesh=cpu_mesh((1, 2)), **kw))
    assert b.cb == 16 and torch.equal(b.state, a.state)
    b.advance()


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_reference_checkpoint_loads_in_sharded_group(tmp_path, shape):
    """``tests/test_torch_checkpoint.py::test_reference_checkpoint_loads_in_port``
    into a sharded group."""
    m = torch_models.build(ref_pgm, "grid3")
    ref = RefChainGroup(m, chains_per_variant=16, converge_window=8, seed=4)
    ref.add_variant(m)
    ref.add_variant(ref_collapse.collapse_var(m, 4)[0])
    rng = np.random.default_rng(2)
    for _ in range(2):
        _random_window(ref, rng)
        ref.rb_accumulate()
    ref._step, ref.total_samples, ref.total_sweeps = 17, 12345, 99
    path = str(tmp_path / "ref.npz")
    ref_checkpoint.save_checkpoint(path, ref)
    port, meta = load_checkpoint(
        path, torch_models.build(port_pgm, "grid3"),
        make_group=lambda model, **kw: ShardedChainGroup(model, mesh=cpu_mesh(shape), **kw))
    assert isinstance(port, ShardedChainGroup) and meta["step"] == 17
    _assert_same_snapshot(port, ref)
    np.testing.assert_allclose(port.merged_marginals(), ref.merged_marginals(), rtol=1e-12)
    port.advance()
    assert port.total_samples > 12345
    # and the sharded group's own snapshot loads in the reference
    path2 = str(tmp_path / "port.npz")
    save_checkpoint(path2, port)
    back, _ = ref_checkpoint.load_checkpoint(path2, m)
    np.testing.assert_array_equal(np.asarray(back.state), port.state.numpy())
    np.testing.assert_array_equal(back.totals, port.totals)


# ---- the engine under a mesh -------------------------------------------------

def test_adaptive_engine_under_mesh_vs_exact(tmp_path):
    """``tests/test_torch_adaptive.py::test_adaptive_engine_vs_exact`` on a
    2x2 virtual mesh: the same adapt steps, the same bound."""
    path, truth = _write_net(tmp_path, "grid3")
    cfg = EngineConfig(model_path=path, device="cpu", use_solution=True, sampler="adaptive",
                       burnin=9 * 30, converge_window=9 * 25, chains=2, chains_per_variant=128,
                       chain_adds=2, max_iters=9 * 128 * 25 * 120, max_secs=600.0, seed=5,
                       status_secs=1e-6, mesh="2x2", split_group="on")
    lines = []
    res = Engine(cfg, log=lines.append, devices=["cpu"] * 4).run()
    assert "device mesh: {'variants': 2, 'chains': 2} over 4 devices; this process: cpu" in lines
    assert not any("split group" in ln for ln in lines)  # ignored under a mesh
    adapts = [ln for ln in lines if ln.startswith("ADAPT: ")]
    assert len(adapts) == 5 and res.collapsed == list(range(9)) and res.variants == 11
    h = hellinger(res.marginals, truth, np.full(9, 2))
    assert h.max() < 5.0 / np.sqrt(8 * 1700), (h, adapts)
    assert (res.convergence["hellinger"] == 1.0).all()


def test_engine_resume_onto_another_mesh(tmp_path):
    """A run checkpointed unsharded resumes under ``mesh`` (the factory
    honours it, reference ``engine.py:202-203``) and continues."""
    path, _ = _write_net(tmp_path, "grid3")
    ck = str(tmp_path / "ck.npz")
    base = dict(model_path=path, device="cpu", sampler="adaptive", burnin=90,
                converge_window=90, chains=2, chains_per_variant=32, chain_adds=1, seed=3,
                status_secs=1e-6, checkpoint_path=ck, checkpoint_secs=0.0, max_secs=600.0)
    first = Engine(EngineConfig(max_iters=9 * 64 * 10 * 3, **base), log=lambda s: None).run()
    lines = []
    res = Engine(EngineConfig(max_iters=first.samples * 3, resume=True, mesh="1x2", **base),
                 log=lines.append, devices=["cpu", "cpu"]).run()
    assert any(ln.startswith("device mesh:") for ln in lines)
    assert any(ln.startswith("RESUMED") for ln in lines)
    assert res.samples > first.samples and res.variants >= first.variants


@pytest.mark.parametrize("mesh,devices,sharded", [
    ("auto", None, False),  # one CPU: unsharded, and no word of a mesh
    ("auto", ["cpu"] * 4, True),
    ("1x1", None, True),
    ("off", ["cpu"] * 4, False),
])
def test_engine_mesh_modes(tmp_path, mesh, devices, sharded):
    path, _ = _write_net(tmp_path, "grid3")
    cfg = EngineConfig(model_path=path, device="cpu", burnin=90, converge_window=90,
                       chains_per_variant=16, max_iters=1, seed=3, mesh=mesh)
    lines = []
    Engine(cfg, log=lines.append, devices=devices).run()
    assert any(ln.startswith("device mesh:") for ln in lines) == sharded


def test_mesh_config_errors(tmp_path):
    path, _ = _write_net(tmp_path, "grid3")
    with pytest.raises(ValueError, match="unknown mesh"):
        Engine(EngineConfig(model_path=path, mesh="2by2"))
    with pytest.raises(ValueError, match="has 1"):
        cli.main(["sample", "-m", path, "--device", "cpu", "--mesh", "2x2", "-x", "1"])
    with pytest.raises(ValueError, match="not divisible"):
        Engine(EngineConfig(model_path=path, device="cpu", chains_per_variant=9, mesh="1x2",
                            burnin=9, max_iters=1), log=lambda s: None,
               devices=["cpu"] * 2).run()


def test_cli_mesh_auto_runs_unsharded(tmp_path, capsys):
    path, _ = _write_net(tmp_path, "grid3")
    rc = cli.main(["sample", "-m", path, "-o", "--device", "cpu", "--mesh", "auto",
                   "--vchains", "16", "-b", "90", "-w", "90", "-i", "1", "-e", "2"])
    out = capsys.readouterr().out
    assert rc == 0 and "FINAL" in out and "device mesh" not in out


def test_window_seed_is_shared_by_the_shards(monkeypatch):
    """One window takes one step of the group's seed sequence, whatever
    the mesh: each shard's launch seed derives from it."""
    from grample_tpu_torch.ops import sweep

    m = torch_models.build(port_pgm, "grid3")
    g = _sharded(m, "2x2", 8, 6, 5)
    g.add_variants([m, m])
    seeds = []
    real = sweep.advance_chains
    monkeypatch.setattr(sweep, "advance_chains",
                        lambda kst, st, hv, seed, *a, **kw: (seeds.append(seed),
                                                             real(kst, st, hv, seed, *a, **kw))[1])
    step = g._step
    g.advance()
    assert g._step == step + 1
    w = window_seed(5, step + 1)
    assert seeds == [shard_seed(w, v0, c0 // g.cb) for v0 in (0, 1) for c0 in (0, 4)]
