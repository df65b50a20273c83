"""Checkpoint and resume in the port: kill-and-resume bit for bit, the RB
state round trip, split snapshots with their aux file, files that load
across the two packages in both directions, and engine runs that resume
and continue their budgets."""

import json
import os

import numpy as np
import pytest
import torch

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.sampler.checkpoint as ref_checkpoint
import grample_tpu.sampler.collapse as ref_collapse
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.sampler.checkpoint as port_checkpoint
import grample_tpu_torch.sampler.collapse as port_collapse
from grample_tpu.sampler.chains import ChainGroup as RefChainGroup
from grample_tpu.sampler.split import SplitChainGroup as RefSplitChainGroup
from grample_tpu_torch.sampler.chains import ChainGroup
from grample_tpu_torch.sampler.checkpoint import load_checkpoint, save_checkpoint
from grample_tpu_torch.sampler.engine import Engine, EngineConfig
from grample_tpu_torch.sampler.split import SplitChainGroup
from grample_tpu_torch.uai.writer import write_mar, write_model

from tests import torch_models
from tests.test_torch_adaptive import _random_window


def _group(kind, m, seed=9):
    """A port group of ``kind`` over ``m`` that has burnt in, counted one
    window and taken two RB snapshots."""
    if kind == "split":
        g = SplitChainGroup(m, chains_per_variant=32, converge_window=12, device="cpu",
                            seed=seed, aux_chains=16)
    else:
        g = ChainGroup(m, chains_per_variant=16, converge_window=12, device="cpu", seed=seed,
                       collapse_headroom=kind == "collapse")
    g.add_variants([m, m])
    if kind != "plain":
        g.add_variant(port_collapse.collapse_var(m, 4)[0], burn_sweeps=2)
    g.burn(10)
    g.advance()
    g.rb_accumulate()
    g.advance()
    g.rb_accumulate()
    return g


def _parts(g):
    """Every (name, group) part of a port group."""
    return [("main", g.main), ("aux", g.aux)] if isinstance(g, SplitChainGroup) else [("", g)]


@pytest.mark.parametrize("kind", ["plain", "collapse", "split"])
def test_kill_and_resume_bit_exact(tmp_path, kind):
    """Two uninterrupted windows equal one window, a save, a load and one
    window: states, halves, totals, counts and RB sums, bit for bit
    (reference ``tests/test_engine.py:169-202``)."""
    m = torch_models.build(port_pgm, "grid3")
    a = _group(kind, m)
    a.advance()
    a.rb_accumulate()
    b = _group(kind, m)
    path = str(tmp_path / "kill.npz")
    save_checkpoint(path, b)
    assert os.path.exists(path + ".aux") == (kind == "split")
    del b
    b2, meta = load_checkpoint(path, m)
    assert type(b2) is type(a) and meta["version"] == port_checkpoint.FORMAT_VERSION
    b2.advance()
    b2.rb_accumulate()
    for (name, x), (_, y) in zip(_parts(a), _parts(b2)):
        assert torch.equal(x.state, y.state), name
        assert torch.equal(x.halves, y.halves), name
        np.testing.assert_array_equal(x.totals, y.totals, err_msg=name)
        assert (x._step, x.total_samples, x.total_sweeps) == (y._step, y.total_samples,
                                                               y.total_sweeps), name
        assert x._rb_count == y._rb_count and x._rbp_snaps == y._rbp_snaps, name
        assert x._rb_n == y._rb_n and x._rbp_w == y._rbp_w, name
        for key in x._rb_sum:
            np.testing.assert_array_equal(x._rb_sum[key], y._rb_sum[key])
    np.testing.assert_array_equal(a.merged_marginals(), b2.merged_marginals())


def test_rb_state_checkpoint_roundtrip(tmp_path):
    """RB running sums, decayed weights and snapshot counts survive a
    save and load (reference ``tests/test_chains.py:254-283``)."""
    m = torch_models.build(port_pgm, "grid3")
    g = _group("collapse", m)
    assert g._rbp_snaps.get(4) == 2 and g._rb_count[(2, 4)] == 2
    path = str(tmp_path / "rb.npz")
    save_checkpoint(path, g)
    g2, _ = load_checkpoint(path, m)
    assert g2._rb_n == g._rb_n and g2._rb_count == g._rb_count
    assert g2._rbp_snaps == g._rbp_snaps and g2._rbp_w == g._rbp_w
    for k in g._rb_sum:
        np.testing.assert_allclose(g2._rb_sum[k], g._rb_sum[k], rtol=1e-12)
    for k in g._rbp_sum:
        np.testing.assert_allclose(g2._rbp_sum[k], g._rbp_sum[k], rtol=1e-12)
    np.testing.assert_allclose(g2.merged_marginals(), g.merged_marginals(), rtol=1e-12)


def _assert_same_snapshot(port, ref):
    """A port group and a reference group hold the same snapshot."""
    assert [mv.collapsed.tolist() for mv in port.variants] == \
        [mv.collapsed.tolist() for mv in ref.variants]
    np.testing.assert_array_equal(port.state.numpy(), np.asarray(ref.state))
    np.testing.assert_array_equal(port.halves.numpy(), np.asarray(ref.halves))
    np.testing.assert_array_equal(port.totals, ref.totals)
    assert (port._step, port.total_samples, port.total_sweeps, port.slot_cap) == \
        (ref._step, ref.total_samples, ref.total_sweeps, ref.slot_cap)
    assert port._rb_n == ref._rb_n and port._rb_count == ref._rb_count
    assert port._rbp_w == ref._rbp_w and port._rbp_snaps == ref._rbp_snaps
    for a, b in ((port._rb_sum, ref._rb_sum), (port._rbp_sum, ref._rbp_sum)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_reference_checkpoint_loads_in_port(tmp_path):
    """A file the reference's ``save_checkpoint`` wrote (float32 halves)
    loads in the port with the same variants, state, totals, RB sums,
    step and counts."""
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
    port, meta = load_checkpoint(path, torch_models.build(port_pgm, "grid3"))
    assert meta["step"] == 17
    _assert_same_snapshot(port, ref)
    np.testing.assert_allclose(port.merged_marginals(), ref.merged_marginals(), rtol=1e-12)
    port.advance()  # and it runs on
    assert port.total_samples > 12345


@pytest.mark.parametrize("kind", ["collapse", "split"])
def test_port_checkpoint_loads_in_reference(tmp_path, kind):
    """A file the port wrote (int32 halves; a split snapshot with its
    ``.aux`` file) loads in the reference's ``load_checkpoint``."""
    m = torch_models.build(port_pgm, "grid3")
    port = _group(kind, m)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, port)
    ref, _ = ref_checkpoint.load_checkpoint(path, torch_models.build(ref_pgm, "grid3"))
    if kind == "split":
        assert isinstance(ref, RefSplitChainGroup) and ref.aux_cpv == port.aux_cpv == 16
        _assert_same_snapshot(port.main, ref.main)
        _assert_same_snapshot(port.aux, ref.aux)
    else:
        _assert_same_snapshot(port, ref)
    np.testing.assert_allclose(port.merged_marginals(), ref.merged_marginals(), rtol=1e-12)


def test_halves_formats(tmp_path):
    """Halves load as int32 or as float32 whole counts; a fractional
    count or another format version is refused."""
    m = torch_models.build(port_pgm, "grid3")
    g = _group("plain", m)
    path = str(tmp_path / "h.npz")
    save_checkpoint(path, g)
    with np.load(path) as npz:
        data = {k: npz[k] for k in npz.files}
    for halves, ok in ((data["halves"].astype(np.float32), True),
                       (data["halves"] + np.float32(0.5), False)):
        np.savez(path, **{**data, "halves": halves})
        if ok:
            g2, _ = load_checkpoint(path, m)
            assert torch.equal(g2.halves, g.halves) and g2.halves.dtype == torch.int32
        else:
            with pytest.raises(ValueError, match="whole counts"):
                load_checkpoint(path, m)
    meta = port_checkpoint.read_meta(path)
    np.savez(path, **{**data, "meta": np.array(json.dumps({**meta, "version": 2}))})
    with pytest.raises(ValueError, match="version 2"):
        load_checkpoint(path, m)


def test_split_aux_caps_factory_parity(tmp_path):
    """Resume rebuilds the aux group with the caps and limits a fresh split
    group uses (reference ``tests/test_collapse.py:234-257``)."""
    m = torch_models.star(port_pgm, 4, seed=1, lo=0.2)
    g = SplitChainGroup(m, chains_per_variant=8, converge_window=8, device="cpu", seed=1,
                        aux_chains=8)
    g.add_variants([m, m])
    g.add_variant(port_collapse.collapse_var(m, 1)[0], burn_sweeps=2)
    g.advance(8)
    path = str(tmp_path / "split.npz")
    save_checkpoint(path, g)
    g2, meta = load_checkpoint(path, m)
    assert isinstance(g2, SplitChainGroup) and meta["split"]["aux"]
    assert g2.aux.caps == g.aux.caps and g2.aux.caps.base_mode == "rowgather"
    assert g2.aux.max_variants == g.aux.max_variants
    assert (g2.aux_cpv, g2.cpv, g2.seed) == (g.aux_cpv, g.cpv, g.seed)


def test_nonsplit_snapshot_under_split_factory(tmp_path):
    """A one-group snapshot resumes as one group even where the factory
    builds a split group (reference ``tests/test_collapse.py:260-285``)."""
    m = torch_models.star(port_pgm, 4, seed=1, lo=0.2)
    g = ChainGroup(m, chains_per_variant=8, converge_window=8, device="cpu", seed=1,
                   collapse_headroom=True)
    g.add_variant(m)
    g.add_variant(port_collapse.collapse_var(m, 1)[0])
    g.advance(8)
    path = str(tmp_path / "plain.npz")
    save_checkpoint(path, g)
    g2, _ = load_checkpoint(path, m, make_group=lambda model, **kw: SplitChainGroup(model, **kw))
    assert type(g2) is ChainGroup and g2.num_variants == 2 and g2.caps == g.caps
    before = g2.total_samples
    g2.advance(4)
    assert g2.total_samples > before


# ---- engine runs --------------------------------------------------------------

def _net(tmp_path, name):
    m = torch_models.MODELS[name][0](port_pgm)
    path = str(tmp_path / f"{name}.uai")
    with open(path, "w") as fh:
        fh.write(write_model(m))
    from grample_tpu_torch.pgm.exact import exact_marginals

    truth = exact_marginals(m)
    with open(path + ".MAR", "w") as fh:
        fh.write(write_mar([truth[i, : m.cards[i]] for i in range(m.num_vars)]))
    return path


def _cfg(path, **kw):
    return EngineConfig(**{**dict(
        model_path=path, device="cpu", use_solution=True, burnin=9 * 10,
        converge_window=9 * 20, chains=2, chains_per_variant=32, max_secs=600.0,
        seed=42, status_secs=1e-6), **kw})


def test_engine_resume_continues(tmp_path):
    """``resume`` picks up the snapshot's samples and budgets and goes on
    (reference ``tests/test_engine.py:205-223``)."""
    path = _net(tmp_path, "grid3")
    ck = str(tmp_path / "eng.npz")
    res1 = Engine(_cfg(path, max_iters=20000, checkpoint_path=ck, checkpoint_secs=0.0),
                  log=lambda s: None).run()
    assert os.path.exists(ck)
    saved = port_checkpoint.read_meta(ck)
    assert saved["total_samples"] == res1.samples  # saved after the last window
    logs = []
    res2 = Engine(_cfg(path, max_iters=60000, checkpoint_path=ck, resume=True),
                  log=logs.append).run()
    assert any(s.startswith("RESUMED") for s in logs)
    assert res2.samples > res1.samples >= 20000 and res2.sweeps > res1.sweeps
    assert res2.final_score.max_hellinger < 0.05


@pytest.mark.parametrize("sampler", ["adaptive", "collapsed"])
def test_engine_resume_keeps_variants_and_rb(tmp_path, sampler):
    """A resumed ``-s adaptive`` (split group) or ``-s collapsed`` run keeps
    the snapshot's variants, continues its sample count and RB weights,
    and its last snapshot shows both grown."""
    path = _net(tmp_path, "flip3")
    ck = str(tmp_path / "ck.npz")
    kw = dict(sampler=sampler, checkpoint_path=ck, checkpoint_secs=0.0)
    if sampler == "adaptive":
        kw.update(chain_adds=2, split_group="on")
    else:
        kw.update(chains=3)
    res1 = Engine(_cfg(path, max_iters=9 * 64 * 20 * 4, **kw), log=lambda s: None).run()
    first = port_checkpoint.read_meta(ck)
    g1, _ = load_checkpoint(ck, torch_models.build(port_pgm, "flip3"))
    rb1 = g1.aux if sampler == "adaptive" else g1
    assert rb1._rbp_w or rb1._rb_n
    logs = []
    res2 = Engine(_cfg(path, max_iters=2 * res1.samples, resume=True, **kw),
                  log=logs.append).run()
    assert any(s.startswith("RESUMED") for s in logs)
    assert set(res1.collapsed) <= set(res2.collapsed)
    g2, _ = load_checkpoint(ck, torch_models.build(port_pgm, "flip3"))
    rb2 = g2.aux if sampler == "adaptive" else g2
    assert port_checkpoint.read_meta(ck)["total_samples"] > first["total_samples"]
    for key, snaps in {**rb1._rbp_snaps, **rb1._rb_count}.items():
        now = rb2._rbp_snaps.get(key, rb2._rb_count.get(key))
        assert now > snaps, key


def test_resume_prewarms_the_aux_group(tmp_path, monkeypatch):
    """A resumed split run whose snapshot predates the first collapse
    builds its aux group before the sampling clock anchors."""
    path = _net(tmp_path, "flip3")
    ck = str(tmp_path / "ck.npz")
    m = torch_models.build(port_pgm, "flip3")
    g = SplitChainGroup(m, chains_per_variant=16, converge_window=8, device="cpu", seed=3)
    g.add_variants([m, m])
    g.advance()
    save_checkpoint(ck, g)
    assert not port_checkpoint.read_meta(ck)["split"]["aux"]
    calls = []
    prewarm = SplitChainGroup.prewarm_aux
    monkeypatch.setattr(SplitChainGroup, "prewarm_aux",
                        lambda self: calls.append(self.aux) or prewarm(self))
    logs = []
    Engine(_cfg(path, sampler="adaptive", split_group="on", checkpoint_path=ck, resume=True,
                max_iters=20000, max_secs=30.0), log=logs.append).run()
    assert calls == [None]
    assert logs.index(next(s for s in logs if s.startswith("RESUMED"))) < \
        logs.index(next(s for s in logs if s.startswith("ADAPT")))
