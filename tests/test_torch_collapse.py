"""The port's collapse (tables, conditionals, guards, picks), its exact
variant caps and the encodings of collapse variants, and the ``collapse``
command, against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.pgm.encode as ref_encode
import grample_tpu.sampler.collapse as ref_collapse
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.encode as port_encode
import grample_tpu_torch.sampler.collapse as port_collapse
from grample_tpu import cli as ref_cli
from grample_tpu_torch import cli as port_cli
from grample_tpu_torch.convert import chains_from_reference, encoding_from_reference
from grample_tpu_torch.ops.sweep import kernel_refusal, sweep_tensors
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.uai.writer import write_mar, write_model

from tests import torch_models

#: float64 tables computed by the same numpy ops in the same order
RTOL = 1e-12

NETS = ["grid3", "grid3_card3_evid", "rand8_card4", "star8", "star10",
        "star6_card3_evid", "full8_evid"]


def _both(name):
    return torch_models.build(ref_pgm, name), torch_models.build(port_pgm, name)


def _assert_same_model(a, b):
    np.testing.assert_array_equal(a.cards, b.cards)
    np.testing.assert_array_equal(a.fixed, b.fixed)
    np.testing.assert_array_equal(a.collapsed, b.collapsed)
    np.testing.assert_allclose(a.marginals, b.marginals, rtol=RTOL, atol=0)
    assert [f.name for f in a.factors] == [f.name for f in b.factors]
    for fa, fb in zip(a.factors, b.factors):
        np.testing.assert_array_equal(fa.scope, fb.scope)
        np.testing.assert_allclose(fa.table, fb.table, rtol=RTOL, atol=0)
        assert fa.is_log == fb.is_log


@pytest.mark.parametrize("name", NETS)
def test_collapse_var_and_conditional_match_reference(name):
    """Every collapsible var: the variant's factors, the exact marginal,
    and the RB conditional table, within float64 rounding."""
    ref_m, port_m = _both(name)
    done = 0
    for var in range(port_m.num_vars):
        if not ref_collapse.is_collapsible(ref_m, var):
            continue
        ref_v, ref_exact = ref_collapse.collapse_var(ref_m, var)
        port_v, port_exact = port_collapse.collapse_var(port_m, var)
        np.testing.assert_allclose(port_exact, ref_exact, rtol=RTOL, atol=0)
        _assert_same_model(ref_v, port_v)
        for want, got in zip(ref_collapse.collapse_conditional(ref_m, var),
                             port_collapse.collapse_conditional(port_m, var)):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
        done += 1
    assert done > 0
    assert not port_m.collapsed.any()  # the input model is untouched


@pytest.mark.parametrize("oa_cap", [0, 32, 64, 256])
@pytest.mark.parametrize("name", NETS)
def test_guards_and_picks_match_reference(name, oa_cap):
    """is_collapsible (with the dense-bank guard), collapsible_vars and
    the seeded random picks are the reference's."""
    ref_m, port_m = _both(name)
    for var in range(port_m.num_vars):
        assert (port_collapse.is_collapsible(port_m, var, oa_cap=oa_cap)
                == ref_collapse.is_collapsible(ref_m, var, oa_cap=oa_cap))
    assert port_collapse.collapsible_vars(port_m) == ref_collapse.collapsible_vars(ref_m)
    for seed in range(6):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(4):  # one generator across picks, as the engine draws
            assert (port_collapse.pick_random_collapsible(port_m, ra, oa_cap=oa_cap)
                    == ref_collapse.pick_random_collapsible(ref_m, rb, oa_cap=oa_cap))


def _collapse_mod(pgm):
    return ref_collapse if pgm is ref_pgm else port_collapse


def _guard_model(pgm, case):
    """Inputs on which collapse must refuse (``tests/test_collapse.py``
    guard cases, and the blanket and table caps)."""
    if case in ("fixed", "collapsed_twice", "index_low", "index_high"):
        m = torch_models.build(pgm, "star6_card3_evid")
        var = {"fixed": 5, "collapsed_twice": 1, "index_low": -1, "index_high": 6}[case]
        if case == "collapsed_twice":
            m = _collapse_mod(pgm).collapse_var(m, 1)[0]
        return m, var
    if case == "single_var":
        f = pgm.Factor("f", [0], np.array([0.25, 0.75]))
        return pgm.DiscreteModel(type="MARKOV", cards=[2], factors=[f]), 0
    if case == "blanket13":
        return torch_models.star(pgm, 12, seed=1, lo=0.2), 0
    if case == "table":  # 11 card-5 leaves: 5**11 > 2**23 entries
        return torch_models.star(pgm, 11, seed=1, lo=0.2, card=5), 0
    raise KeyError(case)


@pytest.mark.parametrize("case", ["fixed", "collapsed_twice", "index_low", "index_high",
                                  "single_var", "blanket13", "table"])
def test_collapse_errors_match_reference(case):
    """CollapseError on the same inputs, from both functions; and
    is_collapsible says no wherever its arguments are valid."""
    for pgm, mod in ((ref_pgm, ref_collapse), (port_pgm, port_collapse)):
        m, var = _guard_model(pgm, case)
        with pytest.raises(mod.CollapseError):
            mod.collapse_var(m, var)
        if case not in ("fixed", "collapsed_twice"):
            with pytest.raises(mod.CollapseError):
                mod.collapse_conditional(m, var)
        if 0 <= var < m.num_vars:
            assert not mod.is_collapsible(m, var)
    assert issubclass(port_collapse.CollapseError, ValueError)
    assert port_collapse.NEIGHBOR_VAR_MAX == ref_collapse.NEIGHBOR_VAR_MAX == 12


def test_dense_guard_and_headroom_caps_match_reference():
    """``tests/test_collapse.py:161-194``: the oa_cap guard on stars of 9
    and 10 leaves, and collapse-headroom caps that keep a blanket-10
    variant free of gather-bank rows."""
    def star(pgm, leaves):
        rng = np.random.default_rng(12345)
        fs = [pgm.Factor(f"f{i}", [0, i], rng.random(4) + 0.1) for i in range(1, leaves + 1)]
        return pgm.DiscreteModel(type="MARKOV", cards=[2] * (leaves + 1), factors=fs)

    for pgm, mod, enc in ((ref_pgm, ref_collapse, ref_encode),
                          (port_pgm, port_collapse, port_encode)):
        m = star(pgm, 9)
        assert mod.is_collapsible(m, 0) and mod.is_collapsible(m, 0, oa_cap=256)
        assert not mod.is_collapsible(m, 0, oa_cap=32)
        big = star(pgm, 10)
        assert mod.is_collapsible(big, 0) and not mod.is_collapsible(big, 0, oa_cap=256)
        caps = enc.compute_caps(m, collapse_headroom=True, slot_hint=8)
        assert (caps.oa_dense_cap, caps.gfac_cap, caps.oa_cap) == (256, 0, 256)
        variant, _ = mod.collapse_var(m, 0)
        caps = enc.merge_caps(caps, enc.compute_caps(variant, oa_dense_cap=caps.oa_dense_cap))
        assert enc.encode_model(variant, caps).gb_mask.sum() == 0
    assert kernel_refusal(caps) is None


def _caps_fields(caps):
    d = dataclasses.asdict(caps)
    d["base_mode"] = {"matmul": "rowgather"}.get(d["base_mode"], d["base_mode"])
    return d


@pytest.mark.parametrize("names", [["star8_c0"], ["star10_c0"], ["star6_card3_c0"],
                                   ["full8_c2"], ["star8_c0", "star10_c0"]])
@pytest.mark.parametrize("slot_hint", [1, 8])
def test_caps_for_variants_matches_reference(names, slot_hint):
    """Field by field, the same exact caps over the same variant list."""
    ref_vs = [torch_models.collapsed(ref_pgm, n)[1] for n in names]
    port_vs = [torch_models.collapsed(port_pgm, n)[1] for n in names]
    if len(names) > 1:  # two stars of different sizes are not one model
        ref_vs, port_vs = ref_vs[1:], port_vs[1:]
    want = ref_encode.caps_for_variants(ref_vs, slot_hint=slot_hint)
    got = port_encode.caps_for_variants(port_vs, slot_hint=slot_hint)
    assert _caps_fields(got) == _caps_fields(want)
    assert got.gfac_cap == 0 and got.oa_cap > 32
    assert kernel_refusal(got) is None
    with pytest.raises(ValueError, match="empty"):
        port_encode.caps_for_variants([])


@pytest.mark.parametrize("name", sorted(torch_models.WIDE))
def test_collapse_variant_encoding_matches_reference(name):
    """A collapse variant encodes array by array as in the reference
    (tail rows, update_ok, the replacement factor's dense incidences),
    and ``convert`` carries the reference's arrays and chain state to the
    port's tensors unchanged."""
    _, ref_v, _ = torch_models.collapsed(ref_pgm, name)
    _, port_v, _ = torch_models.collapsed(port_pgm, name)
    ref_enc = ref_encode.encode_model(ref_v, ref_encode.caps_for_variants([ref_v]))
    port_enc = port_encode.encode_model(port_v, port_encode.caps_for_variants([port_v]))
    want = ref_enc.arrays()
    got = port_enc.arrays()
    assert set(want) - set(got) == {"sw_wbase"}
    for key, arr in got.items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)
        assert arr.dtype == want[key].dtype, key
    for key, arr in port_enc.legacy_arrays().items():
        np.testing.assert_array_equal(arr, ref_enc.legacy_arrays()[key], err_msg=key)
    np.testing.assert_array_equal(port_enc.exact_marginals, ref_enc.exact_marginals)
    var = torch_models.WIDE[name][1]
    assert not port_enc.update_ok[var] and port_enc.collapsed[var]
    assert port_enc.new_of_old[var] > port_enc.caps.sentinel_row  # a tail row
    assert port_enc.gb_mask.sum() == 0

    kst = encoding_from_reference(ref_encode.stack_variants([ref_enc, ref_enc]), "cpu")
    mine = sweep_tensors(port_encode.stack_variants([port_enc, port_enc]), "cpu")
    assert set(kst) == set(mine)
    for key in kst:
        assert torch.equal(kst[key], mine[key]), key
    one = encoding_from_reference(want, "cpu")  # one variant: stack axis added
    assert torch.equal(one["k_tables"], mine["k_tables"][:1])
    rng = np.random.default_rng(0)
    state = np.where(ref_enc.fixed >= 0, ref_enc.fixed,
                     rng.integers(0, 2, (2, 8, ref_v.num_vars + 1))).astype(np.int32)
    halves = np.zeros((2, 2, 8, ref_v.num_vars + 1, ref_enc.caps.max_card), np.float32)
    st, hv = chains_from_reference(state, halves, "cpu")
    np.testing.assert_array_equal(st.numpy(), state)
    assert hv.dtype == torch.int32 and hv.shape == halves.shape


def test_promedus_like_variants_match_reference():
    """The Promedus-shaped net of ``chip_smoke.py``: the 8 widest
    collapsible vars give the same exact caps, local tables of 256 rows,
    and one variant encodes array by array as in the reference."""
    caps = {}
    encs = {}
    for pgm, mod, enc in ((ref_pgm, ref_collapse, ref_encode),
                          (port_pgm, port_collapse, port_encode)):
        m, evidence = torch_models.promedus_like(pgm, seed=1)
        m.apply_evidence(evidence)
        picks = torch_models.widest_collapsible(pgm, m, 8)
        variants = [mod.collapse_var(m, v)[0] for v in picks]
        caps[enc] = enc.caps_for_variants(variants, slot_hint=8)
        encs[enc] = enc.encode_model(variants[0], caps[enc]).arrays()
    assert _caps_fields(caps[port_encode]) == _caps_fields(caps[ref_encode])
    assert caps[port_encode].oa_cap == 256
    assert kernel_refusal(caps[port_encode]) is None
    for key, arr in encs[port_encode].items():
        np.testing.assert_array_equal(arr, encs[ref_encode][key], err_msg=key)


def _net_with_mar(tmp_path, name):
    m = torch_models.MODELS[name][0](port_pgm)
    evidence = torch_models.MODELS[name][1]
    path = str(tmp_path / f"{name}.uai")
    with open(path, "w") as fh:
        fh.write(write_model(m))
    with open(path + ".evid", "w") as fh:
        fh.write(f"{len(evidence)} " + " ".join(f"{k} {v}" for k, v in evidence.items()))
    m.apply_evidence(evidence)
    truth = exact_marginals(m)
    with open(path + ".MAR", "w") as fh:
        fh.write(write_mar([truth[i, : m.cards[i]] for i in range(m.num_vars)]))
    return path


@pytest.mark.parametrize("flag", [False, True])
@pytest.mark.parametrize("name", ["star6_card3_evid", "full8_evid"])
def test_collapse_command_prints_reference_lines(tmp_path, capsys, name, flag):
    """The same stdout as the reference's ``collapse``, which applies the
    evidence with or without ``-d``."""
    path = _net_with_mar(tmp_path, name)
    argv = ["collapse", "-m", path] + (["-d"] if flag else [])
    assert ref_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert port_cli.main(argv) == 0
    got = capsys.readouterr().out
    assert got == want
    assert "Col vs Sol" in got and "collapsed:" in got
