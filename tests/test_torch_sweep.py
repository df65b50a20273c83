"""The port's sweep against the reference Pallas kernel (interpret mode on
the CPU), and its gate.  The CUDA kernel's own tests are in
``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.pgm.encode as ref_encode
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.encode as port_encode
from grample_tpu.ops.gibbs_pallas import _hash_uniform, advance_chains_pallas, pal_bank_dims, pallas_stack
from grample_tpu_torch.convert import chains_from_reference, encoding_from_reference
from grample_tpu_torch.ops import _build, gibbs_bank, gibbs_cuda, sweep
from grample_tpu_torch.ops.gibbs_torch import hash_uniform

from tests import torch_models


@pytest.mark.parametrize("counter", [0, 12345, 0xDEADBEEF])
def test_hash_uniform_bit_exact(counter):
    want = np.asarray(_hash_uniform(jnp.uint32(counter), 64, 256))
    got = hash_uniform(counter, 64, 256).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _ref_inputs(name, chains, seed=0):
    """One reference encoding stacked twice, and a random initial state."""
    m = torch_models.build(ref_pgm, name)
    enc = ref_encode.encode_model(m, ref_encode.compute_caps(m, headroom_factors=0))
    encs = [enc, enc]
    rng = np.random.default_rng(seed)
    v1 = m.num_vars + 1
    draw = np.floor(rng.random((2, chains, v1)) * enc.cards).astype(np.int32)
    state = np.where(enc.fixed >= 0, enc.fixed, draw).astype(np.int32)
    return m, encs, state


@pytest.mark.parametrize("name,sweeps,count", [
    ("grid3", 1, False),
    ("grid3", 2, True),
    ("grid3_card3_evid", 2, True),
    ("rand8_card4", 1, True),
])
def test_window_matches_pallas_kernel(name, sweeps, count):
    """Same encoding, state, int32 seed and hash width ``cb`` through the
    reference kernel (interpret mode) and the port: at least 99.9 % of
    sites agree (a draw on a CDF boundary may flip with ``exp``'s last
    bit), counts agree wherever the states agree, evidence stays."""
    m, encs, state = _ref_inputs(name, chains=256)
    dims = pal_bank_dims(encs)
    pal = {k: jnp.asarray(v) for k, v in pallas_stack(encs, dims).items()}
    kdim = encs[0].caps.max_card
    halves = np.zeros((2, 2, 256, m.num_vars + 1, kdim), np.float32)
    key = jax.random.key(7)
    seed = int(jax.random.bits(key, dtype=jnp.uint32).astype(jnp.int32))
    ref_state, ref_halves = advance_chains_pallas(
        pal, jnp.asarray(state), jnp.asarray(halves), key, sweeps, sweeps // 2,
        count=count, cb=128, dims=dims)
    ref_state, ref_halves = np.asarray(ref_state), np.asarray(ref_halves)

    kst = encoding_from_reference(ref_encode.stack_variants(encs), "cpu")
    st, hv = chains_from_reference(state, halves, "cpu")
    got_state, got_halves = sweep.advance_chains(
        kst, st, hv, seed, sweeps, sweeps // 2, count=count, cb=128)
    got_state, got_halves = got_state.numpy(), got_halves.numpy()

    free = m.free_mask
    agree = got_state[:, :, :-1] == ref_state[:, :, :-1]
    assert agree[:, :, free].mean() >= 0.999
    fixed = m.fixed >= 0
    np.testing.assert_array_equal(got_state[:, :, :-1][:, :, fixed], state[:, :, :-1][:, :, fixed])
    np.testing.assert_array_equal(got_state[:, :, -1], 0)  # sentinel
    same = agree.all(axis=0)  # [C, V]: sites equal in both variants
    np.testing.assert_array_equal(
        got_halves[:, :, :, :-1][:, :, same], ref_halves[:, :, :, :-1][:, :, same])
    total = got_halves.sum()
    assert total == (sweeps * 2 * 256 * int(free.sum()) if count else 0)


def _wide_inputs(name, chains, seed=0):
    """A collapse variant with wide local tables, encoded by the reference
    against its exact caps, stacked twice, and a random initial state."""
    _, variant, _ = torch_models.collapsed(ref_pgm, name)
    enc = ref_encode.encode_model(variant, ref_encode.caps_for_variants([variant]))
    rng = np.random.default_rng(seed)
    draw = np.floor(rng.random((2, chains, variant.num_vars + 1)) * enc.cards).astype(np.int32)
    state = np.where(enc.fixed >= 0, enc.fixed, draw).astype(np.int32)
    return variant, [enc, enc], state


@pytest.mark.parametrize("name,sweeps,count", [
    ("star8_c0", 2, True),
    ("star10_c0", 1, True),
    ("star10_c0", 1, False),
    ("star6_card3_c0", 2, True),
])
def test_wide_window_matches_pallas_kernel(name, sweeps, count):
    """Local tables of 64, 81 and 256 rows: the reference kernel looks
    them up in its counted loop (``gibbs_pallas.py:355-367``), the port
    by direct indexing.  Same encoding, state, seed and ``cb``: at least
    99.9 % of sites agree, counts agree wherever the states agree."""
    m, encs, state = _wide_inputs(name, chains=128)
    assert encs[0].caps.oa_cap > 32 and encs[0].caps.gfac_cap == 0
    dims = pal_bank_dims(encs)
    pal = {k: jnp.asarray(v) for k, v in pallas_stack(encs, dims).items()}
    halves = np.zeros((2, 2, 128, m.num_vars + 1, encs[0].caps.max_card), np.float32)
    key = jax.random.key(3)
    seed = int(jax.random.bits(key, dtype=jnp.uint32).astype(jnp.int32))
    ref_state, ref_halves = advance_chains_pallas(
        pal, jnp.asarray(state), jnp.asarray(halves), key, sweeps, sweeps // 2,
        count=count, cb=128, dims=dims)
    ref_state, ref_halves = np.asarray(ref_state), np.asarray(ref_halves)

    kst = encoding_from_reference(ref_encode.stack_variants(encs), "cpu")
    st, hv = chains_from_reference(state, halves, "cpu")
    got_state, got_halves = sweep.advance_chains(
        kst, st, hv, seed, sweeps, sweeps // 2, count=count, cb=128)
    got_state, got_halves = got_state.numpy(), got_halves.numpy()

    free = m.free_mask
    agree = got_state[:, :, :-1] == ref_state[:, :, :-1]
    assert agree[:, :, free].mean() >= 0.999
    np.testing.assert_array_equal(got_state[:, :, :-1][:, :, ~free], state[:, :, :-1][:, :, ~free])
    same = agree.all(axis=0)
    np.testing.assert_array_equal(
        got_halves[:, :, :, :-1][:, :, same], ref_halves[:, :, :, :-1][:, :, same])
    assert got_halves.sum() == (sweeps * 2 * 128 * int(free.sum()) if count else 0)


def test_advance_chains_multi_block_layout():
    """Chains in several hash blocks, split halves and an evidence var:
    every counted site lands in its half, evidence is never counted."""
    m = torch_models.build(port_pgm, "grid4_evid")
    enc = port_encode.encode_model(m, port_encode.compute_caps(m, headroom_factors=0))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc] * 3), "cpu")
    rng = np.random.default_rng(1)
    c, v1 = 96, m.num_vars + 1
    state = np.where(enc.fixed >= 0, enc.fixed, rng.integers(0, 2, (3, c, v1))).astype(np.int32)
    halves = torch.zeros((3, 2, c, v1, 2), dtype=torch.int32)
    st, hv = sweep.advance_chains(kst, torch.as_tensor(state), halves, -5, 5, 2,
                                  count=True, cb=32)
    hv = hv.numpy()
    free = m.free_mask
    # every (variant, chain, free var) counted once per sweep: 2 + 3 sweeps
    np.testing.assert_array_equal(hv[:, 0, :, :-1][:, :, free].sum(axis=-1), 2)
    np.testing.assert_array_equal(hv[:, 1, :, :-1][:, :, free].sum(axis=-1), 3)
    assert hv[:, :, :, :-1][:, :, :, ~free].sum() == 0
    np.testing.assert_array_equal(st.numpy()[:, :, :-1][:, :, ~free],
                                  state[:, :, :-1][:, :, ~free])
    assert st.dtype == torch.int32 and st.shape == (3, c, v1)


def _caps_of(name, **kw):
    m = torch_models.build(port_pgm, name)
    return port_encode.compute_caps(m, **kw)


@pytest.mark.parametrize("case", ["gather_bank", "card17", "rows", "oa"])
def test_gate_refuses(case):
    """The kernel's gate names what the kernel does not take; the sweep
    takes it all the same, by the torch-ops route.  The gather bank itself
    passes; what it refuses there is compact tables beyond the kernel's
    int32 offsets."""
    caps = _caps_of("rand6")
    assert sweep.kernel_refusal(caps) is None and sweep.route_for(caps) == "kernel"
    assert sweep.kernel_refusal(dataclasses.replace(caps, gfac_cap=1)) is None
    bad, reason = {
        "gather_bank": (dataclasses.replace(caps, gfac_cap=1, table_cap=2 ** 31 - 1),
                        "int32 table offsets"),
        "card17": (dataclasses.replace(caps, max_card=17), "max card"),
        "rows": (dataclasses.replace(caps, tail_cap=80000), "shared memory"),
        "oa": (dataclasses.replace(caps, oa_cap=sweep.OA_MAX + 1), "local tables"),
    }[case]
    assert reason in sweep.kernel_refusal(bad)
    assert sweep.route_for(bad) == "ops"
    sweep.check_supported(bad)


def test_gate_refuses_what_no_route_takes():
    """Both routes index with int32 inside one variant (reference
    ``gibbs_xla.py:133-134``): a longer flat table is refused."""
    caps = dataclasses.replace(_caps_of("rand6"), table_cap=2 ** 31)
    with pytest.raises(ValueError, match="int32"):
        sweep.check_supported(caps)


def test_gate_admits_wide_tables():
    """Above the reference's 256-row kernel bound the port still takes a
    dense encoding: a 10-var binary factor (a dv-rel-shaped incidence of
    512 rows) encodes dense and passes the gate."""
    m = torch_models.wide_factor(port_pgm, 10, seed=2)
    caps = port_encode.compute_caps(m, headroom_factors=0)
    assert caps.oa_cap == 512 and caps.gfac_cap == 0
    assert sweep.kernel_refusal(caps) is None


def test_gate_refuses_gather_model():
    """A real model whose encoding needs the gather bank is not refused by
    the chain runtime: the kernel's gate takes the bank, the group takes
    the kernel route with compact gather lists (on the CPU the gather
    form's plain version, ``window_ops``), and its marginals match exact.
    32768 counted samples per var: 5 sigma(H) = 5 / sqrt(8 n) = 0.0098."""
    from grample_tpu_torch.metrics import hellinger
    from grample_tpu_torch.pgm.exact import exact_marginals
    from grample_tpu_torch.sampler.chains import ChainGroup

    rng = np.random.default_rng(0)
    v = 12
    big = port_pgm.Factor("big", np.arange(v), rng.random(2**v) + 0.1)
    unary = [port_pgm.Factor(f"u{i}", [i], rng.random(2) + 0.1) for i in range(v)]
    m = port_pgm.DiscreteModel(type="MARKOV", cards=[2] * v, factors=[big] + unary)
    caps = port_encode.compute_caps(m, headroom_factors=0, oa_dense_cap=32,
                                    slot_hint=1 << 40)
    assert caps.gfac_cap > 0
    assert sweep.kernel_refusal(caps) is None
    g = ChainGroup(m, 256, 64, device="cpu", caps=caps, seed=3)
    assert g.route == "kernel"
    g.add_variants([m, m])
    assert set(sweep.COMPACT_KEYS) <= set(g.kstack.tensors[g.device])
    g.burn(16)
    before = dict(gibbs_bank.window_ops.launches_by_form)
    g.advance()
    assert gibbs_bank.window_ops.launches_by_form["torch ops, counted"] \
        == before.get("torch ops, counted", 0) + 1
    got = g.merged_marginals()
    got = got / got.sum(axis=1, keepdims=True)
    assert hellinger(got, exact_marginals(m), np.full(v, 2)).max() < 5 / np.sqrt(8 * 32768)


def test_kernel_route_on_cuda_never_takes_ops_or_plain(monkeypatch):
    """Kernel-eligible caps on a CUDA tensor launch the kernel wrapper and
    nothing else: neither the torch-ops route nor the plain version is
    called, and a failing launch raises through."""
    m = torch_models.build(port_pgm, "grid3")
    enc = port_encode.encode_model(m, port_encode.compute_caps(m, headroom_factors=0))
    assert sweep.route_for(enc.caps) == "kernel"
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc]), "cpu")

    class OnCard:
        is_cuda = True

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor left the kernel")

    calls = []
    monkeypatch.setattr(sweep, "window_ops", refuse)
    monkeypatch.setattr(sweep, "window_plain", refuse)
    monkeypatch.setattr(gibbs_cuda, "gibbs_window", lambda *a: calls.append(a) or "launched")
    state = OnCard()
    assert sweep.window(kst, state, 1, 2, 1, True, 8, route="kernel") == "launched"
    assert calls == [(kst, state, 1, 2, 1, True, 8)]

    def broken(*a):
        raise RuntimeError("gibbs_window_launch failed: CUDA error 700")

    monkeypatch.setattr(gibbs_cuda, "gibbs_window", broken)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        sweep.window(kst, state, 1, 2, 1, True, 8, route="kernel")
    with pytest.raises(ValueError, match="unknown sweep route"):
        sweep.window(kst, state, 1, 2, 1, True, 8, route="auto")


@pytest.mark.parametrize("bank", ["dense", "gather"])
def test_kernel_route_takes_the_plain_version_of_its_form(monkeypatch, bank):
    """On the CPU the kernel route runs the plain version of the form the
    encoding needs: ``window_plain`` for the dense bank alone,
    ``window_ops`` with a gather bank; on a CUDA tensor either encoding
    launches the kernel wrapper and nothing else."""
    from tests.torch_models import all_gather

    m = torch_models.build(port_pgm, "grid3")
    caps = port_encode.compute_caps(m, headroom_factors=0)
    caps = all_gather(caps) if bank == "gather" else caps
    assert sweep.route_for(caps) == "kernel"
    kst = sweep.sweep_tensors(port_encode.stack_variants(
        [port_encode.encode_model(m, caps)]), "cpu")
    assert gibbs_cuda.uses_gather(kst) == (bank == "gather")
    ran = []
    for name in ("window_ops", "window_plain"):
        monkeypatch.setattr(sweep, name, lambda *a, name=name: ran.append(name) or name)
    monkeypatch.setattr(gibbs_cuda, "gibbs_window", lambda *a: ran.append("kernel") or "kernel")
    state = torch.zeros((1, caps.num_rows, 8), dtype=torch.int32)
    want = "window_ops" if bank == "gather" else "window_plain"
    assert sweep.window(kst, state, 1, 2, 1, True, 8, route="kernel") == want

    class OnCard:
        is_cuda = True

    assert sweep.window(kst, OnCard(), 1, 2, 1, True, 8, route="kernel") == "kernel"
    assert ran == [want, "kernel"]


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version: CPU tensors are
    refused before anything is built or launched."""
    m = torch_models.build(port_pgm, "grid3")
    enc = port_encode.encode_model(m, port_encode.compute_caps(m, headroom_factors=0))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc]), "cpu")
    state = torch.zeros((1, enc.caps.num_rows, 8), dtype=torch.int32)
    before = gibbs_cuda.gibbs_window.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        gibbs_cuda.gibbs_window(kst, state, 0, 1, 0, True, 8)
    assert gibbs_cuda.gibbs_window.launches == before
    with pytest.raises(ValueError, match="no sweep for device"):
        sweep.window(kst, state.to("meta"), 0, 1, 0, True, 8)


def test_build_library_path_tracks_sources():
    path = _build.library_path()
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    assert path == _build.library_path()
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_hash_block():
    assert sweep.hash_block(131072) == 1024
    assert sweep.hash_block(128) == 128
    assert sweep.hash_block(96) == 32



@pytest.mark.parametrize("case,sweeps,count", [
    ("grid4", 2, True),
    ("grid4", 1, False),
    ("rand8", 2, True),
    ("star8_aux", 2, True),
])
def test_headroom_window_matches_pallas_kernel(case, sweeps, count):
    """Collapse-headroom encodings (empty colour groups, dead spare
    incidences, a long evidence/collapsed tail): the port encodes them
    array for array as the reference does, and its window agrees with
    the reference kernel (interpret mode) as on plain encodings.  The
    reference kernel reads base indices from the matmul mode's ``sw_wbase``
    only, so ``aux_caps``' rowgather encodings reach it in matmul mode
    (every other array is the same)."""
    variants, caps, m = torch_models.headroom_variants(ref_pgm, case)
    pvariants, pcaps, _ = torch_models.headroom_variants(port_pgm, case)
    assert dataclasses.asdict(pcaps) == {**dataclasses.asdict(caps), "base_mode": "rowgather"}
    assert sweep.kernel_refusal(pcaps) is None
    encs = [ref_encode.encode_model(v, dataclasses.replace(caps, base_mode="matmul"))
            for v in variants]
    for pv, v, enc in zip(pvariants, variants, encs):
        want = ref_encode.encode_model(v, caps).arrays()
        for key, arr in port_encode.encode_model(pv, pcaps).arrays().items():
            np.testing.assert_array_equal(arr, want[key], err_msg=key)
            if key != "sw_wbase":
                np.testing.assert_array_equal(arr, enc.arrays()[key], err_msg=key)
    real = [np.abs(e.sw_local_tables).max(axis=(3, 4)) > 0 for e in encs]  # [NC, G, F]
    assert any(not r.any(axis=(1, 2))[-1] for r in real), "no empty colour group"
    assert all((~r[e.color_mask]).any() for r, e in zip(real, encs)), "no dead incidence"
    n, chains = len(encs), 128
    rng = np.random.default_rng(5)
    draw = np.floor(rng.random((n, chains, m.num_vars + 1))
                    * np.stack([e.cards for e in encs])[:, None]).astype(np.int32)
    fixed = np.stack([e.fixed for e in encs])[:, None]
    state = np.where(fixed >= 0, fixed, draw).astype(np.int32)
    dims = pal_bank_dims(encs)
    pal = {k: jnp.asarray(v) for k, v in pallas_stack(encs, dims).items()}
    halves = np.zeros((n, 2, chains, m.num_vars + 1, caps.max_card), np.float32)
    key = jax.random.key(11)
    seed = int(jax.random.bits(key, dtype=jnp.uint32).astype(jnp.int32))
    ref_state, ref_halves = advance_chains_pallas(
        pal, jnp.asarray(state), jnp.asarray(halves), key, sweeps, sweeps // 2,
        count=count, cb=128, dims=dims)
    ref_state, ref_halves = np.asarray(ref_state), np.asarray(ref_halves)

    kst = encoding_from_reference(ref_encode.stack_variants(encs), "cpu")
    st, hv = chains_from_reference(state, halves, "cpu")
    got_state, got_halves = sweep.advance_chains(
        kst, st, hv, seed, sweeps, sweeps // 2, count=count, cb=128)
    got_state, got_halves = got_state.numpy(), got_halves.numpy()

    free = np.stack([v.free_mask for v in variants])  # [N, V]
    agree = got_state[:, :, :-1] == ref_state[:, :, :-1]
    assert agree.transpose(0, 2, 1)[free].mean() >= 0.999
    np.testing.assert_array_equal(got_state.transpose(0, 2, 1)[:, :-1][~free],
                                  state.transpose(0, 2, 1)[:, :-1][~free])
    np.testing.assert_array_equal(got_state[:, :, -1], 0)  # sentinel
    same = agree.all(axis=0)
    np.testing.assert_array_equal(
        got_halves[:, :, :, :-1][:, :, same], ref_halves[:, :, :, :-1][:, :, same])
    assert got_halves.sum() == (sweeps * chains * int(free.sum()) if count else 0)
    assert got_halves[:, :, :, :-1].transpose(0, 3, 1, 2, 4)[~free].sum() == 0
