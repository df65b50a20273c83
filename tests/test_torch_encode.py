"""The port's encoding and kernel row order against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.pgm.encode as ref_encode
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.encode as port_encode
from grample_tpu.ops.gibbs_pallas import pal_bank_dims, pallas_stack
from grample_tpu_torch.ops.gibbs_torch import color_logits
from grample_tpu_torch.ops.layout import kernel_stack
from grample_tpu_torch.ops.sweep import sweep_tensors

from tests import torch_models
from tests.test_gibbs import brute_logits

NAMES = sorted(torch_models.MODELS)


def _both(name, **caps_kw):
    ref_m = torch_models.build(ref_pgm, name)
    port_m = torch_models.build(port_pgm, name)
    ref_caps = ref_encode.compute_caps(ref_m, **caps_kw)
    port_caps = port_encode.compute_caps(port_m, **caps_kw)
    return (ref_m, ref_encode.encode_model(ref_m, ref_caps),
            port_m, port_encode.encode_model(port_m, port_caps))


def _caps_fields(caps):
    d = dataclasses.asdict(caps)
    # the reference's "matmul" mode is its "rowgather" mode plus the TPU
    # base-matmul constants, which the port does not build
    d["base_mode"] = {"matmul": "rowgather"}.get(d["base_mode"], d["base_mode"])
    return d


@pytest.mark.parametrize("headroom", [0, 2])
@pytest.mark.parametrize("name", NAMES)
def test_encoding_matches_reference(name, headroom):
    """Caps, colors, groups, slot maps, local tables, scope vars and
    strides, kmask and the gather bank: every array the port keeps."""
    ref_m, ref_enc, _, port_enc = _both(name, headroom_factors=headroom)
    assert _caps_fields(port_enc.caps) == _caps_fields(ref_enc.caps)
    assert port_enc.num_colors == ref_enc.num_colors
    want = ref_enc.arrays()
    got = port_enc.arrays()
    assert set(want) - set(got) == {"sw_wbase"}
    for key, arr in got.items():
        np.testing.assert_array_equal(arr, want[key], err_msg=key)
        assert arr.dtype == want[key].dtype, key
    for key, arr in port_enc.legacy_arrays().items():
        np.testing.assert_array_equal(arr, ref_enc.legacy_arrays()[key], err_msg=key)
    np.testing.assert_array_equal(port_enc.exact_marginals, ref_enc.exact_marginals)
    stacked = port_encode.stack_variants([port_enc, port_enc])
    assert stacked["sw_local_tables"].shape[0] == 2


def test_merge_caps_and_gather_tier():
    """merge_caps takes the elementwise max; a model whose dense local
    tables would overflow the budget encodes into the gather bank, as in
    the reference."""
    m = torch_models.build(port_pgm, "rand6")
    a = port_encode.compute_caps(m)
    b = dataclasses.replace(a, group_cap=a.group_cap + 8, oa_cap=a.oa_cap + 1)
    merged = port_encode.merge_caps(a, b)
    assert merged.group_cap == b.group_cap and merged.oa_cap == b.oa_cap
    assert merged.fits(a) and merged.fits(b)
    big = port_encode.compute_caps(m, slot_hint=1 << 40)
    ref_big = ref_encode.compute_caps(torch_models.build(ref_pgm, "rand6"), slot_hint=1 << 40)
    assert big.base_mode == ref_big.base_mode == "gather"
    assert big.gfac_cap == ref_big.gfac_cap > 0


@pytest.mark.parametrize("name", NAMES)
def test_kernel_order_matches_pallas_stack(name):
    """The port's kernel order and count-slot maps equal the reference
    kernel's ``pal_oon``/``pal_noo``/``pal_soo`` and its in-card mask."""
    _, ref_enc, _, port_enc = _both(name, headroom_factors=0)
    ref_pal = pallas_stack([ref_enc, ref_enc], pal_bank_dims([ref_enc, ref_enc]))
    kst = kernel_stack(port_encode.stack_variants([port_enc, port_enc]))
    for key in ("pal_oon", "pal_noo", "pal_soo"):
        np.testing.assert_array_equal(kst[key], ref_pal[key], err_msg=key)
    # pal_km is [N, NC, K, G] float; k_kmask is [N, NC, G, K] uint8
    np.testing.assert_array_equal(kst["k_kmask"].transpose(0, 1, 3, 2),
                                  ref_pal["pal_km"].astype(np.uint8))
    assert kst["k_tables"].dtype == np.float32 and kst["k_scope"].dtype == np.int32


@pytest.mark.parametrize("name", NAMES)
def test_color_logits_match_bruteforce(name):
    """The sweep's lookup (kernel order, direct indexing) gives the exact
    log-conditional of every grouped var (``tests/test_gibbs.py:95``)."""
    m = torch_models.build(port_pgm, name)
    ref_m = torch_models.build(ref_pgm, name)
    enc = port_encode.encode_model(m, port_encode.compute_caps(m, headroom_factors=0))
    kst = sweep_tensors(port_encode.stack_variants([enc]), "cpu")
    rng = np.random.default_rng(4)
    chains = 4
    state = np.zeros((chains, m.num_vars + 1), dtype=np.int32)
    for c in range(chains):
        state[c, :-1] = [rng.integers(0, int(k)) for k in m.cards]
        state[c, :-1] = np.where(m.fixed >= 0, m.fixed, state[c, :-1])
    oon = kst["pal_oon"][0].numpy()
    st = torch.as_tensor(state.T[oon])  # [NVp, C] kernel order
    G = enc.caps.group_cap
    checked = 0
    for ci in range(enc.caps.color_cap):
        lg = color_logits(kst["k_scope"], kst["k_strides"], kst["k_tables"], st, 0, ci)
        for g in range(G):
            var = int(oon[ci * G + g])
            if var >= m.num_vars:
                assert not kst["k_kmask"][0, ci, g].any()
                continue
            for c in range(chains):
                want = brute_logits(ref_m, state[c], var)
                got = lg[g, c, : int(m.cards[var])].numpy()
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            checked += 1
    assert checked == int(m.free_mask.sum())
