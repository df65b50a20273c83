"""The CUDA sweep kernel on the card, against its plain PyTorch version.

Every test here carries the ``cuda`` marker and skips without a CUDA
device.  The file imports no JAX, so it runs on a GPU machine that has
only PyTorch:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.encode as port_encode
from grample_tpu_torch.metrics import hellinger
from grample_tpu_torch.ops import gibbs_cuda, sweep
from grample_tpu_torch.ops.gibbs_torch import window_plain
from grample_tpu_torch.pgm.exact import exact_marginals
from grample_tpu_torch.sampler.chains import ChainGroup

from tests import torch_models

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _long_chain(v=2000):
    """A binary chain long enough that its state needs more than 48 KB of
    shared memory per 128-thread block (the kernel then runs 64 threads
    with the dynamic shared-memory attribute raised)."""
    return torch_models.chain_model(port_pgm, seed=21, v=v)


@pytest.mark.parametrize("name", ["grid4_evid", "grid3_card3_evid", "rand8_card4", "long_chain"])
def test_kernel_matches_plain_on_card(cuda_device, name):
    """One counted window of 3 sweeps (half point 1): at most 0.1 % of
    sites differ after it, tail rows stay, counts agree wherever the
    states agree, and each count total is chains x sweeps x slots."""
    m = _long_chain() if name == "long_chain" else torch_models.build(port_pgm, name)
    enc = port_encode.encode_model(m, port_encode.compute_caps(m, headroom_factors=0))
    kst = sweep.sweep_tensors(port_encode.stack_variants([enc, enc]), cuda_device)
    args = [kst[k] for k in sweep.KERNEL_KEYS]
    nvp, nslot = enc.caps.num_rows, enc.caps.num_slots
    c = 1024 if name == "long_chain" else 4096
    rng = np.random.default_rng(2)
    init = np.floor(rng.random((2, nvp, c)) * enc.cards[kst["pal_oon"].cpu().numpy()][:, :, None])
    state = torch.as_tensor(init.astype(np.int32), device=cuda_device)
    before = gibbs_cuda.gibbs_window.launches
    sk, ck = gibbs_cuda.gibbs_window(*args, state.clone(), -77, 3, 1, True, 512)
    sp, cp = window_plain(*args, state.clone(), -77, 3, 1, True, 512)
    torch.cuda.synchronize()
    assert gibbs_cuda.gibbs_window.launches == before + 1
    assert (sk[:, :nslot] != sp[:, :nslot]).float().mean().item() <= 1e-3
    assert torch.equal(sk[:, nslot:], state[:, nslot:])
    agree = (sk[:, :nslot] == sp[:, :nslot]).all(dim=0)
    assert torch.equal(ck[:, :, :, agree], cp[:, :, :, agree])
    for half, sweeps in ((0, 1), (1, 2)):
        assert ck[:, half].sum().item() == cp[:, half].sum().item() == 2 * c * sweeps * nslot


@pytest.mark.parametrize("name", ["grid4_evid", "grid3_card3_evid", "rand8_card4"])
def test_chain_group_on_card_vs_exact(cuda_device, name):
    """Tempered burn-in and deferred counted windows on the card converge
    to the exact marginals, through the kernel."""
    m = torch_models.build(port_pgm, name)
    truth = exact_marginals(m)
    g = ChainGroup(m, chains_per_variant=1024, converge_window=100,
                   device=cuda_device, seed=3)
    g.add_variants([m, m])
    before = gibbs_cuda.gibbs_window.launches
    g.burn_annealed(100, stages=5)
    for _ in range(4):
        g.advance(defer=True)
    h = hellinger(g.merged_marginals(), truth, m.cards, m.fixed)
    assert gibbs_cuda.gibbs_window.launches == before + 9
    # 2048 chains x 400 counted sweeps, n_eff >= 2048 * 400 / 8:
    # 5 sigma(H) ~ 5 / sqrt(8 n_eff), plus at most 1.5e-3 bias from each
    # chain's uniform 1/card seed over 400 counted sweeps
    assert h.max() < 5.0 / np.sqrt(8 * 2048 * 400 / 8) + 1.5e-3, h
    psrf = g.convergence()
    assert np.isfinite(psrf).all() and (psrf[m.fixed >= 0] == 1.0).all()
