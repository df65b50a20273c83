"""One advance window for stacked variants, in the reference's layout.

Counterpart of ``grample_tpu.ops.gibbs_pallas.advance_chains_pallas``
(``:495-545``): permute ``[N, C, V+1]`` chain state into the kernel's row
order ``[N, NVp, C]``, run one window, permute back, and map the kernel's
slot counts ``[N, 2, K, NSLOT, C]`` onto the split-half window tensor
``[N, 2, C, V+1, K]``.

The window runs the CUDA kernel (``ops.gibbs_cuda``) for CUDA tensors and
its plain PyTorch version (``ops.gibbs_torch``) for CPU tensors; a CUDA
tensor never takes the plain path.  ``check_supported`` is the gate: the
sweep takes the dense local-table bank only, local tables of at most
``OA_MAX`` rows, cards up to 16, and state that fits the kernel's shared
memory.

One code path serves every table width.  The reference kernel has two
lookup forms (an unrolled select chain up to 32 rows, a counted loop up
to ``PAL_OA_MAX`` = 256, ``gibbs_pallas.py:347-367``) and stops at 256
because its bf16 base matmul is exact only that far (``:219-221``); the
port reads row ``base`` of the local table directly, so its bound is the
encoder's: ``BASE_DENSE_LIMIT`` = 1024 rows, the widest incidence
``compute_caps`` keeps dense.  The collapsed sampler's own 256 bound is
``pgm.encode.COLLAPSE_OA_DENSE_CAP``, applied by ``is_collapsible``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as fnn

from grample_tpu_torch.ops import gibbs_cuda
from grample_tpu_torch.ops.gibbs_torch import window_plain
from grample_tpu_torch.ops.layout import kernel_stack
from grample_tpu_torch.pgm.encode import BASE_DENSE_LIMIT

#: hash lane width (the reference kernel's chain block ``cb``) used when a
#: group's chains-per-variant allows it (see ``hash_block``)
HASH_CB = 1024

KERNEL_KEYS = ("k_scope", "k_strides", "k_tables", "k_kmask")

#: widest local table (rows) the sweep takes: see the module doc
OA_MAX = BASE_DENSE_LIMIT


def check_supported(caps) -> None:
    """Refuse, with a reason, what the sweep does not take."""
    if caps.gfac_cap > 0:
        raise ValueError(
            f"encoding uses the gather bank (gfac_cap={caps.gfac_cap}): the "
            "sweep takes dense local tables only (incidences of at most "
            f"{caps.oa_dense_cap} local rows)")
    if caps.oa_cap > OA_MAX:
        raise ValueError(f"local tables of {caps.oa_cap} rows exceed the "
                         f"sweep's {OA_MAX}")
    if caps.max_card > gibbs_cuda.MAX_CARD:
        raise ValueError(f"max card {caps.max_card} > {gibbs_cuda.MAX_CARD}: "
                         "not taken by the sweep kernel")
    if gibbs_cuda.pick_threads(caps.num_rows) == 0:
        raise ValueError(f"{caps.num_rows} state rows exceed the sweep "
                         "kernel's shared memory")


def hash_block(chains: int) -> int:
    """Hash lane width for ``chains`` chains per variant: the largest
    divisor of ``chains`` that divides ``HASH_CB``."""
    return int(np.gcd(int(chains), HASH_CB))


def sweep_tensors(stack: dict, device) -> dict:
    """Kernel-order sweep tensors on ``device`` from a stacked encoding
    (``pgm.encode.stack_variants`` output, numpy, leading axis N)."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in kernel_stack(stack).items()}


def window(kst: dict, state_p, seed: int, num_sweeps: int, half_point: int,
           count: bool, cb: int):
    """Kernel on CUDA tensors, plain version on CPU tensors, else raise."""
    args = [kst[k] for k in KERNEL_KEYS]
    if state_p.is_cuda:
        return gibbs_cuda.gibbs_window(*args, state_p, seed, num_sweeps,
                                       half_point, count, cb)
    if state_p.device.type == "cpu":
        return window_plain(*args, state_p, seed, num_sweeps, half_point,
                            count, cb)
    raise ValueError(f"no sweep for device {state_p.device}")


def advance_chains(kst: dict, state, halves, seed: int, num_sweeps: int,
                   half_point: int, count: bool = True, cb: int = HASH_CB):
    """Advance every chain of every stacked variant by one window.

    kst: ``sweep_tensors`` output; state ``[N, C, V+1]`` int32; halves
    ``[N, 2, C, V+1, K]`` int32 (the window's counts are ADDED when
    ``count``).  ``seed`` is the window's int32 seed and ``cb`` the hash
    lane width (``C % cb == 0`` reproduces the reference kernel's chain
    blocks).  Returns new ``(state, halves)``.
    """
    n, c, v1 = state.shape
    oon = kst["pal_oon"].long()  # [N, NVp]
    nvp = oon.shape[1]
    state_p = torch.gather(state, 2, oon[:, None, :].expand(n, c, nvp))
    state_p = state_p.transpose(1, 2).contiguous()  # [N, NVp, C]
    state_p, counts = window(kst, state_p, seed, num_sweeps, half_point,
                             count, cb)
    noo = kst["pal_noo"].long()  # [N, V+1]
    state_out = torch.gather(state_p, 1, noo[:, :, None].expand(n, v1, c))
    state_out = state_out.transpose(1, 2).contiguous()
    if count:
        # slot -> old var; ungrouped vars (slot NSLOT) read an appended
        # zero row, as the reference pads its counts with zero rows
        k = counts.shape[2]
        counts = fnn.pad(counts, (0, 0, 0, 1))  # [N, 2, K, NSLOT+1, C]
        soo = kst["pal_soo"].long()[:, None, None, :, None]
        mapped = torch.gather(counts, 3, soo.expand(n, 2, k, v1, c))
        halves = halves + mapped.permute(0, 1, 4, 3, 2)
    return state_out, halves
