"""Carry the JAX package's state across to the port.

The two packages share their layouts at their public functions, so the
tests can feed one encoding and one chain state to both:

  - ``encoding_from_reference``: the reference's ``EncodedModel.arrays()``
    (one variant) or ``stack_variants`` output (leading axis N), numpy,
    to the port's kernel-order sweep tensors.  ``sw_wbase`` (the TPU's
    base-matmul constants) has no counterpart and is dropped.
  - ``chains_from_reference``: the reference's ``[N, C, V+1]`` int32
    state and ``[N, 2, C, V+1, K]`` float32 window halves to the port's
    int32 tensors (the halves hold exact counts).
  - ``carry_group_state``: a reference ``ChainGroup``'s host and device
    state onto a port group built over the same variants, so both
    packages can continue from one state (adapt steps, RB snapshots,
    merges); a split group is carried part by part, its aux group on
    either tier (``AUX_CHAINS`` or full-width slots).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from grample_tpu_torch.ops.sweep import sweep_tensors


def encoding_from_reference(arrays: dict, device, compact: bool = True) -> dict:
    """Reference encoding arrays -> the port's sweep tensors on ``device``
    (``compact`` as in ``ops.sweep.sweep_tensors``)."""
    stack = {k: np.asarray(v) for k, v in arrays.items() if k != "sw_wbase"}
    if stack["old_of_new"].ndim == 1:  # one variant: add the stack axis
        stack = {k: v[None] for k, v in stack.items()}
    return sweep_tensors(stack, device, compact)


def carry_group_state(ref, port) -> None:
    """Copy a reference group's chain state, window halves, count totals,
    step, sample and sweep counts and RB running sums onto ``port`` (a
    port ``ChainGroup`` of the same variants and slot capacity)."""
    ref.flush()
    if port.slot_cap != ref.slot_cap or port.num_variants != ref.num_variants:
        raise ValueError("the port group must hold the reference's slots")
    state, halves = chains_from_reference(ref.state, ref.halves, port.device)
    port.restore_device_state(state, halves)
    port._pending.clear()
    port.totals = np.array(ref.totals, dtype=np.float64)
    port._step = ref._step
    port.total_samples = ref.total_samples
    port.total_sweeps = ref.total_sweeps
    for name in ("_rb_sum", "_rb_n", "_rb_count", "_rbp_sum", "_rbp_w", "_rbp_snaps"):
        setattr(port, name, copy.deepcopy(getattr(ref, name)))


def chains_from_reference(state, halves, device) -> tuple:
    """Reference chain state and window halves -> port tensors."""
    halves = np.asarray(halves)
    if not np.array_equal(halves, np.round(halves)):
        raise ValueError("window halves must hold whole counts")
    return (torch.as_tensor(np.array(state, dtype=np.int32), device=device),
            torch.as_tensor(halves.astype(np.int32), device=device))
