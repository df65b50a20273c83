"""One advance window for stacked variants, in the reference's layout.

Counterpart of ``grample_tpu.ops.gibbs_pallas.advance_chains_pallas``
(``:495-545``): permute ``[N, C, V+1]`` chain state into the kernel's row
order ``[N, NVp, C]``, run one window, permute back, and map the kernel's
slot counts ``[N, 2, K, NSLOT, C]`` onto the split-half window tensor
``[N, 2, C, V+1, K]``.

The window has two routes, chosen from the group's caps before any launch
(``route_for``).  ``"kernel"``: the CUDA kernel (``ops.gibbs_cuda``) for
CUDA tensors, on both banks (the dense local tables and the flat-table
gather bank), and for CPU tensors the plain PyTorch version of the form
the encoding needs (``ops.gibbs_torch.window_plain`` for the dense bank
alone, ``ops.gibbs_bank.window_ops`` with a gather bank); a CUDA tensor
never takes a plain path.  ``"ops"``: batched torch ops on the tensors'
device (``ops.gibbs_bank``, the counterpart of the reference's XLA
sweep), for what ``kernel_refusal`` names: cards above 16, more state
rows than a 32-thread block's shared memory holds packed or than
``gibbs_cuda.MAX_ROWS`` (what a launch really needs is sized from its live
rows, by ``gibbs_cuda.plan_launch``), local tables wider than ``OA_MAX``
rows, and compact tables beyond int32 offsets.
``sweep_tensors`` carries every input: the dense kernel-order rectangles
that the plain versions and the ops route read, the gather bank, and the
compact work lists (``ops.layout``) that the kernel walks, since on the
card a window is bound by the operations and shared-memory loads it makes
per slot visited, and most slots of the rectangles are padding.

A chain group's sweep tensors are a ``SweepStack``: this module is their
only owner, and the samplers (``sampler.chains``, ``parallel.mesh``) know
neither their format nor the kernel's facts.  It builds and places them,
writes new slots, scales them for the tempered burn-in, advances a slot
prefix by one window, and counts a counted window's launch counters
(``sites.merged``, ``sites.tables_global``, ``sites.spilled``); the
outcome whose counts the kernel derives is ``REST_OUTCOME``, which
``rest_derived`` counts in a folded delta (``sites.rest_derived``).

The kernel route has one code path for every table width.  The
reference kernel has two lookup forms (an unrolled select chain up to 32 rows, a counted loop up
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
from grample_tpu_torch.ops.gibbs_bank import window_ops
from grample_tpu_torch.ops.gibbs_torch import window_plain
from grample_tpu_torch.ops.layout import COMPACT_KEYS, kernel_stack, merged_sites
from grample_tpu_torch.pgm.encode import BASE_DENSE_LIMIT

#: hash lane width (the reference kernel's chain block ``cb``) used when a
#: group's chains-per-variant allows it (see ``hash_block``)
HASH_CB = 1024

KERNEL_KEYS = ("k_scope", "k_strides", "k_tables", "k_kmask")

#: widest local table (rows) the sweep takes: see the module doc
OA_MAX = BASE_DENSE_LIMIT


def kernel_refusal(caps):
    """Why the CUDA kernel does not take an encoding at ``caps``, or None
    when it does (the port's counterpart of the reference's
    ``pallas_eligible``, ``gibbs_pallas.py:229-253``, which refuses the
    gather bank; the port's kernel walks it).  What it refuses runs as
    torch ops (``ops.gibbs_bank``)."""
    if caps.oa_cap > OA_MAX:
        return f"local tables of {caps.oa_cap} rows exceed the kernel's {OA_MAX}"
    if caps.max_card > gibbs_cuda.MAX_CARD:
        return (f"max card {caps.max_card} > {gibbs_cuda.MAX_CARD}: "
                "not taken by the sweep kernel")
    if (caps.num_rows > gibbs_cuda.MAX_ROWS
            or gibbs_cuda.state_bytes(caps.num_rows, caps.max_card, 32)
            > gibbs_cuda.MAX_SMEM_BYTES):
        return f"{caps.num_rows} state rows exceed the sweep kernel's shared memory"
    floats = (caps.color_cap * caps.group_cap * caps.adj_cap * caps.oa_cap * caps.max_card
              + caps.table_cap)
    if floats >= 2 ** 31:
        return (f"compact tables of up to {floats} floats exceed the kernel's int32 "
                "table offsets")
    return None


def route_for(caps) -> str:
    """``"kernel"`` or ``"ops"``: the sweep route of a group at ``caps``,
    decided from the caps alone, before any launch."""
    return "kernel" if kernel_refusal(caps) is None else "ops"


def check_supported(caps) -> None:
    """Refuse what neither route takes.  The reference's encoder has no
    card or row limit of its own (``grample_tpu/pgm/encode.py:555-560``
    checks a variant against its caps only); its index arithmetic is
    int32 (``gibbs_xla.py:133-134``), as is the torch route's within one
    variant, so a flat table or a state beyond int32 is refused."""
    if caps.table_cap >= 2 ** 31 or caps.num_rows >= 2 ** 31:
        raise ValueError(f"flat table of {caps.table_cap} entries or state of "
                         f"{caps.num_rows} rows exceeds the sweep's int32 indices")


def hash_block(chains: int) -> int:
    """Hash lane width for ``chains`` chains per variant: the largest
    divisor of ``chains`` that divides ``HASH_CB``."""
    return int(np.gcd(int(chains), HASH_CB))


def sweep_tensors(stack: dict, device, compact: bool = True) -> dict:
    """Kernel-order sweep tensors on ``device`` from a stacked encoding
    (``pgm.encode.stack_variants`` output, numpy, leading axis N);
    ``compact`` False leaves out the kernel's work lists, which the ops
    route does not read."""
    return to_device(kernel_stack(stack, compact), device)


def to_device(kst: dict, device) -> dict:
    """``ops.layout.kernel_stack`` output (numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in kst.items()}


def write_slots(kst: dict, slots, fresh: dict) -> None:
    """Write the variants of ``fresh`` (``sweep_tensors`` output) into
    slots ``slots`` of the group's tensors ``kst``, in place.  The dense
    tensors share their shapes; a compact tensor (``ops.layout``) of
    either side is first zero-padded to the longer of the two."""
    for key, v in fresh.items():
        if key in COMPACT_KEYS:
            cap = max(v.shape[1], kst[key].shape[1])
            v = fnn.pad(v, (0, cap - v.shape[1]))
            kst[key] = fnn.pad(kst[key], (0, cap - kst[key].shape[1]))
        kst[key][slots] = v


#: every tensor of ``sweep_tensors`` that holds log potentials
TABLE_KEYS = ("k_tables", "c_tables", "tables")


def scale_tables(kst: dict, beta: float) -> dict:
    """``kst`` with every log table (dense, compact and flat) times
    ``beta`` (the reference scales its flat tables too,
    ``sampler/chains.py:723``).  The compact lists become the unmerged ones
    (``ops.layout``'s ``u_lists``): a merged table scaled would hold the
    scaled sum of its rows, not the sum of the scaled rows that the plain
    version adds."""
    out = dict(kst)
    if "u_lists" in kst:
        out["c_lists"], out["c_tables"] = kst["u_lists"], kst["u_tables"]
    out.update({k: out[k] * beta for k in TABLE_KEYS if k in out})
    if "u_lists" in kst:
        out["u_tables"] = out["c_tables"]
    return out


def window(kst: dict, state_p, seed: int, num_sweeps: int, half_point: int,
           count: bool, cb: int, route: str = "kernel"):
    """One window by the group's ``route`` (``route_for`` of its caps).
    ``"kernel"``: the CUDA kernel (on the compact lists) for CUDA
    tensors; for CPU tensors its plain version on the dense tensors
    (``window_plain``, or ``window_ops`` when the encoding has a gather
    bank: on a dense encoding the two are equal bit for bit); else raise.
    ``"ops"``: the batched torch ops of ``ops.gibbs_bank`` on the tensors'
    device.  Nothing here turns a failed launch into another route."""
    if route == "ops":
        return window_ops(kst, state_p, seed, num_sweeps, half_point, count, cb)
    if route != "kernel":
        raise ValueError(f"unknown sweep route {route!r}")
    if state_p.is_cuda:
        return gibbs_cuda.gibbs_window(kst, state_p, seed, num_sweeps,
                                       half_point, count, cb)
    if state_p.device.type == "cpu":
        if gibbs_cuda.uses_gather(kst):
            return window_ops(kst, state_p, seed, num_sweeps, half_point, count, cb)
        return window_plain(*[kst[k] for k in KERNEL_KEYS], state_p, seed,
                            num_sweeps, half_point, count, cb)
    raise ValueError(f"no sweep for device {state_p.device}")


def advance_chains(kst: dict, state, halves, seed: int, num_sweeps: int,
                   half_point: int, count: bool = True, cb: int = HASH_CB,
                   route: str = "kernel"):
    """Advance every chain of every stacked variant by one window.

    kst: ``sweep_tensors`` output; state ``[N, C, V+1]`` int32; halves
    ``[N, 2, C, V+1, K]`` int32 (the window's counts are ADDED when
    ``count``).  ``seed`` is the window's int32 seed and ``cb`` the hash
    lane width (``C % cb == 0`` reproduces the reference kernel's chain
    blocks); ``route`` as in ``window``.  Returns new ``(state, halves)``.
    """
    n, c, v1 = state.shape
    oon = kst["pal_oon"].long()  # [N, NVp]
    nvp = oon.shape[1]
    state_p = torch.gather(state, 2, oon[:, None, :].expand(n, c, nvp))
    state_p = state_p.transpose(1, 2).contiguous()  # [N, NVp, C]
    state_p, counts = window(kst, state_p, seed, num_sweeps, half_point,
                             count, cb, route)
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


#: the outcome whose count the CUDA kernel derives once a window, each
#: half's sweeps less the other outcomes' counts (``derive_rest`` in
#: ``csrc/gibbs_window.cu``), instead of reducing every draw of it
REST_OUTCOME = 0


def rest_derived(delta: np.ndarray, num_vars: int) -> int:
    """The updates of a folded count delta [N, V+1, K] of the real vars
    (below ``num_vars``) at ``REST_OUTCOME``: those whose counts a window
    on the kernel derived (the tracer's ``sites.rest_derived``)."""
    return int(delta[:, :num_vars, REST_OUTCOME].sum())


class SweepStack:
    """A chain group's sweep tensors, placed on ``devices``, and the host
    facts about them worked out when they are built or written.

    ``tensors[device]`` is the ``sweep_tensors`` dict on that device (the
    chain shards of a mesh row share one copy a device); ``merged`` [N]
    holds each slot's live sites on merged tables (the ``c_lists``
    headers, 0 on the ops route); ``card`` is the card bound; ``kernel``
    says whether its windows run the CUDA kernel (the kernel route on CUDA
    devices)."""

    def __init__(self, stack: dict, route: str, devices):
        host = kernel_stack(stack, route == "kernel")
        self.route = route
        self.tensors = {dev: to_device(host, dev) for dev in map(torch.device, devices)}
        self.merged = merged_sites(host)
        self.card = host["k_kmask"].shape[3]
        self.kernel = route == "kernel" and all(d.type == "cuda" for d in self.tensors)

    def write(self, slots, stack: dict) -> None:
        """Write the variants of the stacked encoding ``stack``
        (``stack_variants`` output) into slots ``slots``, on every
        device."""
        fresh = kernel_stack(stack, self.route == "kernel")
        for dev, kst in self.tensors.items():
            write_slots(kst, slots, to_device(fresh, dev))
        self.merged[slots] = merged_sites(fresh)

    def cut(self, device, n: int) -> dict:
        """The tensors on ``device`` of the first ``n`` slots."""
        return {k: v[:n] for k, v in self.tensors[device].items()}

    def advance(self, device, state, halves, seed: int, num_sweeps: int, half_point: int,
                count: bool, cb: int, beta: float = 1.0):
        """``advance_chains`` of the slot prefix that ``state`` [n, C, V+1]
        holds on ``device``, its log tables times ``beta`` where that is
        below 1 (``scale_tables``)."""
        kst = self.cut(device, state.shape[0])
        if beta < 1.0:
            kst = scale_tables(kst, beta)
        return advance_chains(kst, state, halves, seed, num_sweeps, half_point, count=count,
                              cb=cb, route=self.route)

    def launch_counts(self, device, n: int, chains: int, sweeps: int, free) -> dict:
        """The launch counters of a counted window of ``sweeps`` sweeps
        over the first ``n`` slots of ``device``, ``chains`` chains a slot,
        whose real variants have ``free`` free vars each: ``sites.merged``,
        the claimed updates whose site walks a merged table; where the
        window runs the kernel, ``sites.tables_global`` and
        ``sites.spilled``, the claimed updates where the launch's plan
        (``gibbs_cuda.plan_launch``) reads the compact tables from device
        memory and where its kernel instance keeps local memory (0
        where not)."""
        out = {"sites.merged": sweeps * chains * int(self.merged[:len(free)].sum())}
        if self.kernel:
            plan = gibbs_cuda.plan_launch(
                self.cut(device, n), chains, True,
                torch.cuda.get_device_properties(device).multi_processor_count)
            sites = sweeps * chains * sum(free)
            out["sites.tables_global"] = 0 if plan.stage_tables else sites
            out["sites.spilled"] = sites if gibbs_cuda.spills(self.card, plan, device) else 0
        return out
