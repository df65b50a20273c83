"""ctypes binding of the Hopper sweep kernel (``csrc/gibbs_window.cu``).

``gibbs_window`` computes what ``ops.gibbs_torch.window_plain`` computes
and returns the same ``(state, counts)``, but only for CUDA tensors: it
launches the kernel on the current stream or raises.
``gibbs_window.launches`` counts its launches,
``gibbs_window.launches_by_form`` the same by kernel form and
``gibbs_window.launches_by_device`` by the card a launch ran on.

The kernel reads the compact work lists of ``ops.layout`` (``c_lists``,
``c_tables``, ``c_rows``), never the dense rectangles.  An encoding with a
gather bank (``uses_gather``) launches the kernel's gather form, which
walks the gather incidences after the dense ones and adds their sum to
the dense sum (the reference's ``gibbs_xla.py:129-141``); its plain
version is ``ops.gibbs_bank.window_ops``.  On this card a
window is bound by the operations issued per site, by how many warps an
SM keeps resident and, counted, by its count stream (below), so the
launch is shaped (``plan_launch``) from the bytes the live work needs,
not from the caps:

  - form: one thread per (variant, chain), unless that would give an SM
    fewer than ``SITE_FORM_WARPS`` warps (``N * C`` below 33792 on 132
    SMs, as the split group's aux launches and an engine run of 2 x 8192
    chains are): then the site-parallel form, a warp per chain whose
    lanes take the live sites of a colour side by side.  Measured on a
    916-var net, the two forms tie at 32768 chains; at 16384 the
    site-parallel form is 2x faster, at 2048 14x, at 65536 1.5x slower;
  - the lists, then the tables, are staged in shared memory when they fit
    beside a block's state; otherwise they are read from device memory;
  - block width (``THREAD_CHOICES``; ``SITE_CHAINS`` warps in the
    site-parallel form): the one that keeps the most warps resident on
    the card at once, counting its shared memory; among equals the one
    that puts blocks on the most SMs, then the widest (fewer copies of
    the lists per SM, and whole waves of blocks).  On full-card launches
    that is 1024 threads with the lists staged once per SM: measured, the
    Promedus-shaped collapse variants run 1.7x faster so than in
    256-thread blocks, and faster than with nothing staged and six times
    the resident warps.  Up to card bound 8 the estimate counts shared
    memory and threads, not registers: the kernel's launch bound lets
    every instance run 1024-thread blocks (at most 64 registers a
    thread), and at the 43 to 64 registers those instances take, an SM
    keeps 1024 to 1280 threads resident, not 2048, at any width; measured
    on binary nets and, for full-card launches, on a 10x10 grid at card 8
    (the widest block is the fastest there too).  Above card bound 8 it
    counts registers too (``resident_threads``: 1024 threads an SM in the
    dense form), so every width keeps as many warps resident, and where
    the tables stay in device memory it takes the width with the most
    resident blocks an SM: a table row's latency then varies from warp to
    warp (an L1 hit or not), and a block's place on the SM frees only when
    its slowest warp ends.  Measured at card 16 (PERF.md): the 60-var
    ObjectDetection-shaped net's full-card window runs 14 % faster in
    32-thread blocks than in 1024-thread ones, and with the tables staged
    (small nets, the gather form) the widest block stays within 0.5 % of
    the fastest;
  - counts are one reduction without a return value per draw of an
    outcome other than 0 into the zero-initialised count tensor (16-bit
    counters in shared memory were measured beside it and were slower:
    they cost resident warps); outcome 0's count of each live site is
    stored once after the sweeps, each half's sweeps less the other
    outcomes' counts.  The count rows of a half outgrow L2 on full-card
    launches (a 10x10 grid at 2 x 131072 chains holds 203 MB of them), so
    each reduction is a read-modify-write of device memory, and a binary
    window's count stream is half what one reduction a draw made it.

Packing the state (1, 2 or 4 bits a row in the thread-per-chain form) is
what keeps a Promedus-shaped net's 256-thread blocks at 29 KB of state.

The gather form keeps a second accumulator of ``K`` logits; at card
bounds above 8 its launch bound is 512 threads a block
(``max_threads``), so that the two accumulators stay in registers.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from grample_tpu_torch.ops import _build
from grample_tpu_torch.ops.layout import MAX_DENSE_ROWS

#: H100 gives one block at most 227 KB of shared memory
MAX_SMEM_BYTES = 232448
THREAD_CHOICES = (1024, 512, 256, 128, 64, 32)
MAX_CARD = 16
#: a scope word of the compact lists holds a state row in 16 bits
MAX_ROWS = MAX_DENSE_ROWS

#: resident threads, shared memory and registers of one SM, blocks it can hold
SM_THREADS, SM_SMEM_BYTES, SM_REGISTERS, SM_BLOCKS = 2048, 233472, 65536, 32
#: card bounds above this are counted by registers (``resident_threads``)
REGISTER_BOUND_CARD = 8
#: SMs of the H100 SXM, on which ``launch_shapes`` compares plans
SM_COUNT = 132
#: chains (warps) per block of the site-parallel form
SITE_CHAINS = (4, 8, 16, 32)
#: warps per SM below which a thread per chain leaves the card idle and
#: the site-parallel form takes the launch
SITE_FORM_WARPS = 8


def max_threads(k: int, gather: bool) -> int:
    """The most threads a block of the kernel's instance for card bound
    ``k`` may have (its ``__launch_bounds__``)."""
    return 512 if gather and k > 8 else 1024


def resident_threads(k: int, gather: bool) -> int:
    """Threads of the instance for card bound ``k`` that an SM keeps
    resident, counting registers above ``REGISTER_BOUND_CARD``: those
    instances take the whole cap their launch bound allows (64 registers a
    thread at 1024 threads: 63-64 in the dense form at card 16; 104-112 of
    128 in the gather form at 512), so an SM holds ``max_threads`` of their
    threads in blocks of any width.  Below it, threads alone are counted."""
    return max_threads(k, gather) if k > REGISTER_BOUND_CARD else SM_THREADS


def uses_gather(kst: dict) -> bool:
    """Whether the encoding of sweep tensors ``kst`` has a gather bank
    (``Fg`` > 0), which takes the kernel's gather form."""
    return "gb_offset" in kst and kst["gb_offset"].shape[3] > 0


def state_bits(k: int) -> int:
    """Bits of a packed state row at card bound ``k``."""
    return 1 if k <= 2 else 2 if k <= 4 else 4


def state_words(rows: int, k: int) -> int:
    """32-bit words of one chain's packed state over ``rows`` rows."""
    return -(-rows * state_bits(k) // 32)


def state_bytes(rows: int, k: int, threads: int) -> int:
    """Shared-memory bytes of a block's packed chain states."""
    return state_words(rows, k) * 4 * threads


@dataclasses.dataclass(frozen=True)
class Plan:
    """The shape of one launch; every byte count is per block."""

    sites: bool  # the site-parallel form (a warp per chain)
    threads: int
    stage_lists: bool
    stage_tables: bool
    count: bool
    list_bytes: int  # the group's padded list blob (both banks)
    table_bytes: int  # the group's padded compact tables (both banks)
    state_bytes: int
    gather: bool  # the gather form (``uses_gather``)

    @property
    def smem(self) -> int:
        return (self.state_bytes + self.list_bytes * self.stage_lists
                + self.table_bytes * self.stage_tables)


def _staging(fixed: int, list_bytes: int, table_bytes: int) -> tuple:
    """(stage lists, stage tables) beside ``fixed`` bytes of state."""
    stage_lists = fixed + list_bytes <= MAX_SMEM_BYTES
    return stage_lists, stage_lists and fixed + list_bytes + table_bytes <= MAX_SMEM_BYTES


def _shapes(list_bytes: int, table_bytes: int, rows: int, k: int, gather: bool, sites: bool):
    """(threads, staging, state bytes, resident blocks per SM) of every
    block width of one form that fits, for padded lists and tables of
    ``list_bytes`` and ``table_bytes`` and ``rows`` padded state rows."""
    for threads in ([32 * w for w in SITE_CHAINS] if sites else THREAD_CHOICES):
        if threads > max_threads(k, gather):
            continue
        sbytes = threads // 32 * rows if sites else state_bytes(rows, k, threads)
        stage = _staging(sbytes, list_bytes, table_bytes)
        smem = sbytes + list_bytes * stage[0] + table_bytes * stage[1]
        resident = min(SM_SMEM_BYTES // (smem + 1024), resident_threads(k, gather) // threads,
                       SM_BLOCKS)
        if smem <= MAX_SMEM_BYTES and resident >= 1:
            yield threads, stage, sbytes, resident


@functools.lru_cache(maxsize=4096)
def launch_shapes(list_bytes: int, table_bytes: int, rows: int, k: int, gather: bool) -> tuple:
    """The (form, threads, staging) of every plan ``plan_launch`` gives
    for these padded sizes to a launch of 32 * 2^j chains in all
    (j < 20, the form by its rule and each form asked for by name) on
    ``SM_COUNT`` SMs: two sizes with the same shapes launch alike."""
    out = []
    for j in range(20):
        for sites in (None, False, True):
            plan = _plan(1, 32 << j, False, SM_COUNT, sites, list_bytes, table_bytes, rows, k,
                         gather)
            out.append(plan and (plan.sites, plan.threads, plan.stage_lists, plan.stage_tables))
    return tuple(out)


def plan_launch(kst: dict, c: int, count: bool, sm_count: int, sites=None) -> Plan:
    """The launch shape the module doc's rules give for ``c`` chains of
    each variant of ``kst``.  ``sites`` overrides the form rule (the smoke
    run and the tests hold each form against the plain version); a form
    that does not fit raises."""
    rows = kst["c_rows"].shape[1]
    plan = _plan(kst["c_lists"].shape[0], c, count, sm_count, sites, kst["c_lists"].shape[1] * 4,
                 kst["c_tables"].shape[1] * 4, rows, kst["k_kmask"].shape[3], uses_gather(kst))
    if plan is None:
        raise ValueError(f"{rows} state rows exceed a block's shared memory")
    return plan


def _plan(n, c, count, sm_count, sites, list_bytes, table_bytes, rows, k, gather):
    """``plan_launch`` from the sizes it reads; None where nothing fits."""
    if sites is None:
        sites = n * c <= sm_count * SITE_FORM_WARPS * 32
    best = None
    for threads, stage, sbytes, resident in _shapes(list_bytes, table_bytes, rows, k, gather,
                                                    sites):
        chains = threads // 32 if sites else threads  # per block
        blocks = n * -(-c // chains)
        refill = resident if k > REGISTER_BOUND_CARD and not stage[1] else 0
        key = (min(blocks, resident * sm_count) * (threads // 32), min(blocks, sm_count), refill,
               threads)
        if best is None or key > best[0]:
            best = (key, Plan(sites, threads, *stage, count, list_bytes, table_bytes, sbytes,
                              gather))
    return best and best[1]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    fn = lib.gibbs_window_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 21 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = lib.gibbs_window_occupancy
    occ.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    return lib


def occupancy(k: int, plan: Plan) -> dict:
    """What the CUDA runtime reports for ``plan``'s kernel at card bound
    ``k`` on the current device: resident blocks per SM, registers per
    thread, bytes of local memory (spills) per thread, and the most
    threads a block may have."""
    out = (ctypes.c_int * 4)()
    err = _lib().gibbs_window_occupancy(int(k), int(plan.count), int(plan.sites),
                                        int(plan.gather), plan.threads, plan.smem,
                                        ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"gibbs_window_occupancy failed: CUDA error {err}")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "max_threads"), out))


@functools.lru_cache(maxsize=256)
def spills(k: int, plan: Plan, device) -> bool:
    """Whether ``plan``'s kernel instance at card bound ``k`` keeps local
    memory (register spills), as ``occupancy`` reports it on ``device``;
    the runtime is asked once a plan."""
    with torch.cuda.device(device):
        return occupancy(k, plan)["local_bytes"] > 0


def gibbs_window(kst: dict, state, seed: int, num_sweeps: int, half_point: int,
                 count: bool, cb: int, plan=None):
    """One advance window on the card (see ``window_plain`` for the
    contract); ``kst`` is ``ops.sweep.sweep_tensors`` output, ``state`` is
    updated in place.  Padding rows are neither counted nor written.
    ``plan`` replaces the launch shape ``plan_launch`` would give (the
    smoke run and the tests compare shapes)."""
    n, nc, g, k = kst["k_kmask"].shape
    if tuple(state.shape[:1]) != (n,) or state.dim() != 3:
        raise ValueError(f"state {tuple(state.shape)} does not stack {n} variants")
    nvp, c = state.shape[1], state.shape[2]
    dev = state.device
    expect = {key: (kst[key], torch.float32 if key == "c_tables" else torch.int32,
                    (n, kst[key].shape[-1])) for key in ("c_lists", "c_tables", "c_rows")}
    expect["state"] = (state, torch.int32, (n, nvp, c))
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if kst["c_lists"].shape[1] % 4 or kst["c_tables"].shape[1] % 4:
        raise ValueError("compact lists and tables must be padded to 16 bytes")
    if k > MAX_CARD:
        raise ValueError(f"max card {k} > {MAX_CARD}: not taken by the sweep kernel")
    if cb <= 0 or c <= 0 or n <= 0 or n > 65535:
        raise ValueError(f"bad window shape n={n} c={c} cb={cb}")
    if plan is None:
        plan = plan_launch(kst, c, bool(count),
                           torch.cuda.get_device_properties(dev).multi_processor_count)
    if (plan.count != bool(count) or plan.gather != uses_gather(kst)
            or plan.smem > MAX_SMEM_BYTES or plan.threads % 32
            or not 32 <= plan.threads <= max_threads(k, plan.gather)
            or plan.state_bytes < (plan.threads // 32 * kst["c_rows"].shape[1] if plan.sites
                                   else state_bytes(kst["c_rows"].shape[1], k, plan.threads))):
        raise ValueError(f"launch plan does not fit this window: {plan}")
    counts = (torch.zeros((n, 2, k, nc * g, c), dtype=torch.int32, device=dev)
              if count else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().gibbs_window_launch(
            kst["c_lists"].data_ptr(), kst["c_tables"].data_ptr(),
            kst["c_rows"].data_ptr(), state.data_ptr(),
            counts.data_ptr() if count else None,
            n, kst["c_lists"].shape[1], kst["c_tables"].shape[1],
            kst["c_rows"].shape[1], nc, g, k, nvp, c, _as_int32(seed),
            int(num_sweeps), int(half_point), int(cb), int(plan.count),
            int(plan.sites), int(plan.gather), int(plan.stage_lists), int(plan.stage_tables),
            state_words(kst["c_rows"].shape[1], k), plan.threads, plan.smem, stream)
    if err != 0:
        raise RuntimeError(f"gibbs_window_launch failed: CUDA error {err}")
    gibbs_window.launches += 1
    name = form_name(plan)
    gibbs_window.launches_by_form[name] = gibbs_window.launches_by_form.get(name, 0) + 1
    by_dev = gibbs_window.launches_by_device
    by_dev[str(dev)] = by_dev.get(str(dev), 0) + 1
    return state, counts


gibbs_window.launches = 0
#: the same count split by kernel form (``form_name``)
gibbs_window.launches_by_form = {}
#: the same count by device (``"cuda:1"``): which cards of a mesh launched
gibbs_window.launches_by_device = {}


def form_name(plan: Plan) -> str:
    """The kernel form a plan launches, as ``launches_by_form`` keys it."""
    return (("site-parallel" if plan.sites else "thread per chain") + ", "
            + ("counted" if plan.count else "uncounted")
            + (", gather bank" if plan.gather else ""))


def _as_int32(x: int) -> int:
    """The seed's low 32 bits as a signed int (the reference's int32 seed)."""
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x
