"""ctypes binding of the Hopper sweep kernel (``csrc/gibbs_window.cu``).

``gibbs_window`` takes the same arguments as
``ops.gibbs_torch.window_plain`` and returns the same ``(state, counts)``,
but only for CUDA tensors: it launches the kernel on the current stream
or raises.  ``gibbs_window.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from grample_tpu_torch.ops import _build

#: the kernel keeps a block's chain states in shared memory as uint8
#: [NVp][threads]; H100 gives one block at most 227 KB
MAX_SMEM_BYTES = 232448
THREAD_CHOICES = (128, 64, 32)
MAX_CARD = 16


def pick_threads(nvp: int) -> int:
    """Largest block width whose [NVp][threads] uint8 state fits shared
    memory; 0 when even 32 threads do not fit."""
    for t in THREAD_CHOICES:
        if nvp * t <= MAX_SMEM_BYTES:
            return t
    return 0


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load_library()
    fn = lib.gibbs_window_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = lib.gibbs_window_occupancy
    occ.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    return lib


def occupancy(k: int, count: bool, nvp: int) -> tuple:
    """(threads per block, resident blocks per SM) of a window launch over
    ``nvp`` state rows at max card ``k``, as the CUDA runtime reports it
    for the current device."""
    threads = pick_threads(nvp)
    if threads == 0 or k > MAX_CARD:
        raise ValueError(f"no launch for nvp={nvp} k={k}")
    blocks = ctypes.c_int(0)
    err = _lib().gibbs_window_occupancy(int(k), int(bool(count)), threads, int(nvp),
                                        ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"gibbs_window_occupancy failed: CUDA error {err}")
    return threads, blocks.value


def gibbs_window(k_scope, k_strides, k_tables, k_kmask, state, seed: int,
                 num_sweeps: int, half_point: int, count: bool, cb: int):
    """One advance window on the card (see ``window_plain`` for the
    contract); ``state`` is updated in place."""
    n, nc, g, f, s = k_scope.shape
    oa, k = k_tables.shape[4], k_tables.shape[5]
    nvp, c = state.shape[1], state.shape[2]
    dev = state.device
    expect = {
        "k_scope": (k_scope, torch.int32, (n, nc, g, f, s)),
        "k_strides": (k_strides, torch.int32, (n, nc, g, f, s)),
        "k_tables": (k_tables, torch.float32, (n, nc, g, f, oa, k)),
        "k_kmask": (k_kmask, torch.uint8, (n, nc, g, k)),
        "state": (state, torch.int32, (n, nvp, c)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if k > MAX_CARD:
        raise ValueError(f"max card {k} > {MAX_CARD}: not taken by the sweep kernel")
    threads = pick_threads(nvp)
    if threads == 0:
        raise ValueError(f"{nvp} state rows exceed shared memory at 32 threads")
    if cb <= 0 or c <= 0 or n <= 0:
        raise ValueError(f"bad window shape n={n} c={c} cb={cb}")
    counts = (torch.zeros((n, 2, k, nc * g, c), dtype=torch.int32, device=dev)
              if count else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().gibbs_window_launch(
            k_scope.data_ptr(), k_strides.data_ptr(), k_tables.data_ptr(),
            k_kmask.data_ptr(), state.data_ptr(),
            counts.data_ptr() if count else None,
            n, nc, g, f, s, oa, k, nvp, c, _as_int32(seed), int(num_sweeps),
            int(half_point), int(cb), int(bool(count)), threads, stream)
    if err != 0:
        raise RuntimeError(f"gibbs_window_launch failed: CUDA error {err}")
    gibbs_window.launches += 1
    return state, counts


gibbs_window.launches = 0


def _as_int32(x: int) -> int:
    """The seed's low 32 bits as a signed int (the reference's int32 seed)."""
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x
