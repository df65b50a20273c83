"""Native (C++) host tier: build + ctypes bindings.

Counterpart of ``grample_tpu.native``.  Two exports (see
``csrc/anchor.cpp``, host code with no CUDA in it):

  - :func:`anchor_gibbs`: the measured single-core baseline sampler, a
    compiled loop that mirrors the reference's
    ``sampler/gibbs-simple.go:163-271`` and is of the same performance
    class as the compiled-Go original; also a correctness oracle, since
    its stationary distribution is the sweep's;
  - :func:`tokenize_f64`: fast whitespace tokenizer used by the UAI
    parser for the numeric tail of large model files (reference
    ``model/reader.go:21-49``).

The shared library is compiled on demand with ``g++ -O2`` into
``grample_tpu_torch/_build/`` (``ops._build.load_host_library``; the
reference builds into its package directory) and rebuilt when the source
changes.  Callers must treat :func:`load` returning ``None`` as "native
tier unavailable" and take their pure Python/numpy path: this is host
code, and no kernel hides behind that.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from grample_tpu_torch.ops import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        lib = _build.load_host_library("anchor.cpp")
        if lib is None:
            _load_failed = True
            return None
        lib.anchor_gibbs.restype = ctypes.c_double
        lib.anchor_gibbs.argtypes = [
            ctypes.c_int32, _I32P, _I32P,
            ctypes.c_int32, ctypes.c_int32,
            _I32P, _I32P, _U8P, _I32P, _I32P, _F32P,
            ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32, _I64P,
        ]
        lib.tokenize_f64.restype = ctypes.c_int64
        lib.tokenize_f64.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _F64P, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def anchor_gibbs(
    model, num_samples: int, seed: int = 1
) -> Optional[Tuple[np.ndarray, float, float]]:
    """Run the native single-core random-scan sampler on ``model``.

    Returns (counts [V, max_card] int64, elapsed_secs, samples_per_sec),
    or None when the native tier is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    from grample_tpu_torch.pgm.encode import encode_model

    enc = encode_model(model)
    la = enc.legacy_arrays()
    v = model.num_vars
    kdim = enc.caps.max_card
    counts = np.zeros((v + 1, kdim), dtype=np.int64)
    elapsed = lib.anchor_gibbs(
        np.int32(v),
        np.ascontiguousarray(la["cards"], np.int32),
        np.ascontiguousarray(la["fixed"], np.int32),
        np.int32(la["adj_offset"].shape[1]),
        np.int32(la["adj_scope_vars"].shape[2]),
        np.ascontiguousarray(la["adj_offset"], np.int32),
        np.ascontiguousarray(la["adj_self_stride"], np.int32),
        np.ascontiguousarray(la["adj_mask"], np.uint8),
        np.ascontiguousarray(la["adj_scope_vars"], np.int32),
        np.ascontiguousarray(la["adj_scope_strides"], np.int32),
        np.ascontiguousarray(la["tables"], np.float32),
        np.int64(num_samples),
        np.uint64(seed),
        np.int32(kdim),
        counts,
    )
    rate = num_samples / max(elapsed, 1e-12)
    return counts[:v], float(elapsed), float(rate)


def tokenize_f64(data: bytes, expect: int) -> Optional[np.ndarray]:
    """Parse up to ``expect`` whitespace-separated floats from ``data``.

    Returns the parsed array (length = actual token count <= expect), or
    None when the native tier is unavailable or the buffer is malformed.
    """
    lib = load()
    if lib is None:
        return None
    out = np.empty(expect, dtype=np.float64)
    n = lib.tokenize_f64(data, np.int64(len(data)), out, np.int64(expect))
    if n < 0:
        return None
    return out[:n]
