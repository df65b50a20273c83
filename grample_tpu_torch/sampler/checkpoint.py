"""Checkpoint / resume for chain runs.

Counterpart of ``grample_tpu.sampler.checkpoint``, in the same npz format
(``FORMAT_VERSION`` 1, the same keys and meta fields), so a file written
by either package loads in the other.  A snapshot holds everything a run
needs to continue bit for bit: chain states, split-half windows, count
totals, the step counter (each window's seed is a function of the seed
and the step), the Rao-Blackwell running sums, and the variant models
themselves, serialized structurally (not pickled).

The port writes its int32 window halves as they are; the reference
writes float32 halves holding whole counts.  Both load here
(``convert.chains_from_reference``).

A group sharded over a device mesh (``parallel.mesh``) saves through the
same code, gathered on the host, and a snapshot loads into any group of
the same chain shapes: sharded or not, on any mesh.  A mesh may round
the slot capacity up; the snapshot's tensors are then padded with the
group's own fresh slots.  The port also records the hash lane width
``cb``, which a resumed group adopts where it divides the chains one
launch advances, so that the run continues with the same draws on
another mesh.

Over the ranks of a ``torch.distributed`` run (``parallel.distributed``)
a sharded group's gathers are collectives: every rank calls
``save_checkpoint``, and rank 0 alone writes the file (a group of one
process is written by that process, whatever its rank).  Every rank loads
the same file, so it must be visible to every host; a snapshot written
by N ranks loads like any other, on any mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Tuple

import numpy as np
import torch

from grample_tpu_torch.convert import chains_from_reference
from grample_tpu_torch.parallel import distributed
from grample_tpu_torch.pgm.discrete import DiscreteModel, Factor
from grample_tpu_torch.sampler.chains import MAX_VARIANTS, ChainGroup
from grample_tpu_torch.sampler.split import SplitChainGroup, aux_group_factory

FORMAT_VERSION = 1


def _model_to_dict(m: DiscreteModel) -> dict:
    return {
        "type": m.type,
        "name": m.name,
        "cards": m.cards.tolist(),
        "fixed": m.fixed.tolist(),
        "collapsed": m.collapsed.tolist(),
        "marginals": m.marginals.tolist(),
        "factors": [
            {
                "name": f.name,
                "scope": f.scope.tolist(),
                "table": f.table.tolist(),
                "is_log": f.is_log,
            }
            for f in m.factors
        ],
    }


def _model_from_dict(d: dict) -> DiscreteModel:
    return DiscreteModel(
        type=d["type"],
        name=d["name"],
        cards=np.array(d["cards"], dtype=np.int64),
        fixed=np.array(d["fixed"], dtype=np.int64),
        collapsed=np.array(d["collapsed"], dtype=bool),
        marginals=np.array(d["marginals"], dtype=np.float64),
        factors=[
            Factor(f["name"], np.array(f["scope"]), np.array(f["table"]), f["is_log"])
            for f in d["factors"]
        ],
    )


def read_meta(path: str) -> dict:
    """The snapshot's meta record (shapes, step, totals, variants)."""
    with np.load(path, allow_pickle=False) as data:
        return json.loads(str(data["meta"]))


def snapshot_variants(meta: dict):
    """The variant models a snapshot's meta record holds, in slot order."""
    return [_model_from_dict(mv) for mv in meta["variants"]]


def save_checkpoint(path: str, group, cfg=None, runtime: float = 0.0) -> None:
    """Atomic snapshot (tmp file + rename).

    A :class:`SplitChainGroup` saves its main group at ``path`` (with a
    ``split`` meta marker) and its aux group at ``path + ".aux"``.
    """
    if isinstance(group, SplitChainGroup):
        has_aux = bool(group.aux is not None and group.aux.num_variants)
        if has_aux:
            _save_one(path + ".aux", group.aux, None, 0.0)
        split = {
            "aux": has_aux,
            "aux_cpv": group.aux_cpv,
            "cpv": group.cpv,
            "seed": group.seed,
            "rb_mixture": group.rb_mixture,
            "max_variants": group._max_variants,
        }
        _save_one(path, group.main, cfg, runtime, split=split)
        return
    _save_one(path, group, cfg, runtime)


def _save_one(path: str, group: ChainGroup, cfg=None, runtime: float = 0.0,
              split=None) -> None:
    group.flush()  # fold deferred window deltas into totals first
    meta = {
        "split": split,
        "version": FORMAT_VERSION,
        "cpv": group.cpv,
        "cw": group.cw,
        "cb": group.cb,
        "seed": group.seed,
        "slot_cap": group.slot_cap,
        "step": group._step,
        "total_samples": group.total_samples,
        "total_sweeps": group.total_sweeps,
        "runtime": runtime,
        "variants": [_model_to_dict(m) for m in group.variants],
        "config": None if cfg is None else _cfg_dict(cfg),
    }
    arrays = {
        "state": group.state.cpu().numpy(),
        "halves": group.halves.cpu().numpy(),
        "totals": group.totals,
    }
    # RB mixture running sums (the conditional tables are functions of
    # the base model and re-derived lazily)
    rb_keys = sorted(group._rb_sum)
    if rb_keys:
        arrays["rb_keys"] = np.array(rb_keys, dtype=np.int64)  # [n, 2]
        arrays["rb_sums"] = _padded([group._rb_sum[k] for k in rb_keys])
        arrays["rb_ns"] = np.array([group._rb_n[k] for k in rb_keys], dtype=np.float64)
        arrays["rb_counts"] = np.array(
            [group._rb_count.get(k, 0) for k in rb_keys], dtype=np.int64)
    # plain-slot donor sums (chain-count weighted, keyed by var)
    rbp_keys = sorted(group._rbp_sum)
    if rbp_keys:
        arrays["rbp_vars"] = np.array(rbp_keys, dtype=np.int64)
        arrays["rbp_sums"] = _padded([group._rbp_sum[k] for k in rbp_keys])
        arrays["rbp_ws"] = np.array([group._rbp_w[k] for k in rbp_keys], dtype=np.float64)
        arrays["rbp_snaps"] = np.array([group._rbp_snaps[k] for k in rbp_keys],
                                       dtype=np.int64)
    mesh = getattr(group, "mesh", None)
    if mesh is not None and mesh.ranks is not None and not distributed.is_main():
        return  # the ranks gathered; rank 0 writes
    fd, tmp = tempfile.mkstemp(
        suffix=".npz", dir=os.path.dirname(os.path.abspath(path)) or ".")
    os.close(fd)
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, meta=json.dumps(meta), **arrays)
    os.replace(tmp, path)


def _padded(rows) -> np.ndarray:
    """Ragged float64 rows, zero-padded to one [n, max len] array."""
    out = np.zeros((len(rows), max(r.size for r in rows)), dtype=np.float64)
    for i, r in enumerate(rows):
        out[i, : r.size] = r
    return out


def load_checkpoint(path: str, base_model: DiscreteModel, make_group=None,
                    device="cpu"):
    """Rebuild a chain group on ``device`` from a snapshot.  Returns
    (group, meta).

    ``make_group(model, **kw)`` constructs the group; it must honor the
    snapshot's ``chains_per_variant``/``converge_window``/``seed``
    keywords, which define the tensor shapes being restored.  A split
    snapshot rebuilds a :class:`SplitChainGroup` from ``path`` and
    ``path + ".aux"``; its aux group comes from ``aux_group_factory``,
    as a fresh split group's does, and ``make_group`` is not used.
    """
    meta = read_meta(path)
    sp = meta.get("split")
    if not sp:
        return _load_one(path, base_model, make_group, device)
    main, _ = _load_one(path, base_model, None, device)
    mv = int(sp.get("max_variants", MAX_VARIANTS))
    rb_mixture = sp.get("rb_mixture", True)
    aux = None
    if sp["aux"]:
        aux, _ = _load_one(path + ".aux", base_model,
                           aux_group_factory(mv, rb_mixture=rb_mixture), device)
    group = SplitChainGroup(
        base_model,
        chains_per_variant=sp["cpv"],
        converge_window=main.cw,
        device=device,
        seed=sp["seed"],
        max_variants=mv,
        rb_mixture=rb_mixture,
        aux_chains=sp["aux_cpv"],
        _main=main,
        _aux=aux,
    )
    return group, meta


def _load_one(path: str, base_model: DiscreteModel, make_group,
              device) -> Tuple[ChainGroup, dict]:
    with np.load(path, allow_pickle=False) as npz:
        data = {k: npz[k] for k in npz.files}
    meta = json.loads(str(data["meta"]))
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    kw = dict(
        chains_per_variant=meta["cpv"],
        converge_window=meta["cw"],
        device=device,
        seed=meta.get("seed", 0),
        collapse_headroom=any(any(mv["collapsed"]) for mv in meta["variants"]),
    )
    group = (make_group or ChainGroup)(base_model, **kw)
    if not isinstance(group, ChainGroup):
        # the factory built a wrapper (a SplitChainGroup) that cannot hold
        # a single-stack snapshot: restore it as one group of the same
        # shapes (collapse variants encode dense under headroom caps)
        group = ChainGroup(base_model, **kw)
    if group.cpv != meta["cpv"] or group.cw != meta["cw"]:
        raise ValueError("group factory ignored the checkpoint's shape keywords")
    group.add_variants(snapshot_variants(meta))
    group.reserve(meta.get("slot_cap", 0))
    # staged on the host: the group places its tensors on its device(s)
    state, halves = chains_from_reference(data["state"], data["halves"], "cpu")
    n = state.shape[0]
    if group.slot_cap < n:
        raise ValueError(f"snapshot holds {n} slots, the group {group.slot_cap}")
    if group.slot_cap > n:
        # a mesh rounded the capacity up (reference ``checkpoint.py:229``):
        # the padding slots keep the group's fresh states and empty windows
        state = torch.cat([state, group.state[n:].cpu()])
        halves = torch.cat([halves, halves.new_zeros((group.slot_cap - n, *halves.shape[1:]))])
    group.restore_device_state(state, halves)
    group.totals[:n] = np.asarray(data["totals"], dtype=np.float64)
    if meta.get("cb") and group.local_chains % meta["cb"] == 0:
        group.cb = int(meta["cb"])
    group._step = meta["step"]
    group.total_samples = meta["total_samples"]
    group.total_sweeps = meta["total_sweeps"]
    if "rb_keys" in data:
        counts = (data["rb_counts"] if "rb_counts" in data
                  else np.rint(np.asarray(data["rb_ns"])))  # pre-decay snapshots
        for (slot, var), s, w, cnt in zip(data["rb_keys"], data["rb_sums"],
                                          data["rb_ns"], counts):
            key = (int(slot), int(var))
            group._rb_sum[key] = np.array(s[: int(base_model.cards[int(var)])])
            group._rb_n[key] = float(w)
            group._rb_count[key] = int(cnt)
    if "rbp_vars" in data:
        for var, s, w, cnt in zip(data["rbp_vars"], data["rbp_sums"],
                                  data["rbp_ws"], data["rbp_snaps"]):
            group._rbp_sum[int(var)] = np.array(s[: int(base_model.cards[int(var)])])
            group._rbp_w[int(var)] = float(w)
            group._rbp_snaps[int(var)] = int(cnt)
    return group, meta


def _cfg_dict(cfg) -> dict:
    return dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
