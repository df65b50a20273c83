"""UAI competition file format I/O.

Parses the three file kinds the reference understands
(``model/uai.go``): model files (preamble + dense tables), single-sample
evidence files, and MAR solution files (including merlin outputs, whose
PR section before the MAR section is skipped).

Format notes (see http://www.cs.huji.ac.il/project/PASCAL/fileFormat.php):
  - lines that are blank or start with 'c' are comments
  - model: TYPE, var count, cards..., clique count, scopes..., then for
    each factor its table size and entries in row-major order with the
    LAST scope variable least significant
  - evidence: optional sample-count line, then "N idx val idx val ..."
  - MAR: "MAR" token, var count, then per-var "card p0 p1 ..."

Unlike the reference's token-at-a-time FieldReader, parsing here is
vectorized: the numeric tail of a model file is bulk-parsed with
``numpy.fromstring``-style splitting, which matters for the larger UAI
instances and matches the framework's array-first design.  After the
TYPE token a model file is purely numeric, so where the native tier is
built (``grample_tpu_torch.native.tokenize_f64``) one C++ ``strtod`` pass
replaces the per-token Python parse; the portable tokenizer stays behind
it and gives the same results.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from grample_tpu_torch.pgm.discrete import BAYES, MARKOV, DiscreteModel, Factor


class UAIParseError(ValueError):
    pass


def preprocess(text: str, req_prefix: str = "") -> Tuple[str, int]:
    """Drop blank/comment lines; optionally skip to the first line starting
    with ``req_prefix``.  Returns (joined real lines, real line count).

    Mirrors ``uaiPreprocess`` (``model/uai.go:20-50``).
    """
    out: List[str] = []
    started = not req_prefix
    for ln in text.split("\n"):
        ln = ln.strip()
        if not ln or ln[0] == "c":
            continue
        if not started:
            if ln.startswith(req_prefix):
                started = True
            else:
                continue
        out.append(ln)
    return "\n".join(out), len(out)


class _Tokens:
    """Whitespace token cursor (the FieldReader equivalent)."""

    def __init__(self, text: str):
        self.fields = text.split()
        self.pos = 0

    def __len__(self):
        return len(self.fields)

    @property
    def remaining(self) -> int:
        return len(self.fields) - self.pos

    def take(self) -> str:
        if self.pos >= len(self.fields):
            raise UAIParseError("unexpected end of file")
        t = self.fields[self.pos]
        self.pos += 1
        return t

    def take_int(self) -> int:
        t = self.take()
        try:
            return int(t)
        except ValueError as e:
            raise UAIParseError(f"expected int, got {t!r}") from e

    def take_float(self) -> float:
        t = self.take()
        try:
            return float(t)
        except ValueError as e:
            raise UAIParseError(f"expected float, got {t!r}") from e

    def take_floats(self, n: int) -> np.ndarray:
        """Bulk-parse n floats."""
        if self.remaining < n:
            raise UAIParseError(f"expected {n} floats, found {self.remaining}")
        arr = np.array(self.fields[self.pos : self.pos + n], dtype=np.float64)
        self.pos += n
        return arr


class _NumCursor:
    """Token cursor over a pre-parsed numeric array.

    The native fast path: everything after a model file's TYPE token is
    numeric, so one C++ strtod pass (``native.tokenize_f64``) replaces
    per-token Python parsing.  Exposes the same take_* interface as
    :class:`_Tokens`; f64 holds every UAI integer exactly (table sizes
    are capped at 2^23 << 2^53).
    """

    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self.pos = 0

    @property
    def remaining(self) -> int:
        return self.arr.size - self.pos

    def take_float(self) -> float:
        if self.pos >= self.arr.size:
            raise UAIParseError("unexpected end of file")
        v = float(self.arr[self.pos])
        self.pos += 1
        return v

    def take_int(self) -> int:
        v = self.take_float()
        i = int(v)
        if i != v:
            raise UAIParseError(f"expected int, got {v!r}")
        return i

    def take_floats(self, n: int) -> np.ndarray:
        if self.remaining < n:
            raise UAIParseError(f"expected {n} floats, found {self.remaining}")
        out = self.arr[self.pos : self.pos + n].copy()
        self.pos += n
        return out


def parse_model(text: str, native: bool = True) -> DiscreteModel:
    """Parse a UAI model file (reference ``UAIReader.ReadModel``);
    ``native=False`` takes the portable tokenizer only."""
    if len(text) < 15:
        raise UAIParseError(f"invalid data buffer: len={len(text)} (<15)")
    clean, nlines = preprocess(text)
    if nlines < 1:
        raise UAIParseError("no lines found in file")

    # native fast path; any parse failure re-runs the portable path for
    # exact error-message semantics: numpy parsing stays the arbiter
    parts = clean.split(None, 1)
    if native and len(parts) == 2 and parts[0] in (BAYES, MARKOV):
        from grample_tpu_torch.native import tokenize_f64

        raw = parts[1].encode()
        nums = tokenize_f64(raw, len(raw) // 2 + 1)
        if nums is not None and nums.size >= 5:
            try:
                return _parse_model_body(_NumCursor(nums), parts[0])
            except UAIParseError:
                pass

    tok = _Tokens(clean)
    if len(tok) < 6:
        raise UAIParseError(f"invalid data: only {len(tok)} fields found (<6)")

    mtype = tok.take()
    if mtype not in (BAYES, MARKOV):
        raise UAIParseError(f"unknown model type {mtype!r}")
    return _parse_model_body(tok, mtype)


def _parse_model_body(tok, mtype: str) -> DiscreteModel:
    """Preamble + tables from any take_* cursor (_Tokens or _NumCursor)."""
    var_count = tok.take_int()
    if var_count < 1:
        raise UAIParseError(f"invalid variable count: {var_count}")
    cards = np.array([tok.take_int() for _ in range(var_count)], dtype=np.int64)
    if np.any(cards < 1):
        raise UAIParseError("variable with cardinality < 1")

    func_count = tok.take_int()
    if func_count < 1:
        raise UAIParseError(f"invalid clique count: {func_count}")

    scopes: List[np.ndarray] = []
    for fi in range(func_count):
        sz = tok.take_int()
        if sz < 1:
            raise UAIParseError(f"invalid scope size (<1) for clique {fi}")
        scope = np.array([tok.take_int() for _ in range(sz)], dtype=np.int64)
        if np.any(scope < 0) or np.any(scope >= var_count):
            raise UAIParseError(f"invalid var index in clique {fi}")
        scopes.append(scope)

    factors: List[Factor] = []
    for fi, scope in enumerate(scopes):
        tab_size = tok.take_int()
        expect = int(np.prod(cards[scope]))
        if tab_size != expect:
            raise UAIParseError(
                f"factor {fi}: declared table size {tab_size} != scope size {expect}"
            )
        table = tok.take_floats(tab_size)
        factors.append(Factor(name=f"func-{fi}", scope=scope, table=table))

    return DiscreteModel(type=mtype, cards=cards, factors=factors)


def parse_evidence(text: str, num_vars: int, cards: np.ndarray) -> Dict[int, int]:
    """Parse a single-sample UAI evidence file into {var: value}.

    Accepts the 1-line ("N idx val ...") and 2-line ("1\\nN idx val ...")
    forms; a sample count of 0 or a variable count < 1 yields no evidence
    (reference ``UAIReader.ApplyEvidence``, ``model/uai.go:183-249``).
    """
    clean, nlines = preprocess(text)
    if nlines < 1:
        raise UAIParseError("invalid evidence buffer: there is no data")
    if nlines > 2:
        raise UAIParseError(
            f"found {nlines} lines: only 1- or 2-line evidence files supported"
        )
    tok = _Tokens(clean)
    if len(tok) < 1:
        raise UAIParseError("invalid evidence: found no fields")

    if nlines == 2:
        sample_count = tok.take_int()
        if sample_count == 0:
            return {}
        if sample_count > 1:
            raise UAIParseError(
                f"sample count is {sample_count} - only single-sample evidence supported"
            )

    var_count = tok.take_int()
    if var_count < 1:
        return {}

    out: Dict[int, int] = {}
    for i in range(var_count):
        idx = tok.take_int()
        if idx < 0 or idx >= num_vars:
            raise UAIParseError(f"evidence variable index {idx} out of range")
        if idx in out:
            raise UAIParseError(f"variable {idx} appears twice in evidence")
        val = tok.take_int()
        if val < 0 or val >= int(cards[idx]):
            raise UAIParseError(
                f"evidence value {val} invalid for var {idx} (card {int(cards[idx])})"
            )
        out[idx] = val
    return out


def parse_mar(text: str) -> List[np.ndarray]:
    """Parse a MAR solution file into per-variable marginal arrays.

    Skips anything before the "MAR" line (merlin files put a PR section
    first — reference ``model/uai.go:252-332``).  Marginals are validated
    to [0,1] and normalized.
    """
    from grample_tpu_torch.pgm.discrete import norm_marginal

    if len(text) < 11:
        raise UAIParseError(f"invalid data buffer: len={len(text)} (<11)")
    clean, nlines = preprocess(text, req_prefix="MAR")
    if nlines < 1:
        raise UAIParseError("no lines in file")
    tok = _Tokens(clean)
    if len(tok) < 4:
        raise UAIParseError(f"invalid data: only {len(tok)} fields found (<4)")

    sol_type = tok.take()
    if sol_type != "MAR":
        raise UAIParseError(f"unknown solution file type {sol_type!r}")

    var_count = tok.take_int()
    if var_count < 1:
        raise UAIParseError(f"invalid variable count: {var_count}")

    marginals: List[np.ndarray] = []
    for i in range(var_count):
        card = tok.take_int()
        if card < 1:
            raise UAIParseError(f"invalid card {card} for var {i}")
        probs = tok.take_floats(card)
        if np.any(probs < 0.0) or np.any(probs > 1.0):
            raise UAIParseError(f"invalid marginal probability on var {i}")
        marginals.append(norm_marginal(probs, card)[:card])
    return marginals


# ---- file-level helpers ---------------------------------------------------

def read_model_file(path: str) -> DiscreteModel:
    with open(path) as fh:
        m = parse_model(fh.read())
    m.name = os.path.splitext(path)[0]
    m.check()
    return m


def read_evidence_file(path: str, model: DiscreteModel) -> Dict[int, int]:
    with open(path) as fh:
        return parse_evidence(fh.read(), model.num_vars, model.cards)


def read_mar_file(path: str) -> List[np.ndarray]:
    with open(path) as fh:
        return parse_mar(fh.read())


def load_model(path: str, use_evidence: bool = False) -> DiscreteModel:
    """Load a model, optionally applying ``<path>.evid`` evidence, and
    validate — the equivalent of ``model.NewModelFromFile``."""
    m = read_model_file(path)
    if use_evidence:
        ev = read_evidence_file(path + ".evid", m)
        m.apply_evidence(ev)
        m.check()
    return m
