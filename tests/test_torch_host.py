"""The port's host layers against the JAX package's: import isolation, UAI
I/O, coloring, exact marginals, the error suite and PSRF."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import grample_tpu.metrics as ref_metrics
import grample_tpu.pgm.coloring as ref_coloring
import grample_tpu.pgm.discrete as ref_pgm
import grample_tpu.pgm.exact as ref_exact
import grample_tpu.uai as ref_uai
import grample_tpu.uai.parser as ref_parser
import grample_tpu_torch.metrics as port_metrics
import grample_tpu_torch.pgm.coloring as port_coloring
import grample_tpu_torch.pgm.discrete as port_pgm
import grample_tpu_torch.pgm.exact as port_exact
import grample_tpu_torch.uai as port_uai
import grample_tpu_torch.uai.parser as port_parser

from tests import torch_models
from tests.test_uai import PASCAL_DOC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither JAX nor the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import grample_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'grample_tpu_torch.')]\n"
        "assert len(names) >= 20, names\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'grample_tpu' or m.startswith('grample_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_samplers_reach_the_sweep_through_its_owner():
    """Importing every module of the samplers and of the mesh loads
    neither the kernel's binding (``ops.gibbs_cuda``) nor its layout
    (``ops.layout``) through those modules, and none of them holds a name
    of either: they reach the sweep through ``ops.sweep``, the one owner of
    a group's sweep tensors and of the kernel's facts."""
    code = (
        "import builtins, importlib, importlib.util, pkgutil, sys\n"
        "BAD = ('grample_tpu_torch.ops.gibbs_cuda', 'grample_tpu_torch.ops.layout')\n"
        "OURS = ('grample_tpu_torch.sampler', 'grample_tpu_torch.parallel')\n"
        "seen, real = [], builtins.__import__\n"
        "def hook(name, g=None, l=None, fromlist=(), level=0):\n"
        "    who = (g or {}).get('__name__') or ''\n"
        "    if who.startswith(OURS):\n"
        "        base = importlib.util.resolve_name('.' * level + name, g['__package__']) "
        "if level else name\n"
        "        seen.extend((who, t) for t in [base] + [base + '.' + f for f in fromlist or ()]"
        " if t.startswith(BAD))\n"
        "    return real(name, g, l, fromlist, level)\n"
        "builtins.__import__ = hook\n"
        "names = [m.name for pkg in OURS for m in pkgutil.walk_packages("
        "importlib.import_module(pkg).__path__, pkg + '.')]\n"
        "assert len(names) >= 8, names\n"
        "for n in names: importlib.import_module(n)\n"
        "held = [(n, k) for n in (*OURS, *names) for k, v in vars(sys.modules[n]).items()"
        " if str(getattr(v, '__name__', '')).startswith(BAD)"
        " or getattr(v, '__module__', '') in BAD]\n"
        "assert not seen and not held, (seen, held)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 8


# ---- UAI I/O ----------------------------------------------------------------

def test_parse_pascal_matches_reference():
    a, b = ref_uai.parse_model(PASCAL_DOC), port_uai.parse_model(PASCAL_DOC)
    assert (a.type, a.num_vars) == (b.type, b.num_vars)
    np.testing.assert_array_equal(a.cards, b.cards)
    for fa, fb in zip(a.factors, b.factors, strict=True):
        assert fa.name == fb.name
        np.testing.assert_array_equal(fa.scope, fb.scope)
        np.testing.assert_array_equal(fa.table, fb.table)
    assert b.factors[2].eval_at(b.cards, [1, 0]) == pytest.approx(0.811)
    b.check()


@pytest.mark.parametrize("kind,text", [
    ("model", "x"),
    ("model", "WRONG\n1\n2\n1\n1 0\n2\n0.5 0.5\n"),
    ("model", "MARKOV\n1\n2\n1\n1 0\n3\n0.5 0.5 0.1\n"),
    ("model", "MARKOV\n1\n2\n1\n1 7\n2\n0.5 0.5\n"),
    ("evid", "2\n1 0 1"),
    ("evid", "1 0 5"),
    ("evid", "1 9 0"),
    ("evid", "2 0 1 0 0"),
    ("evid", "1\n1 0 1\n1 0 1"),
    ("mar", "MAR 1 2 1.5 0.5"),
])
def test_parse_errors_match_reference(kind, text):
    """Both parsers refuse the same inputs (``tests/test_uai.py``)."""
    cards = np.array([2, 2, 3])
    for mod, err in ((ref_uai, ref_parser.UAIParseError),
                     (port_uai, port_parser.UAIParseError)):
        with pytest.raises(err):
            if kind == "model":
                mod.parse_model(text)
            elif kind == "evid":
                mod.parse_evidence(text, 3, cards)
            else:
                mod.parse_mar(text)


@pytest.mark.parametrize("text", ["1 2 2", "1\n2 0 1 2 0", "0\n1 0 1", "0"])
def test_evidence_forms_match_reference(text):
    cards = np.array([2, 2, 3])
    assert port_uai.parse_evidence(text, 3, cards) == ref_uai.parse_evidence(text, 3, cards)


def test_mar_parse_matches_reference():
    for text in ("MAR 2 2 0.25 0.75 3 0.2 0.3 0.5",
                 "PR\n-2.33\nMAR\n2 2 0.25 0.75 2 0.5 0.5\n", "MAR 1 2 0.2 0.2"):
        for a, b in zip(ref_uai.parse_mar(text), port_uai.parse_mar(text), strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(torch_models.MODELS))
def test_writer_roundtrip_matches_reference(name):
    ref_m = torch_models.build(ref_pgm, name)
    port_m = torch_models.build(port_pgm, name)
    text = port_uai.write_model(port_m)
    assert text == ref_uai.write_model(ref_m)
    back = port_uai.parse_model(text)
    for f, g in zip(port_m.factors, back.factors, strict=True):
        np.testing.assert_array_equal(f.scope, g.scope)
        np.testing.assert_allclose(f.table, g.table)
    mars = [np.array([0.25, 0.75]), np.array([0.2, 0.3, 0.5])]
    assert port_uai.write_mar(mars) == ref_uai.write_mar(mars)


# ---- coloring, exact marginals -------------------------------------------------

@pytest.mark.parametrize("name", sorted(torch_models.MODELS))
def test_coloring_matches_reference(name):
    m = torch_models.build(port_pgm, name)
    scopes = [f.scope for f in m.factors]
    colors = port_coloring.color_graph(m.num_vars, scopes)
    np.testing.assert_array_equal(colors, ref_coloring.color_graph(m.num_vars, scopes))
    port_coloring.verify_coloring(colors, scopes)
    for cap in (1, 3, 8):
        a = port_coloring.color_groups(colors, m.free_mask, cap)
        b = ref_coloring.color_groups(colors, m.free_mask, cap)
        assert len(a) == len(b)
        for ga, gb in zip(a, b):
            np.testing.assert_array_equal(ga, gb)
    assert (port_coloring.moral_adjacency(m.num_vars, scopes)
            == ref_coloring.moral_adjacency(m.num_vars, scopes))


@pytest.mark.parametrize("name", sorted(torch_models.MODELS))
def test_exact_marginals_match_reference(name):
    a = ref_exact.exact_marginals(torch_models.build(ref_pgm, name))
    b = port_exact.exact_marginals(torch_models.build(port_pgm, name))
    np.testing.assert_array_equal(a, b)


# ---- error suite -------------------------------------------------------------

P = np.array([[0.25, 0.75]])
Q = np.array([[0.5, 0.5]])
CARDS = np.array([2])
HELL_PQ = math.sqrt((0.5 - math.sqrt(0.5)) ** 2 + (math.sqrt(0.75) - math.sqrt(0.5)) ** 2) / math.sqrt(2)
JS_PQ = 0.5 * (
    0.25 * math.log2(0.25 / 0.375) + 0.75 * math.log2(0.75 / 0.625)
    + 0.5 * math.log2(0.5 / 0.375) + 0.5 * math.log2(0.5 / 0.625)
)


def test_divergence_constants():
    """The hand-computed constants of ``tests/test_metrics.py``."""
    assert port_metrics.max_abs_diff(P, Q, CARDS)[0] == pytest.approx(0.25)
    assert port_metrics.mean_abs_diff(P, Q, CARDS)[0] == pytest.approx(0.25)
    assert port_metrics.hellinger(P, Q, CARDS)[0] == pytest.approx(HELL_PQ, abs=1e-12)
    assert port_metrics.js_divergence(P, Q, CARDS)[0] == pytest.approx(JS_PQ, abs=1e-12)
    es = port_metrics.error_suite(np.array([[0.25, 0.75], [0.9, 0.1]]),
                                  np.array([[0.5, 0.5], [0.1, 0.9]]),
                                  np.array([2, 2]), np.array([-1, 1]), None)
    assert es.mean_hellinger == pytest.approx(HELL_PQ, abs=1e-12)
    assert es.max_js == pytest.approx(JS_PQ, abs=1e-12)
    with pytest.raises(ValueError):
        port_metrics.error_suite(P, Q, CARDS, np.array([0]), None)


def test_error_suite_matches_reference():
    rng = np.random.default_rng(5)
    cards = np.array([2, 3, 4, 2, 3])
    p = port_metrics.pad_marginals([rng.random(c) for c in cards], cards)
    q = ref_metrics.pad_marginals([rng.random(c) for c in cards], cards)
    fixed = np.array([-1, -1, 2, -1, -1])
    a = port_metrics.error_suite(p, q, cards, fixed, None).as_dict()
    b = ref_metrics.error_suite(p, q, cards, fixed, None).as_dict()
    assert a == b


# ---- PSRF ------------------------------------------------------------------

@pytest.mark.parametrize("measure", ["hellinger", "js", "maxabs", "meanabs"])
def test_psrf_matches_reference(measure):
    """All four measures against the jitted reference, rtol 1e-5 (float32
    sums over chains in another order), with masked chains and vars."""
    rng = np.random.default_rng(17)
    m, v, k = 48, 7, 3
    cards = np.array([2, 3, 3, 1, 2, 3, 2], dtype=np.int32)
    valid = np.arange(k)[None, None, :] < cards[None, :, None]
    h1 = (rng.integers(0, 40, size=(m, v, k)) * valid).astype(np.float32)
    h2 = (rng.integers(0, 40, size=(m, v, k)) * valid).astype(np.float32)
    merged = (h1 + h2).sum(axis=0) + rng.random((v, k)).astype(np.float32)
    converged = np.array([0, 1, 0, 0, 0, 1, 0], dtype=bool)
    chain_mask = rng.random(m) > 0.25
    want = np.asarray(ref_metrics.chain_convergence(
        jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(merged), jnp.asarray(cards),
        jnp.asarray(converged), jnp.asarray(chain_mask), jnp.float32(40.0),
        measure=measure))
    got = port_metrics.chain_convergence(
        torch.as_tensor(h1.astype(np.int32)), torch.as_tensor(h2.astype(np.int32)),
        torch.as_tensor(merged), torch.as_tensor(cards), torch.as_tensor(converged),
        torch.as_tensor(chain_mask), 40.0, measure=measure).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got[converged] == 1.0).all()
