"""grample_tpu_torch — the PyTorch and CUDA port of ``grample_tpu``.

Chromatic Gibbs marginal inference for UAI discrete graphical models on
one NVIDIA Hopper card.  The JAX package ``grample_tpu`` is the reference;
this package mirrors its module names so each counterpart is easy to
find, and imports neither JAX nor ``grample_tpu``.

  - ``grample_tpu_torch.uai``      — UAI model, evidence and MAR I/O
  - ``grample_tpu_torch.pgm``      — model core, coloring, dense encoding
  - ``grample_tpu_torch.metrics``  — error suite + PSRF convergence
  - ``grample_tpu_torch.ops``      — the sweep: CUDA kernel + plain version
  - ``grample_tpu_torch.sampler``  — exact collapse, chain runtime (with the
    Rao-Blackwell mixture), the adaptive controller, the split group,
    checkpoints and run orchestration
  - ``grample_tpu_torch.cli``      — the ``sample`` (``-s simple``,
    ``-s collapsed``, ``-s adaptive``) and ``collapse`` commands
"""

__version__ = "0.1.0"

from grample_tpu_torch.pgm.discrete import DiscreteModel, Factor  # noqa: F401
