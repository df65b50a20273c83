"""grample_tpu_torch — the PyTorch and CUDA port of ``grample_tpu``.

Chromatic Gibbs marginal inference for UAI discrete graphical models on
NVIDIA Hopper cards.  The JAX package ``grample_tpu`` is the reference;
this package mirrors its module names so each counterpart is easy to
find, and imports neither JAX nor ``grample_tpu``.

  - ``grample_tpu_torch.uai``      — UAI model, evidence and MAR I/O
  - ``grample_tpu_torch.pgm``      — model core, coloring, dense encoding
  - ``grample_tpu_torch.metrics``  — error suite + PSRF convergence
  - ``grample_tpu_torch.ops``      — the sweep: CUDA kernel + plain version
  - ``grample_tpu_torch.sampler``  — exact collapse, chain runtime (with the
    Rao-Blackwell mixture), the adaptive controller, the split group,
    checkpoints and run orchestration
  - ``grample_tpu_torch.parallel`` — chains sharded over several cards,
    driven by one process
  - ``grample_tpu_torch.native``   — host C++: the single-core anchor
    sampler and the UAI tokenizer
  - ``grample_tpu_torch.tools``    — experiment harness and post-processing
  - ``grample_tpu_torch.cli``      — the ``sample`` (``-s simple``,
    ``-s collapsed``, ``-s adaptive``), ``collapse`` and ``dot`` commands
"""

__version__ = "0.1.0"

from grample_tpu_torch.pgm.discrete import DiscreteModel, Factor  # noqa: F401
