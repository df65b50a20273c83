from grample_tpu_torch.metrics.divergences import (  # noqa: F401
    ErrorSuite,
    error_suite,
    hellinger,
    js_divergence,
    max_abs_diff,
    mean_abs_diff,
    pad_marginals,
)
from grample_tpu_torch.metrics.psrf import chain_convergence  # noqa: F401
