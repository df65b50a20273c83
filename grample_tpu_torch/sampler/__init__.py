from grample_tpu_torch.sampler.chains import ChainGroup  # noqa: F401
