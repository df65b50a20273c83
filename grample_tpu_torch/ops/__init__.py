"""The sweep: the Hopper kernel, its plain PyTorch version and layout."""
