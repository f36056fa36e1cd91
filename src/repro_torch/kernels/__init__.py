"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  `common` holds the dispatch rule and the build helper."""
