"""Hand-written Hopper kernels, each a ``torch.library`` custom op with a
plain PyTorch version beside it (see ``library.py`` for the build)."""
