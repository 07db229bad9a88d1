"""Port of ``src/repro/kernels/``: hand-written Hopper kernels, each with
its plain PyTorch version beside it."""
