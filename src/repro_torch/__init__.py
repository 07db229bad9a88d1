"""PyTorch + CUDA port of the ``repro`` package (cross-silo FL
communication backends), written for one NVIDIA H100.

It mirrors ``src/repro/`` file for file and imports neither JAX nor
``repro``. Entry points run on the CUDA card unless the caller passes
``device="cpu"``. See ROADMAP.md for which slices are ported.
"""
