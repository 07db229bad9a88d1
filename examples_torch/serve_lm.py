"""Serve a reduced LM with batched requests (prefill + decode loop) on the
PyTorch port, the twin of ``examples/serve_lm.py``. Runs on the CUDA card
unless ``--device`` names another device:

    PYTHONPATH=src python examples_torch/serve_lm.py [arch] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="zamba2-1.2b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    extra = ["--device", args.device] if args.device else []
    return serve_main(["--arch", args.arch, "--requests", "4",
                       "--prompt-len", "16", "--gen", "8"] + extra)


if __name__ == "__main__":
    raise SystemExit(main())
