"""Serving example: a continuous-batching decode loop on a smoke model.

Run:  PYTHONPATH=src python examples_torch/serve_lm.py --arch hymba_1_5b

Submits a handful of prompts, decodes through ``ServeLoop`` with a
fixed slot pool and KV/SSM caches (every projection through B1, the
paged layout's attention through B2), and prints tokens/sec, measured
on the device it names.  Works for every arch with a decode step (all
but hubert_xlarge).  ``--device cpu`` runs the plain versions.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_1_7b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--layout", default="contiguous",
                    choices=("contiguous", "paged"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()
    serve_main(["--arch", args.arch, "--smoke",
                "--requests", str(args.requests),
                "--max-new", str(args.max_new),
                "--temperature", "0.8", "--layout", args.layout]
               + (["--device", args.device] if args.device else []))
