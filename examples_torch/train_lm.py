"""End-to-end driver: train a ~100M-param qwen3-family model for a few
hundred steps with the full production stack (packed synthetic data,
AdamW + cosine, async checkpointing, fault-tolerant executor).

Run:  PYTHONPATH=src python examples_torch/train_lm.py [--steps 200]
      [--device cpu]

This is the same train step the dry-run (``repro_torch.launch.dryrun``)
counts for one rank of the 512-chip mesh; only the mesh and the config
size differ.  Every projection's forward, dgrad and wgrad GEMM runs
through B1 on the card.  Expect the loss to fall from ~ln(V) toward the
entropy of the Zipf unigram stream.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import repro_torch.configs as configs  # noqa: E402
import repro_torch.configs.qwen3_1_7b as q  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402


def build_100m():
    # a ~100M qwen3-family config (same qk_norm/GQA structure)
    return dataclasses.replace(
        get_config("qwen3_1_7b"),
        name="qwen3-100m", n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=4, d_ff=1536, vocab=8192,
        param_dtype="float32", act_dtype="float32",
        attn_q_chunk=128,
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args()

    # register the 100M config under a temporary arch id
    q.SMOKE_100M = build_100m()
    configs.ARCHS.append("qwen3_100m")
    sys.modules["repro_torch.configs.qwen3_100m"] = type(sys)("qwen3_100m")
    sys.modules["repro_torch.configs.qwen3_100m"].CONFIG = q.SMOKE_100M
    sys.modules["repro_torch.configs.qwen3_100m"].SMOKE = q.SMOKE_100M

    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    train_main([
        "--arch", "qwen3_100m", "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--lr", "1e-3", "--ckpt-dir", ckpt, "--ckpt-every", "50",
        "--log-every", "20",
    ] + (["--device", args.device] if args.device else []))
    print(f"checkpoints in {ckpt}")
