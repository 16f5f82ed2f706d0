"""End-to-end driver: train a ~100M-parameter llama-family model for a few
hundred steps on synthetic data with checkpointing, then analyze its token
embedding space with PaLD (counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 4 \\
        --batch 2 --seq 32 --max-tokens 256 --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_lm --mesh 2x2

Training runs through ``repro_torch.launch.train`` on the card
(``--device cpu``: on the CPU; ``--mesh``: sharded over a local world of
ranks, as the driver's ``--mesh``), then ``python -m
repro_torch.examples.pald_text_analysis --ckpt DIR`` reads the trained
embedding table from the final checkpoint and runs PaLD on its first
``--max-tokens`` rows on the same device.  The checkpoint directory
defaults to one under the system's temporary directory.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile

from repro_torch import configs
from repro_torch.launch import train as train_cli


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="1")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--max-tokens", type=int, default=1024)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    # ~100M params: 12L x d512 (GQA 8/4) x ff2048, 32k vocab, llama-family
    cfg100m = dataclasses.replace(
        configs.get("llama3.2-3b"),
        name="llama-100m",
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=32000, remat="nothing", sharding_profile="dp",
    )
    # register it so the CLI can find it
    configs.REGISTRY["llama-100m"] = cfg100m
    t, _ = cfg100m.param_count()
    print(f"[train_lm] llama-100m: {t/1e6:.1f}M params")

    train_cli.main([
        "--arch", "llama-100m", "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--mesh", args.mesh, "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "100",
        "--log-every", "10", "--device", args.device,
    ])

    print("[train_lm] analyzing the trained embedding table with PaLD...",
          flush=True)
    subprocess.run([
        sys.executable, "-m", "repro_torch.examples.pald_text_analysis",
        "--ckpt", args.ckpt_dir, "--max-tokens", str(args.max_tokens),
        "--device", args.device,
    ], check=True)


if __name__ == "__main__":
    main()
