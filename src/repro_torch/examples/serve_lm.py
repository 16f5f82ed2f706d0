"""Batched serving example: prefill + sampled decode on any assigned arch
(counterpart of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma2-2b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2-780m --gen 64
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch gemma2-2b --full

Uses the reduced config by default; ``--full`` serves the full-width,
full-depth config (gemma2-2b: 2.6e9 parameters, 5.2 GB in bfloat16) on the
card.  ``--device cpu`` runs on the CPU.
"""
import argparse

from repro_torch.launch import serve as serve_cli


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    argv = ["--arch", args.arch, "--batch", str(args.batch),
            "--prompt-len", str(args.prompt_len), "--gen", str(args.gen),
            "--device", args.device]
    if not args.full:
        argv.append("--smoke")
    serve_cli.main(argv)


if __name__ == "__main__":
    main()
