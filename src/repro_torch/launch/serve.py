"""Serving driver: batched prefill + decode loop with temperature sampling
(counterpart of ``repro.launch.serve``).

A batch of requests, one prefill, then token-by-token decode against the
KV/SSM caches, in bfloat16 on the card (``--device cpu`` runs it on the
CPU).  Weights are random, drawn from ``--seed``; prompts and sampling
draw from a ``torch.Generator`` seeded with ``--seed`` + 1.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --batch 4 --prompt-len 32 --gen 32          # full width and depth
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --smoke --device cpu                        # the reduced config
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.models.model import (Model, audio_frontend_stub,
                                      cast_floats, vision_frontend_stub)
from repro_torch.train import serve_step


def sample(gen: torch.Generator, logits: torch.Tensor,
           temperature: float) -> torch.Tensor:
    """Greedy at temperature 0, else a draw from softmax(logits / T) (the
    Gumbel-max trick, as ``jax.random.categorical``)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                        dim=-1)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(cfg: ModelConfig, params, gen: torch.Generator, *, batch: int,
             prompt_len: int, gen_len: int, temperature: float):
    """Serve one batch of random prompts (stub embeddings for the audio and
    vlm archs): a prefill, then ``gen_len - 1`` decode steps.

    Returns (tokens (B, gen_len), each step's float32 logits (B, V),
    prefill seconds, decode seconds); both times end in a synchronize.
    """
    dev = params.embed.embedding.device
    model = Model(cfg)
    B, S, G = batch, prompt_len, gen_len
    prefill = serve_step.make_prefill_step(cfg)
    decode = serve_step.make_decode_step(cfg)
    caches = model.init_caches(B, S + G, device=dev)
    if cfg.modality in ("audio", "vlm"):
        stub = (audio_frontend_stub if cfg.modality == "audio"
                else vision_frontend_stub)
        inp = {"embeds": stub(gen, B, S, cfg.d_model, torch.float32, dev)}
    else:
        inp = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                       generator=gen, device=dev)}
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, inp, caches)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    steps = [logits]
    out = [sample(gen, logits, temperature)[:, None]]
    t0 = time.perf_counter()
    for i in range(1, G):
        logits, caches = decode(params, out[-1], caches, S + i - 1)
        steps.append(logits)
        out.append(sample(gen, logits, temperature)[:, None])
    tokens = torch.cat(out, dim=1)
    _sync(dev)
    return tokens, steps, t_prefill, time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from repro_torch.core.engine import resolve_device

    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    params = cast_floats(Model(cfg).init(args.seed, dev), torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B, S, G = args.batch, args.prompt_len, args.gen
    tokens, _, t_prefill, t_decode = generate(
        cfg, params, gen, batch=B, prompt_len=S, gen_len=G,
        temperature=args.temperature)

    print(f"[serve] {cfg.name}: prefill {B}x{S} in {t_prefill*1e3:.1f} ms, "
          f"{G-1} decode steps in {t_decode*1e3:.1f} ms "
          f"({(G-1)*B/max(t_decode,1e-9):,.1f} tok/s)")
    print("[serve] sample generations (token ids):")
    for b in range(min(B, 2)):
        print(f"  req {b}: {tokens[b][:16].tolist()} ...")


if __name__ == "__main__":
    main()
