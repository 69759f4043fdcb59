"""Serving front end: prefill a request batch, then decode token by token
(port of `repro.launch.serve`).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced

By default the full configuration runs on the card, with random bf16
weights from `--seed`; without a card that exits non-zero and says why
(there is no fallback to the host). `--device cpu --reduced` runs the
reference's reduced variant of the configuration on the host.

The prompt tokens (and the VLM's patch and the encoder-decoder's frame
embeddings, the stubs of their encoders) are drawn from a generator
seeded by `--seed`. Sampling follows the reference: greedy argmax over the
true vocab at temperature 0, else a categorical draw at the temperature
from a generator seeded by `--seed`. Prints the ms per decoded token (host
clock, synchronised) and request 0's token ids.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.launch import steps
from repro_torch.models import transformer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="stablelm-1.6b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card exits "
                         "non-zero")
    ap.add_argument("--reduced", action="store_true",
                    help="the configuration's reduced variant (2 layers, "
                         "d_model 128), as the CPU tests run it")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample(logits, cfg, temperature: float, gen: torch.Generator):
    """(B, 1, Vp) logits -> (B, 1) int64 ids over the true vocab."""
    lg = logits[:, -1, :cfg.vocab].float()
    if temperature <= 0:
        return torch.argmax(lg, dim=-1, keepdim=True)
    return torch.multinomial(torch.softmax(lg / temperature, dim=-1), 1,
                             generator=gen)


def serve(args, dev: torch.device) -> tuple[float, list[int]]:
    """Runs the request batch on `dev`; returns (ms per decoded token,
    request 0's ids: the prompt's next token and each decoded one)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, seq=max(64, 2 * args.prompt_len))
    if args.prompt_len < cfg.vision_patches:
        raise ValueError(f"--prompt-len {args.prompt_len} must cover the "
                         f"{cfg.vision_patches} patch positions of {cfg.name}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = transformer.init_params(gen, cfg, dev)
    cache_len = args.prompt_len + args.tokens + 8
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=dev)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(
            args.batch, cfg.vision_patches, cfg.d_model, generator=gen,
            device=dev).to(cfg.dtype)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            args.batch, cfg.encoder_seq, cfg.d_model, generator=gen,
            device=dev).to(cfg.dtype)
    prefill = steps.make_prefill_step(cfg, cache_len=cache_len)
    step = steps.make_serve_step(cfg)
    logits, cache = prefill(params, batch)
    tok = sample(logits, cfg, args.temperature, gen)
    out = [tok]
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(args.tokens):
        logits, cache = step(params, cache, tok, args.prompt_len + i)
        tok = sample(logits, cfg, args.temperature, gen)
        out.append(tok)
    _sync(dev)
    ms = (time.perf_counter() - t0) / max(args.tokens, 1) * 1e3
    return ms, torch.cat(out, dim=1)[0].tolist()


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:  # no card, and the host was not asked for
        print(f"serve: {exc} (on the host: --device cpu)", file=sys.stderr)
        return 1
    ms, ids = serve(args, dev)
    name = args.arch + (" (reduced)" if args.reduced else "")
    print(f"arch={name} device={args.device} batch={args.batch} | "
          f"{ms:.1f} ms/token")
    print("request 0 token ids:", ids)
    return 0


if __name__ == "__main__":
    sys.exit(main())
