"""Batched decode serving: prefill a prompt batch, then stream tokens
through the serve step, the cache updated in place each token (port of
`examples/serve_decode.py`).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --arch starcoder2-15b --tokens 32
    PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
        --device cpu --reduced

On the card it serves the full configuration with random bf16 weights;
`--device cpu --reduced` serves the reduced variant on the host, as the
reference's example does (its full configuration waits for its dry run).
As the reference's, it serves on the (4, 2) ("data", "model") mesh: 4
client ranks of 2 model shards, each client an equal share of the
requests. This one process holds every cell, and computes each layer
whole (`launch.serve`); spread over processes the cells compute by shard
on their slices of the cache, laid out by the reference's `cache_specs`.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve


def main(argv=None) -> list[int]:
    """Prints ms/token and request 0's ids; returns the ids."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="starcoder2-15b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the configuration's reduced variant")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"serve_decode: {exc} (on the host: --device cpu --reduced)",
              file=sys.stderr)
        raise SystemExit(1) from None
    opts = serve.parse_args(["--arch", args.arch, "--batch", str(args.batch),
                             "--prompt-len", str(args.prompt_len),
                             "--tokens", str(args.tokens)]
                            + (["--reduced"] if args.reduced else []))
    try:
        ms, ids = serve.serve(opts, dev)
    except ValueError as exc:  # a batch the mesh's clients cannot share
        raise SystemExit(f"serve_decode: {exc}") from None
    vocab = get_config(args.arch).vocab
    print(f"arch={args.arch}{' (reduced)' if args.reduced else ''} | "
          f"batch={args.batch} | {ms:.1f} ms/token on {dev.type}")
    print("generated token ids (first request):", ids)
    if not all(0 <= t < vocab for t in ids):
        raise SystemExit("serve_decode: a generated id is out of the vocab")
    print(f"OK: all generated ids in-vocab; cache advanced {args.tokens} "
          "steps")
    return ids


if __name__ == "__main__":
    main()
