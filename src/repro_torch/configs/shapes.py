"""The assigned input shapes (port of `repro.configs.shapes`): each
shape's sequence length, global batch and step kind, which configurations
take it, and the inputs of the step it runs (`input_specs`).

  train_4k     -> the train step (tokens + labels, forward, backward and
                  the paper's aggregation)
  prefill_32k  -> the prefill step (the prompt's forward and its cache)
  decode_32k   -> the serve step (one token over a cache of seq_len)
  long_500k    -> the serve step (one token), sub-quadratic configs only

long_500k's one request is fewer than any mesh's client ranks: every
client serves it whole and its cache splits over the client ranks and the
model shards jointly (`launch.sharding.cache_specs`).

`input_specs` and its helpers (the reference's `:55-94`) give those
inputs as tensors of the reference's shapes and dtypes that hold no
memory: made under a fake mode (`launch.cost_analysis.fake_mode`) or on
the "meta" device, never allocated (the dry run's, `launch.dryrun`).
The token ids are int32, as the reference's.
"""
from __future__ import annotations

import dataclasses

import torch
from torch._guards import active_fake_mode

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_supported(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """(supported, reason): long_500k needs a sub-quadratic decode (a
    recurrent mixer or a sliding window), and the encoder-decoder's
    decoder attends fully over at most 448 positions."""
    if shape.name == "long_500k":
        if not cfg.supports_long_context():
            return False, (
                "full-attention arch: 512k dense KV decode is out of scope "
                "(needs sub-quadratic attention)"
            )
    if cfg.is_encdec and shape.name == "long_500k":
        return False, "whisper decoder is full attention; real context <= 448"
    return True, ""


def _spec(shape, dtype, device) -> torch.Tensor:
    """An empty tensor that holds no memory: on "meta", or under an active
    fake mode on any device."""
    if torch.device(device).type != "meta" and active_fake_mode() is None:
        raise RuntimeError("input specs are made on the meta device or "
                           "under a fake mode (launch.cost_analysis."
                           "fake_mode): they are never allocated")
    return torch.empty(shape, dtype=dtype, device=device)


def _modalities(cfg: ArchConfig, b: int, device) -> dict:
    out = {}
    if cfg.family == "vlm":
        out["patches"] = _spec((b, cfg.vision_patches, cfg.d_model),
                               cfg.dtype, device)
    if cfg.is_encdec:
        out["frames"] = _spec((b, cfg.encoder_seq, cfg.d_model), cfg.dtype,
                              device)
    return out


def train_batch_specs(cfg: ArchConfig, shape: InputShape, *,
                      device="meta", batch: int | None = None) -> dict:
    """The train step's batch: tokens (B, S + 1) and the family's stub
    modalities; `batch` rows in place of the shape's global batch (a
    process's share)."""
    b = shape.global_batch if batch is None else batch
    return {"tokens": _spec((b, shape.seq_len + 1), torch.int32, device),
            **_modalities(cfg, b, device)}


def prefill_batch_specs(cfg: ArchConfig, shape: InputShape, *,
                        device="meta", batch: int | None = None) -> dict:
    """The prefill step's batch: the prompt (B, S) and the modalities."""
    b = shape.global_batch if batch is None else batch
    return {"tokens": _spec((b, shape.seq_len), torch.int32, device),
            **_modalities(cfg, b, device)}


def decode_specs(cfg: ArchConfig, shape: InputShape, *, device="meta",
                 batch: int | None = None, shards=None):
    """(cache, tokens (B, 1), pos ()) of the serve step: the cache as
    `transformer.init_cache` lays it over seq_len slots (with `shards`, a
    process's slice of it)."""
    from repro_torch.models import transformer

    b = shape.global_batch if batch is None else batch
    params = [_spec((1,), cfg.dtype, device)]  # the cache's device
    cache = transformer.init_cache(params, cfg, batch=b,
                                   cache_len=shape.seq_len, shards=shards)
    return (cache, _spec((b, 1), torch.int32, device),
            _spec((), torch.int32, device))


def input_specs(cfg: ArchConfig, shape: InputShape, *, device="meta",
                batch: int | None = None, shards=None) -> dict:
    """The inputs of the step `shape` runs, by name: {"batch"} for train
    and prefill, {"cache", "tokens", "pos"} for decode."""
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, shape, device=device,
                                           batch=batch)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, shape, device=device,
                                             batch=batch)}
    cache, tok, pos = decode_specs(cfg, shape, device=device, batch=batch,
                                   shards=shards)
    return {"cache": cache, "tokens": tok, "pos": pos}
