"""The assigned input shapes (port of `repro.configs.shapes`:23-49) as
plain data: each shape's sequence length, global batch and step kind, and
which configurations take it. The reference's abstract stand-ins for a
step's inputs (`input_specs` and its helpers) are not ported.

  train_4k     -> the train step (tokens + labels, forward, backward and
                  the paper's aggregation)
  prefill_32k  -> the prefill step (the prompt's forward and its cache)
  decode_32k   -> the serve step (one token over a cache of seq_len)
  long_500k    -> the serve step (one token), sub-quadratic configs only

long_500k's one request is fewer than any mesh's client ranks: every
client serves it whole and its cache splits over the client ranks and the
model shards jointly (`launch.sharding.cache_specs`).
"""
from __future__ import annotations

import dataclasses

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
