"""Random-reshuffling batcher for production training.

RR is a *data pipeline* property: once per epoch every client permutes its
local dataset and walks it in order. On a pod the "client" is a data-parallel
rank; this sampler produces, per epoch, the permutation matrix that the input
pipeline uses to order host-side batches. It is deliberately host-side
(numpy) — permutations never need to be on device, and keeping them out of
the jit'd step preserves identical lowering between RR and with-replacement
runs (see DESIGN.md §Arch-applicability).

The sampler is STATELESS: `epoch_order(e)` derives its generator by folding
the epoch into the seed (`np.random.default_rng((seed, e))`), so the same
call always returns the same order. That idempotence is what makes the
pipeline resumable from any `(epoch, step)` cursor and is what rules out the
seed-era bug where a mutating RNG handed every micro-batch a fresh
permutation (near-with-replacement sampling in an "RR" run); see
DESIGN.md §3.7.
"""
from __future__ import annotations

import numpy as np


class ReshuffleSampler:
    """Yields per-epoch, per-client batch orders.

    mode:
      'rr'  — fresh independent permutation per client per epoch (Q-RR,
              Q-NASTYA, DIANA-NASTYA in the paper's experiments)
      'rr_once' — single permutation sampled at epoch 0 and reused (Shuffle-
              Once; the paper uses this for DIANA-RR so shift slots stay
              aligned with datapoints)
      'rr_shared' — fresh permutation per epoch, SHARED by every client
              (synchronized reshuffling). This is the production DIANA-RR
              order: the wire's per-slot shift tables need every rank of a
              wire level on the same slot each round (DESIGN.md §3.8), so
              all clients walk their (different) local datasets in the same
              index order.
      'wr'  — with-replacement sampling (QSGD/DIANA/FedAvg baselines)
    """

    def __init__(self, num_clients: int, num_batches: int, *, mode: str = "rr",
                 seed: int = 0):
        if mode not in ("rr", "rr_once", "rr_shared", "wr"):
            raise ValueError(mode)
        self.m = num_clients
        self.n = num_batches
        self.mode = mode
        self.seed = seed

    def _rng(self, epoch: int) -> np.random.Generator:
        # rr_once pins every epoch to the epoch-0 draw (Shuffle-Once): the
        # DIANA-RR shift slot i then always maps to the same datapoint.
        if self.mode == "rr_once":
            epoch = 0
        return np.random.default_rng((self.seed, epoch))

    def epoch_order(self, epoch: int) -> np.ndarray:
        """(M, n) int32 array of batch indices for epoch `epoch`.

        Idempotent: repeated calls with the same epoch return identical
        orders for all three modes.
        """
        rng = self._rng(epoch)
        if self.mode == "wr":
            return rng.integers(0, self.n, size=(self.m, self.n)).astype(np.int32)
        if self.mode == "rr_shared":
            one = rng.permutation(self.n).astype(np.int32)
            return np.broadcast_to(one, (self.m, self.n)).copy()
        return np.stack(
            [rng.permutation(self.n) for _ in range(self.m)]
        ).astype(np.int32)

    def batch_index(self, client: int, global_step: int) -> int:
        """Batch index for `client` at per-client micro-step `global_step`
        (epoch = global_step // n). Convenience for spot checks; the
        pipeline caches whole epochs via `epoch_order`."""
        epoch, i = divmod(global_step, self.n)
        return int(self.epoch_order(epoch)[client, i])

    def spec(self) -> dict:
        """JSON-serializable description (checkpointed next to the cursor so
        a resumed run can verify it is replaying the same stream)."""
        return {"m": self.m, "n": self.n, "mode": self.mode,
                "seed": self.seed}
