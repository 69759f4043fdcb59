"""Which leaves of the train state are per client rank and which are whole
(the client-rank part of the reference's `launch/sharding.py`:
`shifts_specs`:91, `podded_specs`:109, `slotted_specs`:124,
`batch_specs`:134).

The reference gives each leaf a PartitionSpec over its mesh. Here the
client ranks may be spread over processes (`launch.distributed`), and a
leaf is either

- per rank ("rank"): its leading rows are the client ranks, and a process
  holds its own (the DIANA shifts; the batch);
- per pod ("pod"): its leading rows are the pods, and a process holds the
  pods it serves (the two-level wire's pod tables, the per-pod mean
  shifts);
- whole (None): the parameters, the optimizer state, the step, the flat
  mean shift and the global pod mean shift, the same bits on every
  process.

`CompressedAggregation.table_units` is the one rule; `init_train_state`
lays the tables out by it and `StateShards` gathers and splits a
checkpoint by it. The model axis's specs (`_leaf_spec`:54,
`param_specs`:79, `zero1_specs`:178) wait for tensor parallelism (ROADMAP
Queue A 7).
"""
from __future__ import annotations

from repro_torch.core.api import tree_leaves

_LEVEL = {"rank": "world", "pod": "outer"}  # the gather that makes a table


def leaf_units(state, agg) -> list[str | None]:
    """Each leaf's unit ("rank", "pod" or None), in the order of
    `tree_leaves(state)`; `agg` bound to the mesh (`steps.configure_agg`)."""
    tables = agg.table_units()._asdict()
    out = []
    for name, sub in zip(state._fields, state):
        out += [tables.get(name)] * len(tree_leaves(sub))
    return out


def local_clients(agg) -> slice:
    """The process's client ranks: the rows of the batch it feeds."""
    return agg.collective.local("rank", agg.num_pods())


class StateShards:
    """A train state spread over processes, as `checkpoint.io` writes and
    reads it: the writer (process 0) writes the reference's file with
    every per-rank and per-pod leaf gathered in rank order, byte for byte
    the stacked run's file; every process takes part in each gather and,
    reading, keeps its own rows of each such leaf."""

    def __init__(self, agg, state_like):
        self.comm = agg.collective
        self.pods = agg.num_pods()
        self.units = leaf_units(state_like, agg)

    @property
    def writes(self) -> bool:
        return self.comm.rank == 0

    def full_shape(self, i: int, shape: list) -> list:
        unit = self.units[i]
        if unit is None:
            return shape
        return [self.comm.units(unit, self.pods, shape[0]), *shape[1:]]

    def gather(self, i: int, leaf):
        unit = self.units[i]
        if unit is None:
            return leaf
        return self.comm.gather(leaf, _LEVEL[unit], self.pods)

    def local(self, i: int, arr):
        unit = self.units[i]
        if unit is None:
            return arr
        return arr[self.comm.local(unit, self.pods)]
