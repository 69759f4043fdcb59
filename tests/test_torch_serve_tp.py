"""Serving over the mesh (`repro_torch.launch.sharding.cache_specs`,
`zero1_specs`, `serve_model_bytes`; `models.transformer.prefill` and
`decode_step` with `ms=`; `launch.steps.make_prefill_step` /
`make_serve_step` on a mesh; `launch.serve`) against the JAX reference
and against the port's one-process run.

- The specs: `cache_specs` and `zero1_specs` of the ten configs at the
  (4, 2), (16, 16) and (2, 16, 16) meshes, on abstract caches of the
  front end's shape (B 8, cache 168), decode_32k's (128, 32,768) and
  long_500k's (1, 524,288), equal the reference's PartitionSpecs read as
  data (the reference's on a stand-in mesh object with `.shape`, its
  caches from `jax.eval_shape`): exact.
- A config of each family, reduced, on the (4, 2) mesh, its layers and cache
  by shard in one process (each client's rows on their own), against the
  reference's `prefill` and `decode_step` over the whole batch, at f32
  from the same parameters and inputs (made with numpy from a seed):
  prefill and 4 teacher-forced tokens, the logits and every cache leaf
  per layer within `tests/test_torch_serving.py`'s bounds (1e-2 of the
  layer's largest entry; layer 0's k and v to the f32 projection's
  bound, `_torch_harness.layer0_kv_bounds`; MoE routing
  margins above 1e-4). The shards' partial softmaxes round their
  unnormalised probabilities to bf16 where the reference rounds the
  normalised ones, which that bound covers.
- Each split case against the reference the same way: an attention
  cache split on its slots and one on head_dim, both ring buffers
  wrapped under their windows; rwkv6's state on its heads (8 heads of 8)
  and on its key dim (the reduced config, in the case above); hymba's
  SSD state on head_dim with hymba-1.5b's odd splits (5 heads, its norms
  split on head_dim, wdt whole); whisper's cross cache on its slots (48
  frames; the reduced config's 24 put it on head_dim, above).
- A batch the client ranks cannot share (B = 1 and B = 6 on (4, 2), and
  B = 1 on (2, 2, 2)): every client serves it whole and each cache leaf
  splits over the clients and the model shards jointly where it divides
  (`cache_specs`' long_500k case): every family, the slots and head_dim
  of the attention caches, rwkv6's state on its key dim and on its heads
  (whose parts do not line up with the shards' columns), hymba's ring
  and SSD state, whisper's cross cache jointly beside a self cache split
  over "model" alone, starcoder2's and hymba's rings decoding past their
  wrapped windows. Held to the reference's prefill and decode_step as
  above (the B = 1 runs read the first request of the reference's B = 6
  run, one compile for both); at B = 1 every process's slice of the
  cache at W = 2, 4 and 8 (`transformer.cache_slice`) is held to the
  reference's cache sliced by its own `cache_specs` for that process's
  devices (JAX's index map of the reference's PartitionSpecs).
- A mesh of one model shard is the whole-layer path, bitwise.
- Spread over W = 2, 4 and 8 gloo processes (spawned once, joined
  through a file, one intra-op thread each, started with the module so
  they run beside the reference's compiles): every process's greedy
  tokens, logits and cache slice (its rows and shards, or its joint
  parts) are the one-process run's bits, its bytes to its model group
  equal `serve_model_bytes` for the prefill and for each token (none
  where the model axis does not spread) and to the joint group
  `serve_joint_bytes` a token. The front end under torchrun's
  environment samples at temperature 0.7 over 4 processes and prints the
  ids of the same mesh by shard in one process.
- The front end: the reference's (4, 2) mesh by default, each layer
  whole where one process holds every cell, any --batch (1, 2 and 6
  served with the ids of the same mesh by shard); the production mesh
  sized on the meta device, exit 2 naming the bytes where a process
  does not fit; NCCL on the host and a mesh of one model shard over
  processes refused.
"""
import dataclasses
import io
import os
import queue
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.launch import sharding as jax_sharding
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.api import tree_leaves, tree_paths
from repro_torch.launch import distributed, serve, sharding, steps
from repro_torch.launch.mesh import make_mesh, make_production_mesh, num_pods
from repro_torch.models import moe as tmoe
from repro_torch.models import tp
from repro_torch.models import transformer as tt

import _torch_harness as harness

# a config of each family (dbrx-132b's layers are qwen2-moe's, and
# starcoder2-15b's windowed caches are SPLIT_CASES' rings); the MoE routing
# margin of tests/test_torch_serving.py
FAMILIES = ["stablelm-1.6b", "qwen2-moe-a2.7b", "rwkv6-7b", "hymba-1.5b",
            "qwen2-vl-2b", "whisper-medium"]
MARGIN = 1e-4
PROMPT, TOKENS, CACHE_LEN = 16, 4, 36
SHAPES = {"front end": (8, 168), "decode_32k": (128, 32768),
          "long_500k": (1, 524288)}
MESHES = {"4x2": (4, 2), "16x16": (16, 16), "2x16x16": (2, 16, 16)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from harness.one_intra_op_thread()


def _mesh(shape):
    axes = ("pod", "data", "model")[-len(shape):]
    return make_mesh(shape, axes)


def _stand_in(shape):
    """The reference's mesh as its specs read it: `.shape` and the names."""
    axes = ("pod", "data", "model")[-len(shape):]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


# -- the specs, as data -------------------------------------------------------------

def _reference_cache_spec(spec, client_axes):
    """A reference PartitionSpec of a cache leaf as `sharding.CacheSpec`."""
    entries = list(spec)
    # PartitionSpec keeps one axis name bare: ("data",) reads "data"
    bare = (client_axes[0],) if len(client_axes) == 1 else ()
    batch = len(entries) > 1 and entries[1] in (client_axes, *bare)
    axis, joint = None, False
    for i, e in enumerate(entries):
        if e == "model":
            axis = i
        elif isinstance(e, tuple) and "model" in e:
            axis, joint = i, True
    return sharding.CacheSpec(batch, axis, joint)


@pytest.mark.parametrize("name", JAX_ARCH_NAMES)
def test_cache_specs_match_reference(name):
    """Every cache leaf's layout at the three meshes and three shapes."""
    params = tt.init_params(0, get_config(name), "meta")
    abstract = {s: jax.eval_shape(lambda: jt.init_cache(
        None, jax_get_config(name), batch=b, cache_len=c))
        for s, (b, c) in SHAPES.items()}
    for mname, shape in MESHES.items():
        mesh = _mesh(shape)
        client_axes = tuple(a for a in mesh.axis_names if a != "model")
        m = int(np.prod(shape[:-1]))
        for sname, (b, cache_len) in SHAPES.items():
            want_abs = abstract[sname]
            want = [_reference_cache_spec(s, client_axes) for s in
                    jax.tree.leaves(
                        jax_sharding.cache_specs(
                            want_abs, client_axes, mesh=_stand_in(shape),
                            n_clients=m),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))]
            got = sharding.cache_specs(
                tt.init_cache(params, get_config(name), batch=b,
                              cache_len=cache_len),
                mesh=mesh, n_clients=m)
            assert got == want, (name, mname, sname, got, want)


def _reference_zero1(spec, client_axes):
    entries = list(spec)
    model = next((i for i, e in enumerate(entries) if e == "model"), None)
    clients = next((i for i, e in enumerate(entries)
                    if e in (client_axes, client_axes[0])
                    and e != "model"), None)
    return sharding.Zero1Spec(model, clients)


@pytest.mark.parametrize("name", JAX_ARCH_NAMES)
def test_zero1_specs_match_reference(name):
    """Each leaf's model axis and client axis, at the three meshes and at
    the reference's default (no mesh: 16 clients of 16 shards)."""
    params = tt.init_params(0, get_config(name), "meta")
    abstract = jax.eval_shape(lambda: jt.init_params(jax.random.key(0),
                                                     jax_get_config(name)))
    for shape in (*MESHES.values(), None):
        if shape is None:
            client_axes, stand_in, mesh = ("data",), None, None
        else:
            mesh = _mesh(shape)
            client_axes = tuple(a for a in mesh.axis_names if a != "model")
            stand_in = _stand_in(shape)
        want = [_reference_zero1(s, client_axes) for s in jax.tree.leaves(
            jax_sharding.zero1_specs(abstract, client_axes, mesh=stand_in),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
        got = sharding.zero1_specs(params, mesh=mesh)
        assert list(got) == tree_paths(params)
        assert list(got.values()) == want, (name, shape)


def test_zero1_never_splits_a_layer_axis():
    """The reference's claim (tests/test_sharding.py): a block's stacked
    layer axis is never split; the clients land on axis 1."""
    params = {"blocks": {"ln1": {"scale": torch.empty(
        (96, 8192), device="meta")}}}
    got = sharding.zero1_specs(params, mesh=make_mesh((16, 16)))
    assert got == {"blocks/ln1/scale": sharding.Zero1Spec(None, 1)}


# -- by shard against the reference --------------------------------------------------

@pytest.fixture
def margins(monkeypatch):
    """Each MoE routing call's smallest gap between a token's k-th and
    (k+1)-th probability, while the test runs."""
    seen = []
    route = tmoe._route

    def recording(p, x, cfg):
        out = route(p, x, cfg)
        top = torch.sort(out[0], dim=-1, descending=True).values
        k = cfg.experts_per_token
        seen.append(float((top[..., k - 1] - top[..., k]).min()))
        return out

    monkeypatch.setattr(tmoe, "_route", recording)
    return seen


def _pair(name, seq=32, **changes):
    """(reference config, port config) at f32, the reduced config of
    `name` with `changes`."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(name), seq=seq),
                               dtype=jnp.float32, **changes)
    tcfg = dataclasses.replace(reduced(get_config(name), seq=seq),
                               dtype=torch.float32, **changes)
    return jcfg, tcfg


def _batch(cfg, b, n, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


# the reference's runs, shared by the cases that read them (a batch the
# clients do not share reads the first rows of a wider batch's run)
_REFERENCE = {}


def _reference_run(jcfg, prompt, n_tokens, cache_len, b, seed):
    """The reference's parameters, the inputs (made with numpy from
    `seed`), and its prefill (logits, cache) and each teacher-forced
    token's logits and the final cache, for `b` requests."""
    key = (repr(jcfg), prompt, n_tokens, cache_len, b, seed)
    if key not in _REFERENCE:
        jp = jt.init_params(jax.random.key(0), jcfg)
        inputs = _batch(jcfg, b, prompt + n_tokens, seed)
        jl_, jc = jax.jit(lambda p, b_: jt.prefill(p, b_, jcfg,
                                                  cache_len=cache_len))(
            jp, harness.prompt(inputs, prompt, "jax"))
        prefill = (np.asarray(jl_), jax.device_get(jc))
        jdecode = jax.jit(lambda p, c, t, pos: jt.decode_step(p, c, t, pos,
                                                              jcfg))
        toks, logits = inputs["tokens"], []
        for i in range(prompt, prompt + n_tokens):
            jl_, jc = jdecode(jp, jc, jnp.asarray(toks[:, i:i + 1]),
                              jnp.int32(i))
            logits.append(np.asarray(jl_))
        _REFERENCE[key] = (jax.device_get(jp), inputs, prefill, logits,
                           jax.device_get(jc))
    return _REFERENCE[key]


def _rows_of(run, b):
    """A reference run's first b requests (the cache's axis 1)."""
    jp, inputs, (pl, pc), logits, jc = run

    def rows(tree):
        return jax.tree.map(lambda x: x[:, :b], tree)

    return (jp, {k: v[:b] for k, v in inputs.items()}, (pl[:b], rows(pc)),
            [x[:b] for x in logits], rows(jc))


def _by_shard_against_reference(jcfg, tcfg, shape, prompt, n_tokens,
                                cache_len, margins, *, b=8, seed=5,
                                axes=None, ref_rows=None):
    """The port's serve steps on `shape` by shard in one process against
    the reference's prefill and decode_step: prefill `prompt` tokens,
    decode `n_tokens` teacher-forced; returns the worst relative errors
    (logits, cache) and the port's final cache. `ref_rows`: the
    reference's run of that many requests, whose first b are these."""
    run = _reference_run(jcfg, prompt, n_tokens, cache_len, ref_rows or b,
                         seed)
    jp, inputs, (jl_, jc), jlogits, jc_end = _rows_of(run, b)
    params = convert.params_from_jax(jp, "cpu")
    mesh = _mesh(shape)
    prefill = steps.make_prefill_step(tcfg, mesh, cache_len=cache_len)
    step = steps.make_serve_step(tcfg, mesh, cache_len=cache_len)
    tl_, tc = prefill(params, harness.prompt(inputs, prompt, "torch"))
    if axes is not None:
        got = step.layouts[b].cache_axes
        assert got == axes, (got, axes)
    v = tcfg.vocab
    w_logit = harness.close(tl_[..., :v], jl_[..., :v], "prefill logits")
    writes = [(p, p) for p in range(prompt)]
    w_cache = harness.close_cache(
        tc, jc, "prefill cache",
        harness.layer0_kv_bounds(tcfg, params, inputs, writes, tc))
    toks = inputs["tokens"]
    for n, i in enumerate(range(prompt, prompt + n_tokens)):
        tl_, tc = step(params, tc, torch.from_numpy(toks[:, i:i + 1]).long(),
                       i)
        writes.append((i, i))
        w_logit = max(w_logit, harness.close(
            tl_[..., :v], jlogits[n][..., :v], f"decode {i} logits"))
    w_cache = max(w_cache, harness.close_cache(
        tc, jc_end, "decode cache",
        harness.layer0_kv_bounds(tcfg, params, inputs, writes, tc)))
    if tcfg.num_experts:
        assert min(margins) > MARGIN, margins
    return w_logit, w_cache, tc


@pytest.mark.parametrize("name", FAMILIES)
def test_by_shard_on_the_reference_mesh_matches_reference(name, margins):
    """Each family's reduced config on (4, 2): 8 requests, 2 a client, its
    layers and cache on the 2 model shards."""
    jcfg, tcfg = _pair(name)
    w_logit, w_cache, _ = _by_shard_against_reference(
        jcfg, tcfg, (4, 2), PROMPT, TOKENS, CACHE_LEN, margins)
    print(f"{name} on (4, 2) by shard: worst logits error {w_logit:.2e}, "
          f"cache {w_cache:.2e} of the largest entry")


# (reference and port config changes, seq, mesh, prompt, tokens, cache_len,
# the split axes of the cache leaves in tree_flatten order)
SPLIT_CASES = {
    # slots: a window of 32 over 32 slots (ties head_dim 32: the slots
    # win), the prompt past the window and the ring wrapped again
    "attention-slots-ring": ("starcoder2-15b", {}, 64, (2, 2), 48, 24, 80,
                             (2, 2)),
    # head_dim: 16 slots under the window, narrower than head_dim 32
    "attention-head_dim-ring": ("starcoder2-15b", {}, 32, (2, 2), 24, 20,
                                40, (4, 4)),
    # rwkv6's state (8 heads of 8 x 8) on its heads, x_prev on d_model
    "rwkv6-heads": ("rwkv6-7b", {"num_heads": 8, "d_model": 64,
                                 "head_dim": 8}, 32, (2, 2), 16, 4, 24,
                    (2, 2)),
    # hymba-1.5b's splits at T = 2: 5 heads, norms on head_dim, wdt whole
    "hymba-head_dim-odd": ("hymba-1.5b", {"num_heads": 5, "num_kv_heads": 1,
                                          "head_dim": 16, "d_model": 80,
                                          "ssm_heads": 5}, 32, (2, 2), 16, 4,
                           24, (2, 2, 4)),
    # whisper's cross cache on its slots: 48 frames, wider than head_dim
    # (the reduced config's 24 frames put it on head_dim, above)
    "whisper-cross-slots": ("whisper-medium", {"encoder_seq": 48}, 32,
                            (2, 2), 16, 4, 36, (2, 2, 2, 2)),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_case_matches_reference(case, margins):
    name, changes, seq, shape, prompt, n, cache_len, axes = SPLIT_CASES[case]
    jcfg, tcfg = _pair(name, seq, **changes)
    w_logit, w_cache, _ = _by_shard_against_reference(
        jcfg, tcfg, shape, prompt, n, cache_len, margins, b=4, seed=6,
        axes=axes)
    print(f"{case}: worst logits error {w_logit:.2e}, cache {w_cache:.2e}")


# A batch the client ranks cannot share (B = 1 < 4, or 6 over 4): the
# batch whole on every client, each cache leaf split over the clients and
# the model shards jointly where its widest axis divides by 8, else over
# "model" alone. (reference and port config changes, seq, mesh, prompt,
# tokens, cache_len, each leaf's (split axis of the leaf with its layer axis,
# joint) in tree_flatten order)
RWKV6_HEADS = {"num_heads": 8, "d_model": 64, "head_dim": 8}
JOINT_CASES = {
    # the slots joint (40 of 8 parts)
    "stablelm-slots": ("stablelm-1.6b", {}, 32, (4, 2), PROMPT, TOKENS, 40,
                       ((2, True),) * 2),
    # 36 slots do not divide by 8: "model" alone, the batch whole
    "qwen2-moe-model-alone": ("qwen2-moe-a2.7b", {}, 32, (4, 2), PROMPT,
                              TOKENS, CACHE_LEN, ((2, False),) * 2),
    "qwen2-vl-slots": ("qwen2-vl-2b", {}, 32, (4, 2), PROMPT, TOKENS, 40,
                       ((2, True),) * 2),
    # the state on its key dim (32 of 8 parts), x_prev on d_model
    "rwkv6-key-dim": ("rwkv6-7b", {}, 32, (4, 2), PROMPT, TOKENS, CACHE_LEN,
                      ((3, True), (2, True))),
    # the state on its heads: 8 heads of 8, a head a part (rwkv6-7b's 64
    # heads at long_500k, 8 a part); x_prev joint
    "rwkv6-heads": ("rwkv6-7b", RWKV6_HEADS, 32, (4, 2), PROMPT, TOKENS, 24,
                    ((2, True), (2, True))),
    # the ring (16 slots, wrapped by the decode) and the SSD state on
    # head_dim jointly
    "hymba-head_dim-ring": ("hymba-1.5b", {}, 32, (4, 2), PROMPT, TOKENS,
                            CACHE_LEN, ((4, True),) * 3),
    # the ring's slots jointly (32 of 8 parts: hymba-1.5b's 1024 at
    # long_500k), the prompt past the window and the ring wrapped again
    "hymba-slots-ring": ("hymba-1.5b", {}, 64, (4, 2), 48, 24, 80,
                         ((2, True), (2, True), (4, True))),
    # the cross cache on head_dim jointly, the self cache "model" alone
    "whisper-cross-joint": ("whisper-medium", {}, 32, (4, 2), PROMPT, TOKENS,
                            CACHE_LEN, ((4, True),) * 2 + ((2, False),) * 2),
    # starcoder2-15b's ring on its slots jointly (its 4096 at long_500k),
    # decoding past the wrapped window
    "starcoder2-slots-ring": ("starcoder2-15b", {}, 64, (4, 2), 48, 24, 80,
                              ((2, True),) * 2),
    # two pods of two clients: 8 parts over (pod, data, model)
    "stablelm-slots-2x2x2": ("stablelm-1.6b", {}, 32, (2, 2, 2), PROMPT,
                             TOKENS, 40, ((2, True),) * 2),
}
JOINT_BATCHES = (1, 6)
# the processes whose slices of the cache the reference's layout is held
# to (W = 2, 4, 8 over the 8 cells)
JOINT_WORLDS = (2, 4, 8)


def _joint_ids():
    return [f"{c}-B{b}" for c in JOINT_CASES for b in JOINT_BATCHES
            if not (c.endswith("2x2x2") and b != 1)]


@pytest.mark.parametrize("case", _joint_ids())
def test_joint_split_matches_reference(case, margins):
    """Prefill and teacher-forced decode by shard in one process, on a
    batch whose rows every client serves, against the reference's prefill
    and decode_step (the B = 1 runs read the first row of the reference's
    B = 6 run) at tests/test_torch_serving.py's bounds; each leaf's split
    is the reference's cache_specs' (tests above); at B = 1, every
    process's slice of the cache at W = 2, 4 and 8 is the reference's
    cache sliced by its own cache_specs for that process's devices."""
    _joint_case(case, margins, 5)


@pytest.mark.parametrize("case", _joint_ids())
def test_joint_split_matches_reference_at_seed_11(case, margins):
    """The joint cases from seed 11's inputs, the seed at which layer 0's
    k of starcoder2's ring once lay past rtol 1e-5 of the reference's (an
    f32 projection's rounding, the same on the whole-layer path): held to
    the same bounds, layer 0's k and v to `layer0_kv_bounds`."""
    _joint_case(case, margins, 11)


def _joint_case(case, margins, seed):
    name, b = case.rsplit("-B", 1)
    b = int(b)
    arch, changes, seq, shape, prompt, n, cache_len, layout = \
        JOINT_CASES[name]
    jcfg, tcfg = _pair(arch, seq, **changes)
    w_logit, w_cache, cache = _by_shard_against_reference(
        jcfg, tcfg, shape, prompt, n, cache_len, margins, b=b, seed=seed,
        axes=tuple(a for a, _ in layout), ref_rows=max(JOINT_BATCHES))
    ms = steps.make_serve_step(tcfg, _mesh(shape),
                               cache_len=cache_len).layouts[b]
    assert ms.cache_joint == tuple(j for _, j in layout), ms.cache_joint
    print(f"{case}: worst logits error {w_logit:.2e}, cache {w_cache:.2e}")
    if b != 1:
        return
    jc = _rows_of(_reference_run(jcfg, prompt, n, cache_len,
                                 max(JOINT_BATCHES), seed), 1)[-1]
    for world in JOINT_WORLDS:
        for rank in range(world):
            _hold_slice_to_reference(tcfg, cache, jc, shape, cache_len,
                                     world, rank)


class _Stacked:
    """A collective whose gather hands back a fixed stack, counting the
    bytes handed over."""

    def __init__(self, stack):
        self.stack, self.bytes_sent = stack, {}

    def gather(self, x, level, pods, *, key=None, to_first=False):
        self.bytes_sent[key] = x.numel() * x.element_size()
        return self.stack


def test_joint_parts_in_part_order():
    """Parts held wherever a process's cells fall (client rank c's shard
    j is part c T + j): a process holding clients 0-1 and shard 0 of T = 2
    holds parts 0 and 2 of 4, cut from the whole leaf in part order, and a
    gather stacked in the processes' order (0, 2, then 1, 3) comes back in
    part order."""
    x = torch.arange(24.).reshape(3, 8)
    mine = tp.Parts(4, (0, 2), pods=1, level="joint")
    assert torch.equal(mine.take(x, 1),
                       torch.cat([x[:, 0:2], x[:, 4:6]], 1))
    whole = torch.stack(list(x.unflatten(1, (4, 2)).unbind(1)))
    comm = _Stacked(whole[[0, 2, 1, 3]])
    mine = tp.Parts(4, (0, 2), comm, 1, "joint", order=(0, 2, 1, 3))
    assert torch.equal(mine.gather(mine.take(x, 1).unflatten(1, (2, 2))
                                   .movedim(1, 0)), whole)
    assert comm.bytes_sent == {"joint": 2 * 3 * 2 * 4}
    assert torch.equal(mine.sum(whole[[0, 2]]), whole.sum(0))


def _hold_slice_to_reference(cfg, cache, jc, shape, cache_len, world, rank):
    """Process `rank` of `world`'s slice of the port's one-process cache
    (`transformer.cache_slice` of its `serve_shards`) against the
    reference's cache over that process's devices: the box their shards
    cover under the reference's `cache_specs` (JAX's own index map)."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_test_mesh

    axes = ("pod", "data", "model")[-len(shape):]
    mesh = make_test_mesh(shape, axes)
    m, t = int(np.prod(shape[:-1])), shape[-1]
    b = tree_leaves(cache)[0].shape[1]
    comm = distributed.ProcessGroupCollective(m, t, world=world, rank=rank)
    ms = steps.serve_shards(cfg, _mesh(shape), cache_len, comm, batch=b)
    mine = tree_leaves(tt.cache_slice(cache, ms))
    specs = jax.tree.leaves(
        jax_sharding.cache_specs(jc, axes[:-1], mesh=mesh, n_clients=m),
        is_leaf=lambda x: isinstance(x, P))
    cells = mesh.devices.reshape(-1)
    per = cells.size // world
    own = cells[rank * per:(rank + 1) * per]
    for got, want, spec in zip(mine, jax.tree.leaves(jc), specs):
        index = NamedSharding(mesh, spec).devices_indices_map(want.shape)
        box = tuple(slice(min(index[d][k].start or 0 for d in own),
                          max(index[d][k].stop or want.shape[k]
                              for d in own))
                    for k in range(want.ndim))
        want = np.asarray(want)[box]
        assert tuple(got.shape) == want.shape, (world, rank, got.shape,
                                                want.shape)
        for layer in range(want.shape[0]):
            harness.close(got[layer], want[layer],
                          f"W={world} process {rank} layer {layer}")


@pytest.mark.parametrize("name", ["stablelm-1.6b", "rwkv6-7b"])
def test_one_model_shard_is_the_whole_layer_path(name):
    """A (4, 1) mesh serves through the whole layers: the no-mesh steps'
    bits (which tests/test_torch_serving.py holds to the reference)."""
    cfg = reduced(get_config(name), seq=32)
    params = tt.init_params(0, cfg, "cpu")
    inputs = {k: torch.from_numpy(v) for k, v in
              _batch(cfg, 8, PROMPT + 2, 7).items()}
    toks = inputs["tokens"].long()
    outs = []
    for mesh in (None, make_mesh((4, 1))):
        prefill = steps.make_prefill_step(cfg, mesh, cache_len=CACHE_LEN)
        step = steps.make_serve_step(cfg, mesh)
        lg, cache = prefill(params, {**inputs, "tokens": toks[:, :PROMPT]})
        got = [lg]
        for i in range(PROMPT, PROMPT + 2):
            lg, cache = step(params, cache, toks[:, i:i + 1], i)
            got.append(lg)
        outs.append(got + tree_leaves(cache))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,seq", [("stablelm-1.6b", 32),
                                      ("starcoder2-15b", 32),
                                      ("starcoder2-15b", 64)],
                         ids=["slots", "head_dim-ring", "slots-ring"])
def test_int_and_tensor_positions_agree(name, seq):
    """A position on the host (an int: the owner and the valid slots found
    there) and one on the device (a 0-d tensor, never read back) give the
    same bits, through the ring's wrap."""
    cfg = reduced(get_config(name), seq=seq)
    params = tt.init_params(0, cfg, "cpu")
    toks = torch.from_numpy(_batch(cfg, 4, seq + 8, 9)["tokens"]).long()
    mesh = make_mesh((2, 2))
    prefill = steps.make_prefill_step(cfg, mesh, cache_len=seq + 8)
    step = steps.make_serve_step(cfg, mesh, cache_len=seq + 8)
    runs = []
    for as_tensor in (False, True):
        lg, cache = prefill(params, {"tokens": toks[:, :seq // 2]})
        out = [lg]
        for i in range(seq // 2, seq + 8):
            lg, cache = step(params, cache, toks[:, i:i + 1],
                             torch.tensor(i) if as_tensor else i)
            out.append(lg)
        runs.append(out + tree_leaves(cache))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_batch_smaller_than_the_clients_refuses():
    """long_500k's case, 2 requests over 4 client ranks: the steps serve
    them whole on every client (the joint layout; the 36 slots split over
    "model" alone), the logits within tests/test_torch_serving.py's bound
    of the whole layers' at f32; a step on a mesh of model shards still
    refuses without the cache's cache_len."""
    cfg = dataclasses.replace(reduced(get_config("stablelm-1.6b"), seq=32),
                              dtype=torch.float32)
    params = tt.init_params(0, cfg, "cpu")
    toks = torch.from_numpy(_batch(cfg, 2, PROMPT + 2, 10)["tokens"]).long()
    outs = []
    for mesh in (None, make_mesh((4, 2))):
        prefill = steps.make_prefill_step(cfg, mesh, cache_len=CACHE_LEN)
        step = steps.make_serve_step(cfg, mesh, cache_len=CACHE_LEN)
        lg, cache = prefill(params, {"tokens": toks[:, :PROMPT]})
        got = [lg]
        for i in range(PROMPT, PROMPT + 2):
            lg, cache = step(params, cache, toks[:, i:i + 1], i)
            got.append(lg)
        outs.append(got)
    assert step.layouts[2].cache_joint == (False, False)
    for a, b in zip(*outs):
        assert a.shape == (2, 1, cfg.padded_vocab())
        harness.close(b[..., :cfg.vocab], a[..., :cfg.vocab],
                      "B = 2 on (4, 2)")
    with pytest.raises(ValueError, match="cache_len"):
        steps.make_serve_step(cfg, make_mesh((4, 2)))


# -- over processes --------------------------------------------------------------------

# name: (arch, mesh, world, batch, cache_len); a batch of None is 2 rows
# a client, any other one the clients do not share (the joint layout)
SPREAD_CASES = {
    "stablelm-1x2": ("stablelm-1.6b", (1, 2), 2, None, 24),
    "stablelm-4x2": ("stablelm-1.6b", (4, 2), 2, None, 24),
    "rwkv6-1x2": ("rwkv6-7b", (1, 2), 2, None, 24),
    "rwkv6-heads-1x2": ("rwkv6-heads", (1, 2), 2, None, 24),
    "hymba-odd-1x2": ("hymba-odd", (1, 2), 2, None, 24),
    "whisper-1x2": ("whisper-medium", (1, 2), 2, None, 24),
    "stablelm-2x2": ("stablelm-1.6b", (2, 2), 4, None, 24),
    "stablelm-1x4": ("stablelm-1.6b", (1, 4), 4, None, 24),
    "vlm-2x2": ("qwen2-vl-2b", (2, 2), 4, None, 24),
    # the joint split: slots (40 of 8 parts) at B = 1 over 2 processes of
    # 2 clients and over 8 of one (client, shard); head_dim at B = 6 over 4
    "stablelm-joint-slots-w2": ("stablelm-1.6b", (4, 2), 2, 1, 40),
    "stablelm-joint-head_dim-b6-w4": ("stablelm-1.6b", (4, 2), 4, 6, 24),
    "stablelm-joint-slots-w8": ("stablelm-1.6b", (4, 2), 8, 1, 40),
    # 36 slots: "model" alone, the batch whole on every client
    "moe-model-alone-w8": ("qwen2-moe-a2.7b", (4, 2), 8, 1, 36),
    "rwkv6-joint-key-dim-w8": ("rwkv6-7b", (4, 2), 8, 1, 24),
    "rwkv6-joint-heads-w4": ("rwkv6-heads", (4, 2), 4, 1, 24),
    "hymba-joint-w8": ("hymba-1.5b", (4, 2), 8, 1, 24),
    "whisper-joint-w8": ("whisper-medium", (4, 2), 8, 1, 24),
    "vlm-joint-2x2x2-w8": ("qwen2-vl-2b", (2, 2, 2), 8, 1, 24),
}
WORLDS = (2, 4, 8)
FRONT_ARGV = ["--device", "cpu", "--reduced", "--tokens", "4",
              "--temperature", "0.7"]


def _spread_cfg(arch):
    """The reduced config (bf16, as served); "rwkv6-heads" with 8 heads
    of 8 (its state split on its heads), "hymba-odd" with hymba-1.5b's
    splits at T = 2."""
    if arch == "rwkv6-heads":
        return dataclasses.replace(reduced(get_config("rwkv6-7b"), seq=32),
                                   num_heads=8, d_model=64, head_dim=8)
    if arch == "hymba-odd":
        return dataclasses.replace(reduced(get_config("hymba-1.5b"), seq=32),
                                   num_heads=5, num_kv_heads=1, head_dim=16,
                                   d_model=80, ssm_heads=5)
    return reduced(get_config(arch), seq=32)


def run_serving(comm, name):
    """One spread case on `comm`'s cells: the process's rows (the whole
    batch where the clients do not share it), prefill and TOKENS greedy
    tokens; its tokens, logits, cache leaves and the bytes it sent its
    model and joint groups (prefill, then each token)."""
    arch, shape, _, batch, cache_len = SPREAD_CASES[name]
    cfg = _spread_cfg(arch)
    mesh = _mesh(shape)
    m, t = int(np.prod(shape[:-1])), shape[-1]
    whole = tt.init_params(0, cfg, "cpu")
    shards = comm.local_shards(t)
    params = sharding.take_model_shards(
        whole, sharding.split_axes(whole, t), shards, t)
    clients = range(m)[comm.local("rank", num_pods(mesh))]
    b = batch or 2 * m
    own = (slice(clients.start * 2, clients.stop * 2) if batch is None
           else slice(None))
    inputs = _batch(cfg, b, PROMPT, 8)
    batch_ = {k: torch.from_numpy(v[own]).to(
        torch.long if k == "tokens" else cfg.dtype)
        for k, v in inputs.items()}
    prefill = steps.make_prefill_step(cfg, mesh, cache_len=cache_len,
                                      collective=comm, batch=b)
    step = steps.make_serve_step(cfg, mesh, cache_len=cache_len,
                                 collective=comm, batch=b)
    comm.bytes_sent.clear()
    logits, cache = prefill(params, batch_)
    sent = [dict(comm.bytes_sent)]
    got = [logits.clone()]
    tok = torch.argmax(logits[:, -1, :cfg.vocab], -1, keepdim=True)
    toks = [tok]
    for i in range(TOKENS):
        logits, cache = step(params, cache, tok, PROMPT + i)
        sent.append(dict(comm.bytes_sent))
        got.append(logits.clone())
        tok = torch.argmax(logits[:, -1, :cfg.vocab], -1, keepdim=True)
        toks.append(tok)
    steps_sent = {k: [x.get(k, 0) - (sent[i - 1].get(k, 0) if i else 0)
                      for i, x in enumerate(sent)] for k in ("model", "joint")}
    return {"tokens": torch.cat(toks, 1).numpy(),
            "logits": [x.float().numpy() for x in got],
            "cache": [x.float().numpy() for x in tree_leaves(cache)],
            "sent": steps_sent["model"], "joint_sent": steps_sent["joint"],
            "clients": len(clients), "shards": shards}


def run_front_end(rank, world, port):
    """`serve.main` as torchrun starts it (its environment, a store the
    parent hosts), its stdout."""
    env = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port), "TORCHELASTIC_USE_AGENT_STORE": "True"}
    os.environ.update(env)
    text = io.StringIO()
    try:
        with redirect_stdout(text):
            assert serve.main(FRONT_ARGV + ["--dist-backend", "gloo"]) == 0
    finally:
        for k in env:
            os.environ.pop(k, None)
    return text.getvalue()


def _worker(rank, world, init_file, port, out):
    torch.set_num_threads(1)
    try:
        distributed.init_process_group(
            "gloo", rank=rank, world_size=world,
            init_method=f"file://{init_file}")
        res = {}
        for name, (_, shape, w, _, _) in SPREAD_CASES.items():
            if w == world:
                comm = distributed.ProcessGroupCollective(
                    int(np.prod(shape[:-1])), shape[-1])
                res[name] = run_serving(comm, name)
        distributed.destroy_process_group()
        if world == 4:
            res["front end"] = run_front_end(rank, world, port)
        out.put((world, rank, res))
    except BaseException as exc:
        import traceback

        out.put((world, rank, traceback.format_exc()))
        raise exc


@pytest.fixture(scope="module", autouse=True)
def _spawned(tmp_path_factory):
    """The W = 2, 4 and 8 processes, started with the module so that they
    run beside the reference's compiles; joined by `spread`."""
    tmp = str(tmp_path_factory.mktemp("serve"))
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = dist.TCPStore("localhost", 0, 4, is_master=True,
                          wait_for_workers=False)
    procs = []
    for world in WORLDS:
        for rank in range(world):
            p = ctx.Process(target=_worker, args=(
                rank, world, f"{tmp}/pg{world}", store.port, out))
            p.start()
            procs.append(p)
    state = {"procs": procs, "out": out, "results": None}
    yield state
    for p in procs:  # a process whose result was never read cannot exit
        p.join(30 if state["results"] is not None else 0)
        if p.is_alive():
            p.terminate()
            p.join(10)
    del store


@pytest.fixture(scope="module")
def spread(_spawned):
    if _spawned["results"] is None:
        results = {w: [None] * w for w in WORLDS}
        try:
            for _ in _spawned["procs"]:
                world, rank, res = _spawned["out"].get(timeout=240)
                if isinstance(res, str):
                    raise RuntimeError(f"W={world} process {rank} failed:\n"
                                       f"{res}")
                results[world][rank] = res
        except queue.Empty:
            raise RuntimeError("a spawned process gave no result in 240 s")
        _spawned["results"] = results
    return _spawned["results"]


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.shape,
                                                       b.shape)
    assert a.tobytes() == b.tobytes(), (
        f"{what}: max |diff| {np.abs(a.astype(np.float64) - b).max()}")


@pytest.mark.parametrize("name", sorted(SPREAD_CASES))
def test_spread_equals_one_process(spread, name):
    """Every process's tokens, logits and cache slice are the one-process
    run's over its rows (every row, where the clients do not share the
    batch) and its parts of the cache (`transformer.cache_slice`),
    bitwise; its bytes to its model group are `serve_model_bytes` of its
    clients and shards, and to the joint group `serve_joint_bytes` of its
    joint parts."""
    arch, shape, world, batch, cache_len = SPREAD_CASES[name]
    cfg = _spread_cfg(arch)
    mesh = _mesh(shape)
    m, t = int(np.prod(shape[:-1])), shape[-1]
    b = batch or 2 * m
    want = run_serving(distributed.StackedCollective(), name)
    want_cache = [torch.from_numpy(x) for x in want["cache"]]
    for rank, res in enumerate(spread[world]):
        got = res[name]
        comm = distributed.ProcessGroupCollective(m, t, world=world,
                                                  rank=rank)
        lay = comm.layout(num_pods(mesh))
        rows = (slice(lay.local_ranks.start * 2, lay.local_ranks.stop * 2)
                if batch is None else slice(None))
        _same(got["tokens"], want["tokens"][rows], f"{name} {rank} tokens")
        for i, (a, b_) in enumerate(zip(got["logits"], want["logits"])):
            _same(a, b_[rows], f"{name} {rank} logits {i}")
        ms = steps.serve_shards(cfg, mesh, cache_len, comm,
                                batch=None if batch is None else b)
        mine = tree_leaves(tt.cache_slice(
            [x[:, rows] for x in want_cache], ms))
        for j, (a, b_) in enumerate(zip(got["cache"], mine)):
            _same(a, b_.numpy(), f"{name} {rank} cache leaf {j}")
        sh = got["shards"]
        count = sh.stop - sh.start
        if lay.model_procs == 1:
            assert got["sent"] == [0] * (TOKENS + 1)
        elif batch is None:
            prefill = got["clients"] * sharding.serve_model_bytes(
                cfg, 2, cache_len, t, count, prompt=PROMPT)
            token = got["clients"] * sharding.serve_model_bytes(
                cfg, 2, cache_len, t, count)
            assert got["sent"] == [prefill] + [token] * TOKENS, name
        else:
            prefill = sharding.serve_model_bytes(
                cfg, b, cache_len, t, count, prompt=PROMPT, mesh=mesh)
            token = sharding.serve_model_bytes(cfg, b, cache_len, t, count,
                                               mesh=mesh)
            assert got["sent"] == [prefill] + [token] * TOKENS, name
        joint = (0 if batch is None else sharding.serve_joint_bytes(
            cfg, b, cache_len, mesh, ms.joint.count))
        assert got["joint_sent"] == [0] + [joint] * TOKENS, name
        assert (joint > 0) == (batch is not None and any(ms.cache_joint))


def test_front_end_over_processes(spread):
    """`serve.main` under torchrun at W = 4 on the default (4, 2) mesh
    (one client of 2 shards a process), sampling at temperature 0.7 over
    every request's gathered logits: request 0's ids are those of the
    same mesh computed by shard in one process."""
    args = serve.parse_args(FRONT_ARGV)
    _, want = serve.serve(args, torch.device("cpu"),
                          mesh=serve.serve_mesh(args))
    printed = spread[4][0]["front end"].splitlines()
    assert printed[1] == f"request 0 token ids: {want}"
    assert "mesh={'data': 4, 'model': 2} layers=by shard" in printed[0]
    assert all(r["front end"] == "" for r in spread[4][1:])


# -- the front end ---------------------------------------------------------------------

def test_front_end_serves_on_the_reference_mesh(capsys):
    """One process holds every cell of the (4, 2) mesh and computes each
    layer whole: request 0's ids are those of the steps without a mesh."""
    assert serve.main(["--device", "cpu", "--reduced", "--tokens", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "mesh={'data': 4, 'model': 2} layers=whole, one process" in out[0]
    assert "ms/token" in out[0]
    args = serve.parse_args(["--reduced", "--tokens", "2"])
    assert out[1] == (f"request 0 token ids: "
                      f"{serve.serve(args, torch.device('cpu'))[1]}")
    assert serve.serve_mesh(serve.parse_args(["--multi-pod"])).sizes == (
        2, 16, 16)
    assert serve.serve_mesh(serve.parse_args(
        ["--production-mesh"])) == make_production_mesh()


def test_one_model_shard_over_processes_refuses():
    """Serving over processes spreads the model axis: a mesh of one model
    shard refuses before anything is drawn."""
    two = types.SimpleNamespace(world=2)
    with pytest.raises(ValueError, match="one model shard"):
        serve.serve(serve.parse_args(["--reduced"]), torch.device("cpu"),
                    two, make_mesh((2, 1)))


@pytest.mark.parametrize("argv,match", [
    (["--production-mesh", "--arch", "dbrx-132b", "--batch", "16"],
     "does not fit: a process's parameter shards take"),
    (["--multi-pod", "--arch", "dbrx-132b", "--batch", "32"],
     "does not fit: a process's parameter shards take"),
    (["--reduced", "--batch", "0"], "at least one request"),
    (["--reduced", "--dist-backend", "nccl"], "the host needs")],
    ids=["production-mesh", "multi-pod", "batch-below-clients",
         "nccl-on-the-host"])
def test_front_end_refusals(argv, match, capsys):
    """The production meshes are sized on the meta device before anything
    is allocated (one process holding every cell of dbrx-132b does not fit
    the host) and exit 2 naming the bytes; so do NCCL on the host and,
    of the batches below the client ranks, the one of no request (every
    other is served: `test_front_end_serves_a_batch_below_the_clients`)."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert match in capsys.readouterr().err


@pytest.mark.parametrize("batch", [1, 2, 6])
def test_front_end_serves_a_batch_below_the_clients(batch, capsys):
    """A batch the 4 client ranks of the default (4, 2) mesh cannot share
    (as the reference's front end takes any --batch): exit 0, one process
    computing whole layers; request 0's ids are those of the same mesh by
    shard in one process (every client serving the whole batch, the cache
    split jointly where it divides)."""
    argv = ["--device", "cpu", "--reduced", "--tokens", "2", "--batch",
            str(batch)]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert f"batch={batch} mesh={{'data': 4, 'model': 2}}" in out[0]
    args = serve.parse_args(argv)
    _, by_shard = serve.serve(args, torch.device("cpu"),
                              mesh=serve.serve_mesh(args))
    assert out[1] == f"request 0 token ids: {by_shard}"
