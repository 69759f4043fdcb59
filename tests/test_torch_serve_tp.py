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
  layer's largest entry; layer 0's k and v to rtol 1e-5; MoE routing
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
- A mesh of one model shard is the whole-layer path, bitwise.
- Spread over W = 2 and W = 4 gloo processes (spawned once, joined
  through a file, one intra-op thread each, started with the module so
  they run beside the reference's compiles): every process's greedy
  tokens, logits and cache slice (its rows, its shards) are the
  one-process run's bits, and its bytes to its model group equal
  `serve_model_bytes` for the prefill and for each token (none where the
  model axis does not spread). The front end under torchrun's
  environment samples at temperature 0.7 over 4 processes and prints the
  ids of the same mesh by shard in one process.
- The front end: the reference's (4, 2) mesh by default, each layer
  whole where one process holds every cell; the production mesh sized
  on the meta device, exit 2 naming the bytes where a process does not
  fit; a batch smaller than the client ranks, NCCL on the host and a
  mesh of one model shard over processes refused.
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
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import moe as tmoe
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
    """One intra-op thread: the shapes are small and the spawned processes
    run beside this one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def _by_shard_against_reference(jcfg, tcfg, shape, prompt, n_tokens,
                                cache_len, margins, *, b=8, seed=5,
                                axes=None):
    """The port's serve steps on `shape` by shard in one process against
    the reference's prefill and decode_step: prefill `prompt` tokens,
    decode `n_tokens` teacher-forced; returns the worst relative errors
    (logits, cache)."""
    jp = jt.init_params(jax.random.key(0), jcfg)
    params = convert.params_from_jax(jax.device_get(jp), "cpu")
    inputs = _batch(jcfg, b, prompt + n_tokens, seed)
    mesh = make_mesh(shape)
    prefill = steps.make_prefill_step(tcfg, mesh, cache_len=cache_len)
    step = steps.make_serve_step(tcfg, mesh, cache_len=cache_len)
    if axes is not None:
        got = step.shards.cache_axes
        assert got == axes, (got, axes)
    jl_, jc = jax.jit(lambda p, b_: jt.prefill(p, b_, jcfg,
                                              cache_len=cache_len))(
        jp, harness.prompt(inputs, prompt, "jax"))
    tl_, tc = prefill(params, harness.prompt(inputs, prompt, "torch"))
    v = tcfg.vocab
    w_logit = harness.close(tl_[..., :v], jl_[..., :v], "prefill logits")
    w_cache = harness.close_cache(tc, jc, "prefill cache")
    jdecode = jax.jit(lambda p, c, t, pos: jt.decode_step(p, c, t, pos,
                                                          jcfg))
    toks = inputs["tokens"]
    for i in range(prompt, prompt + n_tokens):
        tok = toks[:, i:i + 1]
        jl_, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(i))
        tl_, tc = step(params, tc, torch.from_numpy(tok).long(), i)
        w_logit = max(w_logit, harness.close(tl_[..., :v], jl_[..., :v],
                                              f"decode {i} logits"))
    w_cache = max(w_cache, harness.close_cache(tc, jc, "decode cache"))
    if tcfg.num_experts:
        assert min(margins) > MARGIN, margins
    return w_logit, w_cache


@pytest.mark.parametrize("name", FAMILIES)
def test_by_shard_on_the_reference_mesh_matches_reference(name, margins):
    """Each family's reduced config on (4, 2): 8 requests, 2 a client, its
    layers and cache on the 2 model shards."""
    jcfg, tcfg = _pair(name)
    w_logit, w_cache = _by_shard_against_reference(
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
    w_logit, w_cache = _by_shard_against_reference(
        jcfg, tcfg, shape, prompt, n, cache_len, margins, b=4, seed=6,
        axes=axes)
    print(f"{case}: worst logits error {w_logit:.2e}, cache {w_cache:.2e}")


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
    """long_500k's case: the joint (clients x model) split is the next
    serving slice; the steps name it."""
    cfg = reduced(get_config("stablelm-1.6b"), seq=32)
    params = tt.init_params(0, cfg, "cpu")
    prefill = steps.make_prefill_step(cfg, make_mesh((4, 2)),
                                      cache_len=CACHE_LEN)
    with pytest.raises(ValueError, match="ROADMAP Queue A 2"):
        prefill(params, {"tokens": torch.zeros((2, PROMPT),
                                               dtype=torch.long)})
    with pytest.raises(ValueError, match="cache_len"):
        steps.make_serve_step(cfg, make_mesh((4, 2)))


# -- over processes --------------------------------------------------------------------

# name: (arch, mesh, world)
SPREAD_CASES = {
    "stablelm-1x2": ("stablelm-1.6b", (1, 2), 2),
    "stablelm-4x2": ("stablelm-1.6b", (4, 2), 2),
    "rwkv6-1x2": ("rwkv6-7b", (1, 2), 2),
    "rwkv6-heads-1x2": ("rwkv6-heads", (1, 2), 2),
    "hymba-odd-1x2": ("hymba-odd", (1, 2), 2),
    "whisper-1x2": ("whisper-medium", (1, 2), 2),
    "stablelm-2x2": ("stablelm-1.6b", (2, 2), 4),
    "stablelm-1x4": ("stablelm-1.6b", (1, 4), 4),
    "vlm-2x2": ("qwen2-vl-2b", (2, 2), 4),
}
SPREAD_CACHE = 24
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
    """One spread case on `comm`'s cells: the process's rows, prefill and
    TOKENS greedy tokens; its tokens, logits, cache leaves and the bytes
    it sent its model group (prefill, then the tokens)."""
    arch, shape, _ = SPREAD_CASES[name]
    cfg = _spread_cfg(arch)
    m, t = shape
    mesh = make_mesh(shape)
    whole = tt.init_params(0, cfg, "cpu")
    shards = comm.local_shards(t)
    params = sharding.take_model_shards(
        whole, sharding.split_axes(whole, t), shards, t)
    rows = 2
    clients = range(m)[comm.local("rank", 1)]
    own = slice(clients.start * rows, clients.stop * rows)
    inputs = _batch(cfg, m * rows, PROMPT, 8)
    batch = {k: torch.from_numpy(v[own]).to(
        torch.long if k == "tokens" else cfg.dtype)
        for k, v in inputs.items()}
    prefill = steps.make_prefill_step(cfg, mesh, cache_len=SPREAD_CACHE,
                                      collective=comm)
    step = steps.make_serve_step(cfg, mesh, cache_len=SPREAD_CACHE,
                                 collective=comm)
    comm.bytes_sent.clear()
    logits, cache = prefill(params, batch)
    sent = [comm.bytes_sent["model"]]
    got = [logits.clone()]
    tok = torch.argmax(logits[:, -1, :cfg.vocab], -1, keepdim=True)
    toks = [tok]
    for i in range(TOKENS):
        logits, cache = step(params, cache, tok, PROMPT + i)
        sent.append(comm.bytes_sent["model"] - sum(sent))
        got.append(logits.clone())
        tok = torch.argmax(logits[:, -1, :cfg.vocab], -1, keepdim=True)
        toks.append(tok)
    return {"tokens": torch.cat(toks, 1).numpy(),
            "logits": [x.float().numpy() for x in got],
            "cache": [x.float().numpy() for x in tree_leaves(cache)],
            "sent": sent, "clients": len(clients), "shards": shards}


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
        for name, (_, shape, w) in SPREAD_CASES.items():
            if w == world:
                comm = distributed.ProcessGroupCollective(shape[0], shape[1])
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
    """The W = 2 and W = 4 processes, started with the module so that they
    run beside the reference's compiles; joined by `spread`."""
    tmp = str(tmp_path_factory.mktemp("serve"))
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    store = dist.TCPStore("localhost", 0, 4, is_master=True,
                          wait_for_workers=False)
    procs = []
    for world in (2, 4):
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
        results = {2: [None] * 2, 4: [None] * 4}
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
    run's over its rows and shards, bitwise; its bytes to its model group
    are `serve_model_bytes` of its clients and shards."""
    arch, shape, world = SPREAD_CASES[name]
    cfg = _spread_cfg(arch)
    m, t = shape
    want = run_serving(distributed.StackedCollective(), name)
    axes = steps.serve_shards(cfg, make_mesh(shape), SPREAD_CACHE).cache_axes
    for rank, res in enumerate(spread[world]):
        got = res[name]
        lay = distributed.RankLayout(world, rank, m, 1, t)
        rows = slice(lay.local_ranks.start * 2, lay.local_ranks.stop * 2)
        _same(got["tokens"], want["tokens"][rows], f"{name} {rank} tokens")
        for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
            _same(a, b[rows], f"{name} {rank} logits {i}")
        sh = got["shards"]
        for j, (a, b, ax) in enumerate(zip(got["cache"], want["cache"],
                                           axes)):
            b = b[:, rows]
            if ax is not None:
                n = b.shape[ax] // t
                b = np.take(b, range(sh.start * n, sh.stop * n), axis=ax)
            _same(a, b, f"{name} {rank} cache leaf {j}")
        if lay.model_procs == 1:
            assert got["sent"] == [0] * (TOKENS + 1)
            continue
        count = sh.stop - sh.start
        prefill = got["clients"] * sharding.serve_model_bytes(
            cfg, 2, SPREAD_CACHE, t, count, prompt=PROMPT)
        token = got["clients"] * sharding.serve_model_bytes(
            cfg, 2, SPREAD_CACHE, t, count)
        assert got["sent"] == [prefill] + [token] * TOKENS, name


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
    (["--reduced", "--batch", "2"], "ROADMAP Queue A 2"),
    (["--reduced", "--dist-backend", "nccl"], "the host needs")],
    ids=["production-mesh", "multi-pod", "batch-below-clients",
         "nccl-on-the-host"])
def test_front_end_refusals(argv, match, capsys):
    """The production meshes are sized on the meta device before anything
    is allocated (one process holding every cell of dbrx-132b does not fit
    the host) and exit 2 naming the bytes; so do a batch the clients
    cannot share and NCCL on the host."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert match in capsys.readouterr().err
