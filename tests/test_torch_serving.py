"""The port's serving path (`repro_torch.models.transformer.prefill`,
`init_cache`, `decode_step`, each mixer's prefill and decode, the caches,
`layers.decode_attention`, `launch.steps.make_prefill_step` /
`make_serve_step` and `launch.serve`) against the JAX reference.

Each family's reduced config (2 layers, d_model 128, a window of 16 where
the config has one) runs at f32 on both sides from the same parameters
(`convert.params_from_jax`), prompt tokens, patches and frames, made with
numpy from a seed. The reference runs as its own tests run it: `prefill`
and `decode_step` under `jax.jit`, one compile per family and shape.
Tolerances, each with its reason:

- logits and every cache leaf, per layer: within 1e-2 of that layer's
  largest entry. Both sides round the attention's probabilities and values
  (and, at decode, q and k) to bf16 before their products, so a last-bit
  f32 difference that crosses a bf16 rounding boundary moves an element by
  2^-8 of itself (tests/test_torch_models.py holds the train path to the
  same bound). The worst measured error is in each assertion message.
- layer 0's k and v: element by element within what two f32
  implementations of their projection may differ by,
  u (4 K + 3 p + 4) R(|h| @ |w| + |b|) for k and u 4 K (|h| @ |w| + |b|)
  for v (u = 2^-24, K = d_model, the summation's length; p the largest
  rotary angle; R the rotation's pair mixing;
  tests/_torch_harness.py's `layer0_kv_bounds` says why). They are
  projections of the embedded tokens, before any attention, so no bf16
  rounding enters them.
- MoE: every routing probability's k-th and (k+1)-th values at least 1e-4
  apart in the port (test_torch_families.py's margin), so no expert flips
  between the two sides; a flip fails the test.
- tree paths, shapes and dtypes: exact.

The port's own teacher-forced decode is held to its own forward at the
config's dtype (bf16) within the reference's bound for that check,
0.1 + 0.05 |forward logit| (tests/test_models.py). There the decode path
rounds q and k to bf16 and the forward does not; for MoE every routing
margin of both passes is above MARGIN, so no expert flips between them
and a flip fails the test.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_harness import one_intra_op_thread

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core.api import tree_leaves
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt

from _torch_harness import close as _close
from _torch_harness import close_cache as _close_cache
from _torch_harness import layer0_kv_bounds as _bounds
from _torch_harness import prompt as _prompt

ROOT = Path(__file__).resolve().parents[1]
S, B = 32, 2
HALF = S // 2
CACHE_LEN = S + 4
FAMILIES = ["stablelm-1.6b", "qwen2-moe-a2.7b", "dbrx-132b", "rwkv6-7b",
            "hymba-1.5b", "qwen2-vl-2b", "whisper-medium", "starcoder2-15b"]
RINGS = ["hymba-1.5b", "starcoder2-15b"]
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


@functools.lru_cache(maxsize=None)
def _model(name):
    """(jcfg, tcfg, reference params, port params, jitted reference decode)
    at f32, shared by the tests of a family."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(name), seq=S),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(reduced(get_config(name), seq=S),
                               dtype=torch.float32)
    jp = jt.init_params(jax.random.key(0), jcfg)
    tp = convert.params_from_jax(jax.device_get(jp), "cpu")
    jdecode = jax.jit(lambda p, c, t, pos: jt.decode_step(p, c, t, pos, jcfg))
    return jcfg, tcfg, jp, tp, jdecode


def _inputs(cfg, n, seed=1):
    """Tokens (B, n) and the VLM's patches / the encoder's frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder_layers:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture
def margins(monkeypatch):
    """The routing margin of every MoE call the port makes while the test
    runs: the smallest gap between a token's k-th and (k+1)-th
    probability."""
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


def _run_both(name, prompt_len, steps, inputs, margins, check_every=False):
    """Prefill `prompt_len` tokens on both sides, then decode `steps`
    tokens teacher-forced; the logits after each call, and the caches
    after the prefill and at the end (or after every step), held to the
    reference. Returns the worst relative errors (logits, cache)."""
    jcfg, tcfg, jp, tp, jdecode = _model(name)
    jl_, jc = jax.jit(lambda p, b: jt.prefill(p, b, jcfg,
                                             cache_len=CACHE_LEN))(
        jp, _prompt(inputs, prompt_len, "jax"))
    tl_, tc = tt.prefill(tp, _prompt(inputs, prompt_len, "torch"), tcfg,
                         cache_len=CACHE_LEN)
    v = tcfg.vocab  # the padded ids hold -1e30 on both sides
    w_logit = _close(tl_[..., :v], jl_[..., :v], f"{name} prefill logits")
    writes = [(p, p) for p in range(prompt_len)]
    w_cache = _close_cache(tc, jc, f"{name} prefill cache",
                           _bounds(tcfg, tp, inputs, writes, tc))
    toks = inputs["tokens"]
    for i in range(prompt_len, prompt_len + steps):
        tok = toks[:, i:i + 1]
        jl_, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(i))
        tl_, tc = tt.decode_step(tp, tc, torch.from_numpy(tok), i, tcfg)
        writes.append((i, i))
        w_logit = max(w_logit, _close(tl_[..., :v], jl_[..., :v],
                                      f"{name} decode {i} logits"))
        if check_every or i == prompt_len + steps - 1:
            w_cache = max(w_cache, _close_cache(
                tc, jc, f"{name} decode {i} cache",
                _bounds(tcfg, tp, inputs, writes, tc)))
    if tcfg.num_experts:
        assert min(margins) > MARGIN, margins
    return w_logit, w_cache


# -- every family against the reference ------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name, margins):
    """Prefill half the sequence (for the VLM: its patches and then text),
    decode the rest teacher-forced; the prefill's cache has init_cache's
    tree, shapes and dtypes."""
    jcfg, tcfg, _, tp, _ = _model(name)
    inputs = _inputs(jcfg, S)
    w_logit, w_cache = _run_both(name, HALF, S - HALF, inputs, margins)
    _, cache = tt.prefill(tp, _prompt(inputs, HALF, "torch"), tcfg,
                          cache_len=CACHE_LEN)
    zeros = tt.init_cache(tp, tcfg, batch=B, cache_len=CACHE_LEN)
    assert [(t.shape, t.dtype) for t in tree_leaves(cache)] ==         [(t.shape, t.dtype) for t in tree_leaves(zeros)]
    print(f"{name}: worst logits error {w_logit:.2e}, cache {w_cache:.2e} "
          "of the largest entry")


@pytest.mark.parametrize("seed", [5, 11])
@pytest.mark.parametrize("name", [n for n in FAMILIES
                                  if n not in ("qwen2-moe-a2.7b",
                                               "dbrx-132b")])
def test_prefill_and_decode_match_reference_at_seeds(name, seed, margins):
    """The whole-layer path from the joint cases' seeds
    (tests/test_torch_serve_tp.py): seed 11's inputs once put one element
    of starcoder2's layer-0 k past rtol 1e-5 of the reference's; every
    family held to the same bounds, layer 0's k and v to
    `layer0_kv_bounds`. The MoE families are left out: their comparison
    also needs every routing margin above MARGIN, a property of the
    inputs that seed 11's do not have for dbrx (7.1e-5); their layer 0 is
    the dense family's projection, held at seed 1 above and, for
    qwen2-moe, in the joint cases at seeds 5 and 11."""
    jcfg = _model(name)[0]
    w_logit, w_cache = _run_both(name, HALF, S - HALF, _inputs(jcfg, S, seed),
                                 margins)
    print(f"{name} at seed {seed}: worst logits error {w_logit:.2e}, cache "
          f"{w_cache:.2e} of the largest entry")


@pytest.mark.parametrize("prompt_len", [HALF, HALF + 8],
                         ids=["prompt-fits-window", "prompt-wraps-window"])
@pytest.mark.parametrize("name", RINGS)
def test_ring_buffer_matches_reference_past_the_window(name, prompt_len,
                                                       margins):
    """Decode 2 x window tokens past the prompt, held at every step: a
    prompt that fits the window (starcoder2's slot-0 branch) and one that
    wraps it at prefill (its pos % cap scatter; hymba's ring takes the
    scatter either way)."""
    jcfg, tcfg, _, _, _ = _model(name)
    window = tcfg.sliding_window
    assert window == 16 and min(CACHE_LEN, window) == window
    steps = 2 * window
    inputs = _inputs(jcfg, prompt_len + steps, seed=2)
    w_logit, w_cache = _run_both(name, prompt_len, steps, inputs, margins,
                                 check_every=True)
    print(f"{name} prompt {prompt_len}: worst logits error {w_logit:.2e}, "
          f"cache {w_cache:.2e}")


def _paths(tree, prefix=""):
    """The port's cache paths in jax.tree_util.keystr form."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                          f"{prefix}['{k}']")]
    if hasattr(tree, "_fields"):
        return [p for f in tree._fields for p in _paths(getattr(tree, f),
                                                         f"{prefix}.{f}")]
    return [prefix]


@pytest.mark.parametrize("name", JAX_ARCH_NAMES)
def test_init_cache_matches_reference_at_full_size(name):
    """Paths, shapes and dtypes of init_cache on the full config (meta
    tensors) against jax.eval_shape of the reference's, at a cache longer
    than any window."""
    jcfg, tcfg = jax_get_config(name), get_config(name)
    params = tt.init_params(0, tcfg, "meta")
    got = tt.init_cache(params, tcfg, batch=2, cache_len=4200)
    want = jax.eval_shape(lambda: jt.init_cache(None, jcfg, batch=2,
                                                cache_len=4200))
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert _paths(got) == [jax.tree_util.keystr(p) for p, _ in flat]
    for g, (_, w) in zip(tree_leaves(got), flat):
        assert g.device.type == "meta"
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


# -- the port on its own ---------------------------------------------------------------

@pytest.mark.parametrize("name", FAMILIES)
def test_teacher_forced_decode_matches_forward(name, margins, monkeypatch):
    """At the config's dtype (bf16): prefill half, decode the rest with
    the true tokens; each position's logits within 0.1 + 0.05 |forward|
    of the port's own forward (the reference's
    test_prefill_decode_matches_forward). For MoE every routing margin of
    both passes is above MARGIN and no expert differs from the forward's
    at any layer, row or position."""
    cfg = reduced(get_config(name), seq=S)
    params = tt.init_params(0, cfg, "cpu")
    inputs = _inputs(cfg, S, seed=3)
    batch = {k: torch.from_numpy(v).to(torch.int64 if k == "tokens"
                                       else cfg.dtype)
             for k, v in inputs.items()}
    toks = batch["tokens"]
    routes = []
    route = tmoe._route

    def recording(p, x, c):
        out = route(p, x, c)
        routes.append(torch.sort(out[2], dim=-1).values)
        return out

    monkeypatch.setattr(tmoe, "_route", recording)
    with torch.no_grad():
        want = tt.forward(params, {**batch, "tokens": torch.nn.functional.pad(
            toks, (0, 1))}, cfg, remat=False)[..., :cfg.vocab].float()
    fwd = list(routes)
    routes.clear()
    logits, cache = tt.prefill(params, {**batch, "tokens": toks[:, :HALF]},
                               cfg, cache_len=CACHE_LEN)
    got = [(HALF - 1, logits, [r[:, HALF - 1] for r in routes])]
    for i in range(HALF, S):
        routes.clear()
        logits, cache = tt.decode_step(params, cache, toks[:, i:i + 1], i,
                                       cfg)
        got.append((i, logits, [r[:, 0] for r in routes]))
    if cfg.num_experts:
        assert min(margins) > MARGIN, (name, min(margins))
    worst = 0.0
    for i, lg, rs in got:
        flipped = [j for j, (r, f) in enumerate(zip(rs, fwd))
                   if not torch.equal(r, f[:, i])]
        assert not flipped, f"{name}: experts flip at position {i}, layers {flipped}"
        f = want[:, i]
        ratio = float(((lg[:, 0, :cfg.vocab].float() - f).abs()
                       / (0.1 + 0.05 * f.abs())).max())
        worst = max(worst, ratio)
        assert ratio <= 1.0, f"{name}: position {i} at {ratio:.3f} of the bound"
    print(f"{name}: worst {worst:.3f} of the bound"
          f"{f', smallest routing margin {min(margins):.2e}' if margins else ''}")


def test_serving_steps_update_the_cache_in_place():
    """make_prefill_step / make_serve_step: the serve step writes the token
    into the cache it is given (the same tensors, the reference donates
    its cache) and returns that cache; an int and a 0-d tensor position
    give the same result."""
    _, tcfg, _, tp, _ = _model("stablelm-1.6b")
    inputs = _inputs(tcfg, S)
    prefill = make_prefill_step(tcfg, cache_len=CACHE_LEN)
    serve = make_serve_step(tcfg)
    _, cache = prefill(tp, _prompt(inputs, HALF, "torch"))
    k = cache["mixer"].k
    ptr, before = k.data_ptr(), k.clone()
    assert not before[:, :, HALF].any()  # the slot is empty until decoded
    tok = torch.from_numpy(inputs["tokens"][:, HALF:HALF + 1])
    copy = tt.init_cache(tp, tcfg, batch=B, cache_len=CACHE_LEN)
    for dst, src in zip(tree_leaves(copy), tree_leaves(cache)):
        dst.copy_(src)
    logits, out = serve(tp, cache, tok, HALF)
    assert out is cache and out["mixer"].k.data_ptr() == ptr
    assert k[:, :, HALF].abs().sum() > 0
    assert torch.equal(k[:, :, :HALF], before[:, :, :HALF])
    logits_t, _ = serve(tp, copy, tok, torch.tensor(HALF))
    assert torch.equal(logits, logits_t)
    for a, b in zip(tree_leaves(cache), tree_leaves(copy)):
        assert torch.equal(a, b)


def test_whisper_learned_position_clamps_past_its_table():
    """Decoding at positions past the decoder's position table: the
    reference's dynamic_slice clamps the row to the last one, and its
    dynamic_update_slice clamps the cache slot to the last one."""
    jcfg, tcfg, jp, tp, jdecode = _model("whisper-medium")
    inputs = _inputs(jcfg, S)
    _, jc = jax.jit(lambda p, b: jt.prefill(p, b, jcfg, cache_len=CACHE_LEN))(
        jp, _prompt(inputs, HALF, "jax"))
    _, tc = tt.prefill(tp, _prompt(inputs, HALF, "torch"), tcfg,
                       cache_len=CACHE_LEN)
    tok = inputs["tokens"][:, HALF:HALF + 1]
    for pos in (tcfg.max_seq - 1, tcfg.max_seq + 5):
        jl_, jc = jdecode(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl_, tc = tt.decode_step(tp, tc, torch.from_numpy(tok), pos, tcfg)
        _close(tl_[..., :tcfg.vocab], jl_[..., :tcfg.vocab],
               f"whisper decode at {pos}")
    _close_cache(tc, jc, "whisper past the table", _bounds(
        tcfg, tp, inputs, [(p, p) for p in range(HALF)]
        + [(tcfg.max_seq - 1, HALF), (tcfg.max_seq + 5, HALF)], tc))
    # the clamped row equals the table's last one: pos max_seq + 5 decodes
    # as pos max_seq - 1 would (the slot clamps too)
    a = tt.decode_step(tp, tc, torch.from_numpy(tok), tcfg.max_seq + 5, tcfg)
    b = tt.decode_step(tp, tc, torch.from_numpy(tok), tcfg.max_seq - 1, tcfg)
    assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("name", ["rwkv6-7b", "hymba-1.5b"])
def test_prefill_refuses_a_prompt_off_the_chunk_grid(name):
    """The chunked linear attention takes chunks of 64: a prompt longer
    than one chunk must be a multiple of it (the reference asserts
    seq % min(64, seq) == 0)."""
    jcfg, tcfg, jp, tp, _ = _model(name)
    inputs = _inputs(jcfg, 72)
    with pytest.raises(AssertionError, match="must divide chunk"):
        jt.prefill(jp, _prompt(inputs, 72, "jax"), jcfg, cache_len=80)
    with pytest.raises(ValueError, match="must divide chunk"):
        tt.prefill(tp, _prompt(inputs, 72, "torch"), tcfg, cache_len=80)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("tensor_len", [False, True])
def test_decode_attention_matches_reference(window, tensor_len):
    """Grouped single-token attention (8 heads over 2 KV heads) against a
    cache of 12 slots with 9 valid, with and without a window, the valid
    count as an int and as a 0-d tensor."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
            for _ in range(2))
    n = torch.tensor(9) if tensor_len else 9
    got = tl.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), n,
                              window=window)
    want = jl.decode_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               jnp.int32(9), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- the serve front end ----------------------------------------------------------------

def _serve_cli(*args, env=None):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **(env or {})}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


@pytest.mark.parametrize("arch,temperature", [("hymba-1.5b", "0"),
                                              ("whisper-medium", "0.7")])
def test_serve_cli_runs_reduced_on_the_host(arch, temperature):
    out = _serve_cli("--device", "cpu", "--reduced", "--arch", arch,
                     "--batch", "8", "--prompt-len", "16", "--tokens", "4",
                     "--temperature", temperature)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "ms/token" in lines[0] and arch in lines[0]
    ids = eval(lines[1].split(":", 1)[1])  # noqa: S307 - our own output
    assert len(ids) == 5 and all(0 <= t < 503 for t in ids)


def test_serve_cli_refuses_without_a_card():
    """The default device is the card: without one it exits non-zero and
    says why, and never falls back to the host."""
    out = _serve_cli("--tokens", "2", env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "--device cpu" in out.stderr
    assert "ms/token" not in out.stdout
