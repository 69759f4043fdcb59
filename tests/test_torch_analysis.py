"""The port's invariant analysis (`repro_torch.analysis`): every lint rule on
in-memory fixtures (the reference's `tests/test_analysis.py` cases, with
the torch forms of the generator rules), the port linting clean, and the
step census held to the reference's wire accounting: for every census
method and mesh, the port's gathers carry the reference's
`CompressedAggregation.wire_bytes_per_round` exactly, and one f32 DIANA
step on (4, 1) carries the bytes of the reference's own jaxpr census of
its traced step (`repro.analysis.graph.collective_census`, trace only)."""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
from _torch_harness import one_intra_op_thread

from repro_torch.analysis import lint_paths, lint_source, rule_catalog

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_intra_op_thread()


def _lint(src: str, rel: str = "src/repro_torch/somewhere/mod.py"):
    return lint_source(textwrap.dedent(src), rel)


def _rules(findings):
    return [f.rule for f in findings]


# -- generator purity -----------------------------------------------------------


def test_rng_unseeded_and_bare_int_seed_flagged():
    f = _lint("""
        import numpy as np
        a = np.random.default_rng()
        b = np.random.default_rng(seed)
    """)
    assert _rules(f) == ["rng-unstructured-seed", "rng-unstructured-seed"]


def test_rng_structured_tuple_passes_but_literal_salt_flagged():
    assert _lint("""
        import numpy as np
        from repro_torch.core import salts
        rng = np.random.default_rng((seed, salts.WR_COHORT_SALT, rnd))
    """) == []
    f = _lint("""
        import numpy as np
        rng = np.random.default_rng((seed, 0x5EED, rnd))
    """)
    assert _rules(f) == ["rng-literal-salt"]


def test_rng_global_numpy_and_torch_streams_flagged():
    f = _lint("""
        import numpy as np
        import torch
        np.random.seed(3)
        x = np.random.rand(4)
        torch.manual_seed(0)
    """)
    assert _rules(f) == ["rng-unstructured-seed"] * 3


def test_rng_generator_seed_must_be_salted_or_structured():
    f = _lint("""
        import torch
        g = torch.Generator(device="cpu").manual_seed(1234)
        h = torch.Generator().manual_seed(seed)
    """)
    assert _rules(f) == ["rng-unstructured-seed"] * 2
    assert _lint("""
        import numpy as np
        import torch
        from repro_torch.core import salts

        def gen(seed, step, device):
            words = (seed, salts.ROUNDS_KEY_SALT, step)
            return torch.Generator(device=device).manual_seed(hash(words))

        def epoch_gen(seed, epoch, device):
            entropy = int(np.random.SeedSequence((seed, epoch))
                          .generate_state(1)[0])
            return torch.Generator(device=device).manual_seed(entropy)
    """) == []


def test_rng_seed_sequence_literal_salt_and_bare_seed_flagged():
    f = _lint("""
        import numpy as np
        import torch

        def gen(seed, device):
            entropy = int(np.random.SeedSequence((seed, 7)).generate_state(1)[0])
            return torch.Generator(device=device).manual_seed(entropy)

        def bare(seed, device):
            entropy = int(np.random.SeedSequence(seed).generate_state(1)[0])
            return torch.Generator(device=device).manual_seed(entropy)
    """)
    assert sorted(_rules(f)) == ["rng-literal-salt", "rng-unstructured-seed",
                                 "rng-unstructured-seed"]


def test_rng_torch_draws_need_a_generator():
    f = _lint("""
        import torch
        a = torch.rand(3)
        b = torch.randint(0, 5, (2,))
        c = torch.randperm(4)
        x.normal_(0.0, 1.0)
        d = torch.multinomial(p, 1)
    """)
    assert _rules(f) == ["rng-unstructured-seed"] * 5
    assert _lint("""
        import torch
        a = torch.rand(3, generator=gen)
        b = torch.randint(0, 5, (2,), generator=gen, device=dev)
        x.normal_(0.0, 1.0, generator=gen)
        c = torch.multinomial(p, 1, generator=gen)
    """) == []


def test_rng_salt_assignment_flagged_and_salts_module_exempt():
    f = _lint("""
        MY_SALT = 0x1234
    """)
    assert _rules(f) == ["rng-literal-salt"]
    assert _lint("""
        POD_KEY_SALT = 0x70D5
        g = torch.Generator().manual_seed(entropy)
    """, rel="src/repro_torch/core/salts.py") == []


# -- ignored arguments -----------------------------------------------------------

DEL_EPOCH_SAMPLER = """
    import numpy as np

    from repro_torch.core import salts

    class Sampler:
        def __init__(self, seed, n):
            self.rng = np.random.default_rng((seed, salts.WR_COHORT_SALT))
            self.n = n

        def sample(self, epoch):
            del epoch  # looked harmless in review
            return self.rng.permutation(self.n)
"""


def test_del_epoch_sampler_caught_by_exactly_one_rule():
    f = _lint(DEL_EPOCH_SAMPLER)
    assert _rules(f) == ["ignored-argument"]
    assert "epoch" in f[0].message


def test_ignored_argument_never_read_without_del():
    f = _lint("""
        def scale(x, factor):
            return x
    """)
    assert _rules(f) == ["ignored-argument"]


def test_ignored_argument_exemptions():
    assert _lint('''
        import abc

        def _private(x, unused):
            return x

        def public(x, _unused):
            return x

        def stub(x, y):
            """Protocol stub."""
            ...

        def not_impl(x, y):
            raise NotImplementedError

        class C:
            def method(self, x):
                return x

            @abc.abstractmethod
            def abstract(self, x, y):
                return x

        def outer(x):
            def inner(a, b):
                return a
            return inner(x, x)
    ''') == []


# -- bit accounting -----------------------------------------------------------------

F32_BITS = """
    def record(state, inc):
        return state._replace(bits=state.bits + inc)
"""


def test_plain_f32_bits_accumulation_caught_by_exactly_one_rule():
    assert _rules(_lint(F32_BITS)) == ["bits-accounting"]


def test_bits_augassign_flagged_and_api_module_exempt():
    f = _lint("""
        def acc(self, inc):
            self.bits += inc
    """)
    assert _rules(f) == ["bits-accounting"]
    assert _lint("""
        def accumulate_bits(bits, bits_lo, inc):
            return bits + inc, bits_lo - inc
    """, rel="src/repro_torch/core/api.py") == []


def test_bits_lookalike_names_not_flagged():
    assert _lint("""
        nbits = 3
        total = nbits + 4
        orbits = [1] + [2]
    """) == []


# -- kernel imports -------------------------------------------------------------------


def test_kernel_import_flagged_outside_backend():
    for src in ("from repro_torch.kernels.randk import randk_compress\n",
                "from repro_torch.kernels.pack import pack_slab\n",
                "import repro_torch.kernels.diana_shift\n",
                "from repro_torch.kernels._build import library\n",
                "from repro_torch.kernels.ref import pack_slab_ref\n"):
        f = lint_source(src, "src/repro_torch/core/dist.py")
        assert _rules(f) == ["kernel-import"], src


def test_kernel_import_allowed_in_backend_and_kernels():
    src = "from repro_torch.kernels.pack import pack_slab\n"
    assert lint_source(src, "src/repro_torch/compression/backend.py") == []
    assert lint_source(src, "src/repro_torch/kernels/ref.py") == []
    f = lint_source(src, "src/repro_torch/compression/ops.py")
    assert _rules(f) == ["kernel-import"]


def test_kernel_counts_helpers_and_census_import_anywhere():
    for src in ("from repro_torch.kernels.ref import randk_scale\n",
                "from repro_torch.kernels.ref import BLOCK_ROWS\n",
                "from repro_torch.kernels import LAUNCHES, reset_launches\n",
                "from repro_torch.kernels import census\n",
                "from repro_torch.kernels.census import recording\n"):
        assert lint_source(src, "src/repro_torch/launch/steps.py") == [], src


# -- host syncs inside the steps -----------------------------------------------------


def test_trace_hazard_in_a_step_module():
    f = _lint("""
        import time

        def mix(x):
            t0 = time.time()
            return x.sum().item() * t0
    """, rel="src/repro_torch/models/layers.py")
    assert _rules(f) == ["trace-hazard", "trace-hazard"]


def test_trace_hazard_reaches_from_the_step_factories():
    f = _lint("""
        import torch

        def helper(x):
            return x.cpu().numpy()

        def make_train_step(cfg):
            def step(x):
                return helper(x) + float(torch.sum(x)) * cfg
            return step

        def unrelated(x):
            return x.tolist()
    """, rel="src/repro_torch/launch/steps.py")
    assert sorted(_rules(f)) == ["trace-hazard"] * 3
    assert {f_.line for f_ in f} == {5, 9}


def test_trace_hazard_outside_the_steps_is_fine():
    assert _lint("""
        import time

        def wall_clock(x):
            return time.time(), x.item()
    """, rel="src/repro_torch/launch/train.py") == []


def test_trace_hazard_cast_heuristic():
    f = _lint("""
        import torch

        def norm(x):
            return float(torch.linalg.norm(x))
    """, rel="src/repro_torch/core/dist.py")
    assert _rules(f) == ["trace-hazard"]
    assert _lint("""
        def geometry(fraction, size):
            return int(fraction * size)
    """, rel="src/repro_torch/core/dist.py") == []


# -- suppression semantics ---------------------------------------------------------------


def test_allow_with_rationale_suppresses():
    assert _lint("""
        import torch
        torch.manual_seed(0)  # analysis: allow[rng-unstructured-seed] test fixture stream
    """) == []


def test_allow_without_rationale_is_a_finding():
    f = _lint("""
        import torch
        torch.manual_seed(0)  # analysis: allow[rng-unstructured-seed]
    """)
    assert sorted(_rules(f)) == ["allow-missing-rationale",
                                 "rng-unstructured-seed"]


def test_stale_allow_is_a_finding():
    f = _lint("""
        x = 1  # analysis: allow[bits-accounting] nothing here violates it
    """)
    assert _rules(f) == ["stale-allow"]


def test_comment_only_line_allow_covers_next_code_line():
    assert _lint("""
        import torch
        # analysis: allow[rng-unstructured-seed] fixture stream; continuation
        # comments between the annotation and the code are fine
        torch.manual_seed(0)
    """) == []


def test_docstring_mention_is_not_an_annotation():
    f = _lint('''
        import torch

        def doc():
            """Write `# analysis: allow[rng-unstructured-seed] why` inline."""
            return torch.manual_seed(0)
    ''')
    assert _rules(f) == ["rng-unstructured-seed"]


def test_rule_catalog_covers_every_emitted_rule():
    cat = rule_catalog()
    for rule in ("rng-unstructured-seed", "rng-literal-salt",
                 "ignored-argument", "bits-accounting", "kernel-import",
                 "trace-hazard", "allow-missing-rationale", "stale-allow",
                 "syntax-error"):
        assert rule in cat, rule
    from repro.analysis import graph as ref_graph
    from repro_torch.analysis import graph

    assert set(graph.RULES) == set(ref_graph.RULES)  # the reference's names
    for rule in graph.RULES:
        assert rule not in cat  # the census's rules are layer 2's


# -- the port itself ------------------------------------------------------------------------


def test_port_lints_clean():
    findings = lint_paths([REPO / "src" / "repro_torch"], repo_root=REPO)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_every_allow_states_its_reason():
    from repro_torch.analysis.lint import parse_annotations

    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        allows, missing = parse_annotations(path.read_text(), str(path))
        assert missing == [], missing


def test_lint_cli_imports_no_torch():
    code = ("import sys; from repro_torch.analysis.__main__ import main; "
            "rc = main(['--lint']); "
            "print(rc, 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["0", "False"]


# -- layer 2: the step census against the reference's wire accounting ----------------------

CENSUS = [(label, shape, axes, method, "f32")
          for label, shape, axes in (("flat", (4, 1), ("data", "model")),
                                     ("two_pod", (2, 2, 1),
                                      ("pod", "data", "model")))
          for method in ("q", "diana", "diana_rr", "ef")]
CENSUS += [(label, shape, axes, method, "packed8")
           for label, shape, axes in (("flat", (4, 1), ("data", "model")),
                                      ("two_pod", (2, 2, 1),
                                       ("pod", "data", "model")))
           for method in ("q", "diana_rr")]
CENSUS += [("flat", (4, 1), ("data", "model"), "diana", w)
           for w in ("packed4", "bf16")]


@pytest.fixture(scope="module")
def census_cfgs():
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro_torch.configs import get_config, reduced

    return (reduced(get_config("stablelm-1.6b"), seq=16),
            ref_reduced(ref_get_config("stablelm-1.6b"), seq=16))


def _reference_wire(ref_cfg, shape, axes, method, wire_dtype):
    """The reference's wire_bytes_per_round on the same config and mesh."""
    import jax
    import jax.numpy as jnp

    from repro.core import salts
    from repro.core.dist import CompressedAggregation
    from repro.launch import steps as ref_steps
    from repro.launch.mesh import make_test_mesh
    from repro.models import transformer as ref_transformer

    mesh = make_test_mesh(shape, axes)
    agg = ref_steps.configure_agg(
        CompressedAggregation(method=method, wire="shared", fraction=0.25,
                              shift_dtype=jnp.float32, wire_dtype=wire_dtype,
                              n_slots=2 if method == "diana_rr" else 1),
        mesh, 1)
    params = jax.eval_shape(lambda: ref_transformer.init_params(
        salts.root_key(0, salts.PARAMS_KEY_SALT), ref_cfg))
    return agg.wire_bytes_per_round(params), len(jax.tree.leaves(params))


@pytest.mark.parametrize("label,shape,axes,method,wire_dtype", CENSUS,
                         ids=[f"{c[0]}-{c[3]}-{c[4]}" for c in CENSUS])
def test_census_carries_the_reference_wire_bytes(census_cfgs, label, shape,
                                                 axes, method, wire_dtype):
    """Each wire level's gathers of one process (one client a process) on
    fake tensors: one a leaf (two on packed wires) whose operand bytes sum
    to the reference's analytic wire bytes; the full census clean."""
    from repro_torch.analysis import graph
    from repro_torch.launch.mesh import make_mesh

    cfg, ref_cfg = census_cfgs
    run = graph._trace_step(cfg, make_mesh(shape, axes), method,
                            wire_dtype=wire_dtype)
    ref, n_leaves = _reference_wire(ref_cfg, shape, axes, method, wire_dtype)
    assert len(run["params"]) == n_leaves
    per_leaf = 2 if wire_dtype.startswith("packed") else 1
    levels = graph.wire_census(run["records"])
    want = {"inner": (per_leaf * n_leaves, ref["intra_pod"])}
    if label == "two_pod":
        want["outer"] = (per_leaf * n_leaves, ref["inter_pod"])
    assert levels == want
    assert not any(r.level == "model" for r in run["records"])


def test_census_matches_the_reference_jaxpr_census(census_cfgs):
    """One f32 DIANA step on (4, 1): the reference's traced step (no
    compile) psums over "data" exactly the bytes the port's process
    gathers over "inner", one collective a leaf in both."""
    import jax
    import jax.numpy as jnp

    from repro.analysis import graph as ref_graph
    from repro.core import salts
    from repro.core.dist import CompressedAggregation
    from repro.launch import compat
    from repro.launch import steps as ref_steps
    from repro.launch.mesh import make_test_mesh
    from repro_torch.analysis import graph
    from repro_torch.launch.mesh import make_mesh

    cfg, ref_cfg = census_cfgs
    mesh = make_test_mesh((4, 1), ("data", "model"))
    agg = CompressedAggregation(method="diana", wire="shared", fraction=0.25,
                                shift_dtype=jnp.float32)
    jitted, abstract, _, _ = ref_steps.make_train_step(
        ref_cfg, mesh, agg=agg, remat=False, seq_shard=False)
    batch = {"tokens": jax.ShapeDtypeStruct((8, ref_cfg.max_seq + 1),
                                            jnp.int32)}
    key = jax.ShapeDtypeStruct(
        (), salts.root_key(0, salts.ROUNDS_KEY_SALT).dtype)
    with compat.set_mesh(mesh):
        traced = jitted.trace(abstract, batch, key)
    ref = ref_graph.collective_census(traced.jaxpr.jaxpr)
    run = graph._trace_step(cfg, make_mesh((4, 1), ("data", "model")),
                            "diana")
    assert graph.wire_census(run["records"]) == {"inner": ref[("data",)]}


def test_census_detects_a_broken_wire_model(census_cfgs, monkeypatch):
    """The census fires when the analytic accounting is corrupted."""
    import dataclasses

    from repro_torch.analysis import graph
    from repro_torch.launch.mesh import make_mesh

    real = graph._trace_step

    def corrupted(*a, **kw):
        run = real(*a, **kw)
        run["agg"] = dataclasses.replace(run["agg"],
                                         fraction=run["agg"].fraction / 2)
        return run

    monkeypatch.setattr(graph, "_trace_step", corrupted)
    findings = graph.check_step(census_cfgs[0],
                                make_mesh((4, 1), ("data", "model")),
                                "diana", "flat")
    assert [f.rule for f in findings] == ["census-collective-bytes"]


def test_census_elastic_and_telemetry_checks_clean(census_cfgs):
    from repro_torch import telemetry
    from repro_torch.analysis import graph
    from repro_torch.launch.mesh import make_mesh

    flat = make_mesh((4, 1), ("data", "model"))
    assert graph.check_elastic(census_cfgs[0], flat, "flat") == []
    assert graph.check_telemetry_identity(census_cfgs[0], flat, "flat") == []
    assert telemetry.active() is None


def test_census_tables_stay_in_place_and_dtypes_hold(census_cfgs):
    from repro_torch.analysis import graph
    from repro_torch.launch.mesh import make_mesh

    findings = graph.check_step(census_cfgs[0],
                                make_mesh((2, 2, 1), ("pod", "data", "model")),
                                "diana_rr", "two_pod", wire_dtype="packed8")
    assert findings == []
