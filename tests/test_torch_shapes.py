"""The port's input shapes (`repro_torch.configs.shapes`) against the
reference's (`repro.configs.shapes`): the four shapes' names, lengths,
batches and kinds, and which of the ten configurations take each (with
the reference's reasons), exactly."""
import dataclasses

import pytest

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jax_shapes
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs import shapes


def test_input_shapes_match_reference():
    assert list(shapes.INPUT_SHAPES) == list(jax_shapes.INPUT_SHAPES)
    for name, shape in shapes.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            jax_shapes.INPUT_SHAPES[name]), name


@pytest.mark.parametrize("shape", sorted(jax_shapes.INPUT_SHAPES))
@pytest.mark.parametrize("name", JAX_ARCH_NAMES)
def test_shape_supported_matches_reference(name, shape):
    assert name in ARCH_NAMES
    assert shapes.shape_supported(
        get_config(name), shapes.INPUT_SHAPES[shape]) == \
        jax_shapes.shape_supported(jax_get_config(name),
                                   jax_shapes.INPUT_SHAPES[shape])


def test_long_500k_takes_the_sub_quadratic_configs():
    """long_500k's one request over 524,288 slots: rwkv6-7b, hymba-1.5b
    and starcoder2-15b."""
    long = shapes.INPUT_SHAPES["long_500k"]
    assert (long.seq_len, long.global_batch) == (524_288, 1)
    assert [n for n in ARCH_NAMES
            if shapes.shape_supported(get_config(n), long)[0]] == [
        "rwkv6-7b", "hymba-1.5b", "starcoder2-15b"]
