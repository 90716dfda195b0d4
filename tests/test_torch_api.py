"""The port's top-level API against the JAX package's: the same public
names, each resolving in the port, and the parsers giving the same
parameters."""

import dataclasses
import enum

import pytest

import pyarrowspace_tpu as jx
import pyarrowspace_tpu_torch as pt


def _fields(params) -> dict:
    """A parameter dataclass as a dict, enums by value (the two packages
    each define their own TauMode)."""
    return {key: value.value if isinstance(value, enum.Enum) else value
            for key, value in dataclasses.asdict(params).items()}


def test_all_names_match_the_reference():
    assert set(pt.__all__) == set(jx.__all__)


@pytest.mark.parametrize("name", sorted(jx.__all__))
def test_each_name_resolves_in_the_port(name):
    assert hasattr(pt, name)


def test_parsers_match_the_reference():
    gp = {"eps": 0.9, "k": 6, "topk": 4, "p": 2.0, "sigma": 0.3}
    assert (_fields(pt.parse_graph_params(gp))
            == _fields(jx.parse_graph_params(gp)))
    ep = {"optical_tokens": 40, "eta": 0.2}
    assert (_fields(pt.parse_energy_params(ep))
            == _fields(jx.parse_energy_params(ep)))
    assert _fields(pt.EnergyParams()) == _fields(jx.EnergyParams())
