"""``PORT_MANIFEST`` against the JAX package's ``HOT_PROGRAMS``: every
reference name (``hot_programs.collect()``) is a key, every twin
resolves by ``importlib`` to an attribute of the port, and the pending
set is exactly the one the port states."""

from __future__ import annotations

import ast
import importlib
import os

import pytest

from k8s_spot_rescheduler_tpu.hot_programs import collect
from k8s_spot_rescheduler_tpu_torch import port_manifest

REFERENCE = sorted(collect())


def _resolve(qualified: str):
    """The object a ``module:attr.attr`` name refers to."""
    module, _, attrs = qualified.partition(":")
    obj = importlib.import_module(module)
    for attr in attrs.split("."):
        obj = getattr(obj, attr)
    return obj


PENDING = set()


def test_every_reference_name_is_a_key_and_nothing_else():
    assert len(REFERENCE) == 24
    assert sorted(port_manifest.PORT_MANIFEST) == REFERENCE


def test_the_pending_set_is_exact():
    assert port_manifest.pending() == PENDING


@pytest.mark.parametrize("name", REFERENCE)
def test_each_twin_resolves_to_the_port(name):
    twins = port_manifest.twins(name)
    assert bool(twins) == (name not in PENDING)
    for qualified in twins:
        assert qualified.startswith("k8s_spot_rescheduler_tpu_torch.")
        assert callable(_resolve(qualified)), qualified


def test_the_manifest_is_plain_data():
    """It imports nothing of the port (nor anything heavy)."""
    path = port_manifest.__file__
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            top.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            top.add(node.module.split(".")[0])
    assert top <= {"__future__", "typing"}, top
    assert os.path.basename(path) == "port_manifest.py"
