"""Shared by the eager-API parity tests (tests/test_torch_{core,ops,
optimizer,amp,eager_gpt,nn_*,bert}.py): import the fixtures into a test
module to use them.

The suite's per-test ``gc.collect()`` (tests/conftest.py) walks every
object the two frameworks hold, ~0.2 s a test once both are loaded.
These modules' cases make no cycles that need collecting between them,
so the heap stays frozen while a module runs and is collected once at
its end."""

import gc

import pytest


@pytest.fixture(autouse=True, scope="module")
def frozen_heap():
    gc.collect()
    gc.freeze()
    yield
    gc.unfreeze()
    gc.collect()


@pytest.fixture(autouse=True)
def freeze_after_case():
    yield
    gc.freeze()


@pytest.fixture(autouse=True, scope="module")
def reference_ops_restored():
    """Some reference Layers register a funnel op when first called (the
    spectral and weight norms' power iteration and recompute); drop what
    a module's cases registered in the reference's registry, which its
    own tests inventory (tests/test_grad_coverage.py)."""
    from paddle_tpu.core import dispatch

    before = set(dispatch.OP_REGISTRY)
    yield
    for name in set(dispatch.OP_REGISTRY) - before:
        dispatch.unregister_op(name)
