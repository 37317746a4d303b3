"""Every op of the port's nn/functional loss module against the
reference's (``torch_nn_common.check_op``: the reference's contract
cases and cases written there, among them cross-entropy's hard labels
with ``ignore_index``, weights, ``axis``, label smoothing and soft
labels, and the CTC and transducer losses; forward within rtol 1e-6,
vjp within rtol 1e-5), and the loss functions that are not one op."""

import torch_cpu_threads  # noqa: F401  (first: sets torch's CPU threads)
import pytest

from torch_eager_common import (freeze_after_case, frozen_heap,  # noqa: F401
                                reference_ops_restored)
from torch_nn_common import _f, _i, cases, check_op, same_fn


@pytest.mark.parametrize("name,i", cases(("loss",)))
def test_op_against_reference(name, i):
    check_op(name, i)


def test_softmax_with_cross_entropy():
    same_fn("softmax_with_cross_entropy", [_f(4, 5), _i(0, 3, 1, 4,
                                                        shape=(4, 1))],
            {"return_softmax": True})


def test_triplet_margin_with_distance_function():
    def dist(a, b):
        return ((a - b) * (a - b)).sum(axis=-1)

    args = [_f(3, 4), _f(3, 4, seed=1), _f(3, 4, seed=2)]
    for fn in (None, dist):
        for swap in (False, True):
            same_fn("triplet_margin_with_distance_loss", args,
                    {"distance_function": fn, "swap": swap})
