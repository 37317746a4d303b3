"""SEP: segment (sequence-axis) parallelism (the port's copy of
paddle_tpu/distributed/fleet/meta_parallel/segment_parallel.py;
reference fleet/meta_parallel/segment_parallel.py:26 and the pattern of
test/collective/fleet/hybrid_parallel_sep_model.py:143-145).

The model splits the sequence over the sep group before attention
(``split_sequence``: this rank's block, its gradient all-gathered back)
and joins it after (``concat_sequence``: all-gather, its gradient split).
``SegmentParallel`` broadcasts the parameters across sep (and dp) from
rank 0 at wrap time, and sums each parameter's gradient over sep once
it is accumulated: a rank's gradient covers the tokens of its segment.
"""

from __future__ import annotations

from ....core.tensor import Tensor
from ...autograd_collectives import c_concat, c_split
from ...collective import _pg, all_reduce
from ...parallel import MetaParallelBase, broadcast_parameters
from ...topology import get_hybrid_communicate_group
from ..mp_layers import _on

__all__ = ["SegmentParallel", "split_sequence", "concat_sequence"]


def _hcg():
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        raise RuntimeError("fleet.init must run before segment parallel")
    return hcg


def split_sequence(x: Tensor, axis: int = 1) -> Tensor:
    """This sep rank's block of the sequence dim ``axis``."""
    return _on(c_split, x, axis, _hcg().get_sep_parallel_group())


def concat_sequence(x: Tensor, axis: int = 1) -> Tensor:
    """The sep ranks' blocks concatenated along ``axis``."""
    return _on(c_concat, x, axis, _hcg().get_sep_parallel_group())


class SegmentParallel(MetaParallelBase):
    def __init__(self, layers, hcg=None, strategy=None):
        hcg = hcg or _hcg()
        super().__init__(layers, hcg, strategy)
        sep = hcg.get_sep_parallel_group()
        broadcast_parameters(layers, sep, distributed_too=True)
        broadcast_parameters(layers, hcg.get_data_parallel_group(),
                             distributed_too=True)
        if _pg(sep) is not None:
            def summed(t):
                all_reduce(t.grad, group=sep)

            for p in layers.parameters():
                if not p.stop_gradient:
                    p._data.register_post_accumulate_grad_hook(summed)
