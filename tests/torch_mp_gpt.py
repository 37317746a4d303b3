"""A GPT built from the fleet's tensor-parallel Layers through the Paddle
API, in the shape of Paddle's test/collective/fleet/
hybrid_parallel_mp_model.py: ``VocabParallelEmbedding`` for the tokens,
a replicated position embedding, pre-LayerNorm blocks of a
``ColumnParallelLinear`` qkv (columns laid out a head at a time: q, k,
v of head 0, then head 1, ...; so that a rank's block of columns is its
heads), causal ``scaled_dot_product_attention`` on the rank's heads, a
``RowParallelLinear`` projection, a ``ColumnParallelLinear`` /
``RowParallelLinear`` MLP with gelu, and a ``ColumnParallelLinear`` head
feeding ``ParallelCrossEntropy``. Test code: it names no JAX and no
torch, only the package it is given (``paddle_tpu`` or
``paddle_tpu_torch``), so that both build the same model.

``recompute`` wraps every block in ``fleet.recompute``.
"""

from dataclasses import dataclass


@dataclass
class MPGPTConfig:
    vocab_size: int = 256
    hidden: int = 64
    n_layers: int = 2
    n_heads: int = 4
    seq_len: int = 16


def gpt3_1p3b() -> MPGPTConfig:
    """GPT-3 1.3B's widths (hidden 2048, 24 layers, 16 heads of 128,
    vocabulary 50304 padded as Megatron pads it), S 1024."""
    return MPGPTConfig(vocab_size=50304, hidden=2048, n_layers=24,
                       n_heads=16, seq_len=1024)


def build(pkg, cfg: MPGPTConfig, recompute: bool = False):
    """The model as a ``pkg.nn.Layer``; its ``loss(tokens, labels)``
    is the mean cross-entropy of the next-token labels."""
    nn = pkg.nn
    F = nn.functional
    fleet = pkg.distributed.fleet
    H, d = cfg.hidden, cfg.hidden // cfg.n_heads

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(H)
            self.qkv = fleet.ColumnParallelLinear(H, 3 * H,
                                                  gather_output=False)
            self.proj = fleet.RowParallelLinear(H, H, input_is_parallel=True)
            self.ln2 = nn.LayerNorm(H)
            self.fc1 = fleet.ColumnParallelLinear(H, 4 * H,
                                                  gather_output=False)
            self.fc2 = fleet.RowParallelLinear(4 * H, H,
                                               input_is_parallel=True)

        def forward(self, x):
            B, S = x.shape[0], x.shape[1]
            qkv = self.qkv(self.ln1(x)).reshape([B, S, -1, 3, d])
            q, k, v = (t.squeeze(3) for t in pkg.split(qkv, 3, axis=3))
            a = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + self.proj(a.reshape([B, S, -1]))
            return x + self.fc2(F.gelu(self.fc1(self.ln2(x)),
                                       approximate=True))

    class MPGPT(nn.Layer):
        def __init__(self):
            super().__init__()
            self.wte = fleet.VocabParallelEmbedding(cfg.vocab_size, H)
            self.wpe = nn.Embedding(cfg.seq_len, H)
            self.blocks = nn.LayerList([Block() for _ in range(cfg.n_layers)])
            self.ln_f = nn.LayerNorm(H)
            self.head = fleet.ColumnParallelLinear(H, cfg.vocab_size,
                                                   has_bias=False,
                                                   gather_output=False)
            self.ce = fleet.ParallelCrossEntropy()

        def forward(self, tokens):
            S = tokens.shape[1]
            pos = pkg.arange(S, dtype="int64").unsqueeze(0)
            x = self.wte(tokens) + self.wpe(pos)
            for blk in self.blocks:
                x = fleet.recompute(blk, x) if recompute else blk(x)
            return self.head(self.ln_f(x))

        def loss(self, tokens, labels):
            return self.ce(self(tokens), labels).mean()

    return MPGPT()


def batch(cfg: MPGPTConfig, B: int, seed: int = 0):
    """Tokens and next-token labels [B, S] (int64 numpy) from a seed."""
    import numpy as np

    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, cfg.seq_len + 1))
    return toks[:, :-1].astype(np.int64), toks[:, 1:].astype(np.int64)
