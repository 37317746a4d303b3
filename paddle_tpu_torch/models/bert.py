"""BERT: the masked-LM encoder (port of paddle_tpu/models/bert.py;
BASELINE.md config 2, BERT-base pretraining).

Built wholly from the port's nn layers: the embeddings, a post-LN
``TransformerEncoder`` whose ``MultiHeadAttention`` reaches
``F.scaled_dot_product_attention`` (K1-sep / K3-sep with no mask and no
attention dropout, the plain expression otherwise), the pooler, and the
pretraining heads with the MLM decoder tied to the word embeddings.
The data-parallel half of the reference's config (``DataParallel``) is
not ported yet.
"""

from __future__ import annotations

import dataclasses

from .. import nn
from ..ops import creation as _creation

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertPretrainingCriterion", "bert_base", "bert_large"]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


def bert_base() -> BertConfig:
    return BertConfig()


def bert_large() -> BertConfig:
    return BertConfig(hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size,
                                       epsilon=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        B, T = input_ids.shape
        if position_ids is None:
            position_ids = _creation.arange(T, dtype="int64").unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = _creation.zeros([B, T], dtype="int64")
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Layer):
    """Encoder over the framework's TransformerEncoder (post-LN like BERT)."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = BertEmbeddings(cfg)
        layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation=cfg.hidden_act,
            attn_dropout=cfg.attention_probs_dropout_prob,
            act_dropout=0.0, normalize_before=False)
        self.encoder = nn.TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        seq = self.encoder(x, attention_mask)
        pooled = self.pooler(seq[:, 0]).tanh()
        return seq, pooled


class BertForPretraining(nn.Layer):
    """MLM + NSP heads, embeddings tied to the MLM decoder."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.transform_ln = nn.LayerNorm(cfg.hidden_size,
                                         epsilon=cfg.layer_norm_eps)
        self.decoder_bias = self.create_parameter(
            [cfg.vocab_size], is_bias=True)
        self.nsp = nn.Linear(cfg.hidden_size, 2)
        self.act = nn.GELU()

    def forward(self, input_ids, token_type_ids=None):
        seq, pooled = self.bert(input_ids, token_type_ids)
        h = self.transform_ln(self.act(self.transform(seq)))
        # tied decoder: h @ wte.T + b
        wte = self.bert.embeddings.word_embeddings.weight
        mlm_logits = h.matmul(wte, transpose_y=True) + self.decoder_bias
        nsp_logits = self.nsp(pooled)
        return mlm_logits, nsp_logits


class BertPretrainingCriterion(nn.Layer):
    def __init__(self, vocab_size: int):
        super().__init__()
        self.vocab_size = vocab_size

    def forward(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels,
                masked_positions=None):
        F = nn.functional
        mlm = F.cross_entropy(mlm_logits.reshape([-1, self.vocab_size]),
                              mlm_labels.reshape([-1]), ignore_index=-100)
        nsp = F.cross_entropy(nsp_logits, nsp_labels)
        return mlm + nsp
