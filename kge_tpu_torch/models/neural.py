"""Neural scorers: ConvE and the Transformer ("no context" HittER) model.

The port of kge_tpu/models/neural.py (reference kge/model/{conve,
transformer}.py). Both score (s, p, ?) queries only and are meant to be
wrapped in the reciprocal relations model. Their parameters (convolution,
projection, encoder weights) are ``nn.Parameter``s of the scorer, which
gives them as kge_tpu's ``params["scorer"]`` tree (``param_tree``); ConvE's
batch-norm running statistics are buffers beside them.

Each model mirrors kge_tpu's computation op for op rather than calling
``torch.nn``'s layers, whose semantics differ:

- Batch norm is kge_tpu's ``_batch_norm`` (neural.py:30-55), not
  ``nn.BatchNorm*``: no affine parameters; in train mode the scorer
  normalizes by the biased batch statistics and computes the running update
  from the stored (old) statistics, ``(1 - 0.1) * old + 0.1 * batch`` with
  the variance unbiased by ``n / (n - 1)``, and writes it only into the
  training step's collector (``RelationalScorer.stats``): several scoring
  calls of one step do not chain, the last one's update wins, and the step
  writes it after the optimizer update. In eval mode the stored statistics
  normalize. Under a data axis a rank holds only its rows of the batch:
  the statistics are the whole batch's, summed over the data group
  (``_whole_batch_moments``), and equal in every bit on every rank.
- The convolution is ``F.conv2d`` on NCHW (kge_tpu convolves NHWC with the
  kernel stored OIHW); the feature maps are flattened in torch's
  [N, C, H, W] order, as kge_tpu transposes to. Feature-map dropout is
  elementwise, as kge_tpu draws it (not ``Dropout2d``).
- The Transformer's layers are kge_tpu's ``_attention`` and
  ``_encoder_layer``: post-norm, ``in_proj`` packing q, k and v, explicit
  products and ``softmax`` (not ``nn.MultiheadAttention`` or
  ``nn.TransformerEncoderLayer``, whose eval-mode fast path computes
  otherwise), dropout on the attention weights, both residual branches and
  inside the feed-forward; ``gelu`` is ``jax.nn.gelu``'s default, the tanh
  approximation.

Both scores are linear in the object embedding: ConvE's is
``[1 | h] . o_emb`` with ``h`` the network's output after the second batch
norm and ReLU and the per-entity bias in column 0, the Transformer's
``CLS' . o_emb``. So in eval mode each gives a ``factorize_slot`` for the
object slot and evaluation ranks it with the rank kernel
(ops/rank_kernel.py). In train mode they give none: training keeps
kge_tpu's flat routes (``score_sp`` against the whole vocabulary or the
sampled targets), and with them the batch statistics it normalizes by.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from kge_tpu_torch.models.base import KgeModel, RelationalScorer, make_initializer
from kge_tpu_torch.parallel.mesh import DataSum


def _variance(x: torch.Tensor, dims) -> torch.Tensor:
    """``jnp.var`` (ddof 0) as it computes it: the mean of the squared
    deviations from the mean."""
    centered = x - torch.mean(x, dim=dims, keepdim=True)
    return torch.mean(centered * centered, dim=dims)


def _whole_batch_moments(x: torch.Tensor, dims, mesh):
    """(mean, biased variance, count) over ``dims`` of the batch whose rows
    (dimension 0) the ranks of ``mesh``'s data group hold in equal parts,
    ``x`` this rank's: kge_tpu's ``jnp.mean`` and ``jnp.var`` of the
    batch-sharded array, which GSPMD takes over the whole batch. The mean is
    the group's sum of the ranks' sums over the whole count, the variance
    the group's sum of squared deviations from it over the whole count
    (``DataSum``: the same in every bit on every rank, the gradient summed
    over the group)."""
    n = math.prod(x.shape[d] for d in dims) * mesh.data
    mean = DataSum.apply(torch.sum(x, dim=dims), mesh) / n
    shape = [1 if i in dims else x.shape[i] for i in range(x.dim())]
    centered = x - mean.reshape(shape)
    var = DataSum.apply(torch.sum(centered * centered, dim=dims), mesh) / n
    return mean, var, n


class ConvEScorer(RelationalScorer):
    """2D-convolution scorer (reference conve.py:9-103; kge_tpu
    ``ConvEScorer``).

    The first embedding component is a per-entity bias; the s and p
    embeddings without it are reshaped to 2D maps, stacked vertically,
    convolved with 32 filters, batch-normed, projected back to the
    embedding dimension, batch-normed again and dotted with the object
    embedding.
    """

    def __init__(self, config, dataset, configuration_key=None, device=None):
        super().__init__(config, dataset, configuration_key)
        self.emb_dim = self.get_option("entity_embedder.dim") - 1
        aspect_ratio = self.get_option("2D_aspect_ratio")
        self.emb_height = math.sqrt(self.emb_dim / aspect_ratio)
        self.emb_width = self.emb_height * aspect_ratio
        rounded_height = math.ceil(self.emb_height)
        if self.get_option("round_dim") and rounded_height != self.emb_height:
            self.emb_height = rounded_height
            self.emb_width = self.emb_height * aspect_ratio
            self.emb_dim = int(self.emb_height * self.emb_width)
            self.set_option("entity_embedder.dim", self.emb_dim + 1, log=True)
            self.set_option("relation_embedder.dim", self.emb_dim + 1, log=True)
            config.log(
                "Rounded embedding dimension up to {} to match aspect ratio".format(
                    self.emb_dim
                )
            )
        elif self.emb_dim % self.emb_height or self.emb_dim % self.emb_width:
            raise ValueError(
                "Embedding dimension {} incompatible with aspect ratio {}; "
                "set {}.round_dim=true or adapt the dimension".format(
                    self.emb_dim, aspect_ratio, self.configuration_key
                )
            )
        self.emb_height = int(self.emb_height)
        self.emb_width = int(self.emb_width)
        self.filter_size = int(self.get_option("filter_size"))
        self.stride = int(self.get_option("stride"))
        self.padding = int(self.get_option("padding"))
        self.feature_map_dropout = float(self.get_option("feature_map_dropout"))
        self.projection_dropout = float(self.get_option("projection_dropout"))
        self.convolution_bias = bool(self.get_option("convolution_bias"))
        self.out_channels = 32
        self.conv_output_height = (
            (self.emb_height * 2) - self.filter_size + 2 * self.padding
        ) // self.stride + 1
        self.conv_output_width = (
            self.emb_width - self.filter_size + 2 * self.padding
        ) // self.stride + 1
        self.flat_size = int(
            self.out_channels * self.conv_output_height * self.conv_output_width
        )

        def empty(*shape):
            return torch.empty(*shape, dtype=torch.float32, device=device)

        # kge_tpu's conv_w is OIHW, F.conv2d's weight layout
        self.conv_w = nn.Parameter(
            empty(self.out_channels, 1, self.filter_size, self.filter_size)
        )
        self.conv_b = (
            nn.Parameter(empty(self.out_channels)) if self.convolution_bias
            else None
        )
        self.proj_w = nn.Parameter(empty(self.emb_dim, self.flat_size))
        self.proj_b = nn.Parameter(empty(self.emb_dim))
        for name, size, value in (
            ("bn1_mean", self.out_channels, 0.0), ("bn1_var", self.out_channels, 1.0),
            ("bn2_mean", self.emb_dim, 0.0), ("bn2_var", self.emb_dim, 1.0),
        ):
            self.register_buffer(name, empty(size).fill_(value))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        # torch Conv2d/Linear default init, as kge_tpu draws it:
        # kaiming_uniform(a=sqrt(5)) for weights, uniform(+-1/sqrt(fan_in))
        # for biases
        kaiming = make_initializer("kaiming_uniform_", {"a": math.sqrt(5.0)})
        kaiming(self.conv_w, generator)
        kaiming(self.proj_w, generator)
        bound = 1.0 / math.sqrt(self.flat_size)
        self.proj_b.uniform_(-bound, bound, generator=generator)
        if self.conv_b is not None:
            bound = 1.0 / math.sqrt(self.filter_size * self.filter_size)
            self.conv_b.uniform_(-bound, bound, generator=generator)
        for name in ("bn1_mean", "bn2_mean"):
            getattr(self, name).zero_()
        for name in ("bn1_var", "bn2_var"):
            getattr(self, name).fill_(1.0)

    def param_tree(self) -> Dict[str, Any]:
        tree = {
            name: getattr(self, name)
            for name in ("conv_w", "proj_w", "proj_b", "bn1_mean", "bn1_var",
                         "bn2_mean", "bn2_var")
        }
        if self.conv_b is not None:
            tree["conv_b"] = self.conv_b
        return tree

    def _batch_norm(self, x, mean_key: str, var_key: str, dims, eps=1e-5,
                    momentum=0.1):
        """kge_tpu's ``_batch_norm`` over ``dims`` (all but the channel
        dimension); see the module's docstring. Where the rank holds only
        its rows of the batch (``dropout_rows`` under a data axis), the
        statistics are the whole batch's (``_whole_batch_moments``)."""
        if self.training:
            if self.dropout_rows is not None and self.batch_mesh is not None:
                mean, var, n = _whole_batch_moments(x, dims, self.batch_mesh)
            else:
                mean = torch.mean(x, dim=dims)
                var = _variance(x, dims)
                n = math.prod(x.shape[d] for d in dims)
            if self.stats is not None:
                unbiased = var.detach() * n / max(n - 1, 1)
                self.stats[mean_key] = (
                    (1 - momentum) * getattr(self, mean_key)
                    + momentum * mean.detach()
                )
                self.stats[var_key] = (
                    (1 - momentum) * getattr(self, var_key) + momentum * unbiased
                )
        else:
            mean = getattr(self, mean_key)
            var = getattr(self, var_key)
        shape = [1 if i in dims else x.shape[i] for i in range(x.dim())]
        return (x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)

    def _hidden(self, s_emb, p_emb) -> torch.Tensor:
        """The network's output [n, d] for the (s, p) rows, after the second
        batch norm and ReLU."""
        n = p_emb.shape[0]
        s_2d = s_emb[:, 1:].reshape(-1, 1, self.emb_height, self.emb_width)
        p_2d = p_emb[:, 1:].reshape(-1, 1, self.emb_height, self.emb_width)
        stacked = torch.cat([s_2d, p_2d], dim=2)  # NCHW
        out = F.conv2d(stacked, self.conv_w, None, self.stride, self.padding)
        if self.conv_b is not None:
            out = out + self.conv_b[:, None, None]
        out = self._batch_norm(out, "bn1_mean", "bn1_var", (0, 2, 3))
        out = torch.relu(out)
        out = self._dropout(out, self.feature_map_dropout)
        out = out.reshape(n, -1)  # torch's [N, C, H, W] flattening order
        out = out @ self.proj_w.T + self.proj_b
        out = self._dropout(out, self.projection_dropout)
        out = self._batch_norm(out, "bn2_mean", "bn2_var", (0,))
        return torch.relu(out)

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        if combine not in ("sp_", "spo"):
            raise ValueError(
                f'combine "{combine}" not supported by the ConvE scorer'
            )
        n = p_emb.shape[0]
        out = self._hidden(s_emb, p_emb)
        if combine == "sp_":
            out = out @ o_emb[:, 1:].T
        else:
            out = torch.sum(out * o_emb[:, 1:], dim=-1)
        out = out + o_emb[:, 0]
        return out.reshape(n, -1)

    def factorize_slot(self, s_emb, p_emb, o_emb, slot):
        """In eval mode the object slot: ``[1 | h] . o_emb``; None in train
        mode and for the other slots."""
        if self.training or slot != 2:
            return None
        h = self._hidden(s_emb, p_emb)
        return torch.cat([torch.ones_like(h[:, :1]), h], dim=1), None


class ConvE(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        self._init_configuration(config, configuration_key)
        # an extra embedding component holds the per-entity bias
        # (reference conve.py:115-135 adds and undoes the same +1)
        self.set_option(
            "entity_embedder.dim", self.get_option("entity_embedder.dim") + 1
        )
        self.set_option(
            "relation_embedder.dim", self.get_option("relation_embedder.dim") + 1
        )
        super().__init__(
            config=config, dataset=dataset,
            scorer=ConvEScorer(config, dataset, self.configuration_key,
                               device=device),
            configuration_key=self.configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )
        self.set_option(
            "entity_embedder.dim", self.get_option("entity_embedder.dim") - 1
        )
        self.set_option(
            "relation_embedder.dim", self.get_option("relation_embedder.dim") - 1
        )

    def score_spo(self, s, p, o, direction=None, tables=None):
        if direction == "o":
            return super().score_spo(s, p, o, direction, tables)
        raise ValueError("ConvE can only score objects")

    def score_spo_neg(self, triples, samples, slot, tables=None):
        if slot == 2:
            return super().score_spo_neg(triples, samples, slot, tables)
        raise ValueError("ConvE can only score objects")


_LAYER_KEYS = (
    "in_proj_w", "in_proj_b", "out_proj_w", "out_proj_b", "linear1_w",
    "linear1_b", "linear2_w", "linear2_b", "norm1_scale", "norm1_bias",
    "norm2_scale", "norm2_bias",
)


class TransformerScorer(RelationalScorer):
    """3-token transformer encoder: [CLS, s + type_s, p + type_p] -> CLS' . o
    (reference transformer.py:10-105, the HittER "no context" model;
    kge_tpu ``TransformerScorer``). Each encoder layer's parameters are one
    ``nn.ParameterDict`` of ``layers``, kge_tpu's dict of that layer."""

    def __init__(self, config, dataset, configuration_key=None, device=None):
        super().__init__(config, dataset, configuration_key)
        self.emb_dim = self.get_option("entity_embedder.dim")
        self.nhead = int(self.get_option("encoder.nhead"))
        self.dim_ff = int(self.get_option("encoder.dim_feedforward"))
        self.num_layers = int(self.get_option("encoder.num_layers"))
        self.dropout = float(self.get_option("encoder.dropout"))
        if self.dropout < 0.0:
            if config.get("job.auto_correct"):
                config.log(
                    f"Setting {configuration_key}.encoder.dropout to 0., was "
                    f"{self.dropout}"
                )
                self.dropout = 0.0
        self.activation = {
            "relu": torch.relu,
            # jax.nn.gelu's default: the tanh approximation
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
        }[self.get_option("encoder.activation")]
        if self.emb_dim % self.nhead != 0:
            raise ValueError("emb_dim must be divisible by encoder.nhead")

        d, ff = self.emb_dim, self.dim_ff

        def param(*shape):
            return nn.Parameter(
                torch.empty(*shape, dtype=torch.float32, device=device)
            )

        self.cls = param(d)
        self.sub_type = param(d)
        self.rel_type = param(d)
        shapes = {
            # in_proj packs q, k, v as in torch MultiheadAttention
            "in_proj_w": (3 * d, d), "in_proj_b": (3 * d,),
            "out_proj_w": (d, d), "out_proj_b": (d,),
            "linear1_w": (ff, d), "linear1_b": (ff,),
            "linear2_w": (d, ff), "linear2_b": (d,),
            "norm1_scale": (d,), "norm1_bias": (d,),
            "norm2_scale": (d,), "norm2_bias": (d,),
        }
        self.layers = nn.ModuleList(
            nn.ParameterDict({key: param(*shapes[key]) for key in _LAYER_KEYS})
            for _ in range(self.num_layers)
        )

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        init = self.initializer()
        for p in (self.cls, self.sub_type, self.rel_type):
            init(p, generator)
        for lp in self.layers:
            for key in _LAYER_KEYS:
                if key.endswith("_w"):
                    init(lp[key], generator)
                elif key.endswith("_scale"):
                    lp[key].fill_(1.0)
                else:
                    lp[key].zero_()

    def param_tree(self) -> Dict[str, Any]:
        return {
            "cls": self.cls, "sub_type": self.sub_type,
            "rel_type": self.rel_type,
            "layers": [{key: lp[key] for key in _LAYER_KEYS} for lp in self.layers],
        }

    @staticmethod
    def _layer_norm(x, scale, bias, eps=1e-5):
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = _variance(x, -1)[..., None]
        return (x - mean) / torch.sqrt(var + eps) * scale + bias

    def _attention(self, lp, x):
        """Multi-head self-attention over [n, T, d] (T = 3 tokens)."""
        n, T, d = x.shape
        h = self.nhead
        hd = d // h
        qkv = x @ lp["in_proj_w"].T + lp["in_proj_b"]  # [n, T, 3d]
        q, k, v = (
            t.reshape(n, T, h, hd).transpose(1, 2)
            for t in torch.chunk(qkv, 3, dim=-1)
        )
        logits = torch.einsum("nhqd,nhkd->nhqk", q, k) / math.sqrt(hd)
        weights = torch.softmax(logits, dim=-1)
        weights = self._dropout(weights, self.dropout)
        out = torch.einsum("nhqk,nhkd->nhqd", weights, v)
        out = out.transpose(1, 2).reshape(n, T, d)
        return out @ lp["out_proj_w"].T + lp["out_proj_b"]

    def _encoder_layer(self, lp, x):
        """Post-norm encoder layer (torch.nn.TransformerEncoderLayer's
        default arrangement)."""
        attn = self._attention(lp, x)
        x = self._layer_norm(
            x + self._dropout(attn, self.dropout),
            lp["norm1_scale"], lp["norm1_bias"],
        )
        ff = self.activation(x @ lp["linear1_w"].T + lp["linear1_b"])
        ff = self._dropout(ff, self.dropout)
        ff = ff @ lp["linear2_w"].T + lp["linear2_b"]
        return self._layer_norm(
            x + self._dropout(ff, self.dropout),
            lp["norm2_scale"], lp["norm2_bias"],
        )

    def _cls_output(self, s_emb, p_emb) -> torch.Tensor:
        """The transformed CLS token [n, d] of the (s, p) rows."""
        n = s_emb.shape[0]
        x = torch.stack(
            [self.cls.expand(n, self.emb_dim), s_emb + self.sub_type,
             p_emb + self.rel_type], dim=1,
        )  # [n, 3, d]
        for lp in self.layers:
            x = self._encoder_layer(lp, x)
        return x[:, 0, :]

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        if combine not in ("sp_", "spo"):
            raise ValueError(
                f'combine "{combine}" not supported by the Transformer scorer'
            )
        n = s_emb.shape[0]
        out = self._cls_output(s_emb, p_emb)
        if combine == "sp_":
            out = out @ o_emb.T
        else:
            out = torch.sum(out * o_emb, dim=-1)
        return out.reshape(n, -1)

    def factorize_slot(self, s_emb, p_emb, o_emb, slot):
        """In eval mode the object slot: ``CLS' . o_emb``; None in train
        mode and for the other slots."""
        if self.training or slot != 2:
            return None
        return self._cls_output(s_emb, p_emb), None


class Transformer(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        self._init_configuration(config, configuration_key)
        super().__init__(
            config=config, dataset=dataset,
            scorer=TransformerScorer(config, dataset, self.configuration_key,
                                     device=device),
            configuration_key=self.configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )

    def score_spo(self, s, p, o, direction=None, tables=None):
        if direction == "o":
            return super().score_spo(s, p, o, direction, tables)
        raise ValueError("Transformer can only score objects")

    def score_spo_neg(self, triples, samples, slot, tables=None):
        if slot == 2:
            return super().score_spo_neg(triples, samples, slot, tables)
        raise ValueError("Transformer can only score objects")
