"""Training losses.

The port of kge_tpu/ops/losses.py (after the reference kge/util/loss.py):
sum-reduction convention (losses are never averaged by batch size here,
callers divide), labels either a [n, m] 0/1 matrix or a [n] vector of
positive-column indexes.

Every loss is a sum over rows of a per-row term. ``loss.rows(scores,
labels)`` returns that term as [n], which is what a training job weights by
its padding mask (kge_tpu vmaps the scalar loss over rows instead);
``loss(scores, labels)`` is its sum.

Over column shards (``shard=(lo, hi, mesh)``, models/base.py
``vocab_shard``: a rank of a model axis holds the columns ``[lo, hi)`` of
full-vocabulary scores, parallel/mesh.py) each loss gives the whole row's
term, the same on every rank of the model group, without gathering the
rows: terms that are sums over columns are summed over the group
(``DeviceCtx.sum_columns``), a softmax's normalizer is a logsumexp over the
group (``logsumexp_columns``), a true column's score comes from the rank
that holds it (ops/pick.py ``picked_scores_columns``), and means count the
whole vocabulary. Index labels are global column ids;
a label matrix holds the rank's columns. Each rank's gradient is that of
its own columns.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from kge_tpu_torch.config import Config
from kge_tpu_torch.ops.pick import picked_scores_columns
from kge_tpu_torch.parallel.mesh import ModelCopy


def _labels_as_matrix(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    if labels.dim() == 2:
        return labels.to(scores.dtype)
    return F.one_hot(labels.long(), scores.shape[1]).to(scores.dtype)


def _pick_columns(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values[arange(n), idx] as a one-hot contraction, as kge_tpu writes it:
    its backward is elementwise, where a gather's would be a scatter."""
    return torch.sum(
        values * F.one_hot(idx.long(), values.shape[1]).to(values.dtype), dim=1
    )


def _local_labels(scores: torch.Tensor, labels: torch.Tensor,
                  lo: int) -> torch.Tensor:
    """The labels of a rank's columns ``[lo, lo + m)`` as a [n, m] matrix:
    a label matrix as it is, index labels one-hot where the rank holds the
    column."""
    if labels.dim() == 2:
        return labels.to(scores.dtype)
    local = labels.long() - lo
    own = (local >= 0) & (local < scores.shape[1])
    hot = F.one_hot(torch.where(own, local, 0), scores.shape[1]).to(scores.dtype)
    return hot * own[:, None].to(scores.dtype)


def _pick_own(values: torch.Tensor, columns: torch.Tensor, lo: int,
              mesh) -> torch.Tensor:
    """[n] ``values[i, columns[i]]`` of the whole row, from the rank that
    holds the column."""
    return picked_scores_columns(values, columns[:, None], lo, mesh)[:, 0]


def _argmax_columns(values: torch.Tensor, lo: int, mesh) -> torch.Tensor:
    """[n] global column of each row's largest value over every rank's
    columns, the first among equals (``argmax`` of the whole row)."""
    top, arg = torch.max(values, dim=1).values, torch.argmax(values, dim=1)
    whole = mesh.model_max(top)
    first = torch.where(top == whole, lo + arg,
                        torch.full_like(arg, values.shape[1] * mesh.model))
    return -mesh.model_max(-first)


def _bce_with_logits(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy on logits (stable formulation)."""
    return scores.clamp_min(0) - scores * labels + torch.log1p(
        torch.exp(-scores.abs())
    )


class KgeLoss:
    """Factory + base; instances are callables (scores, labels) -> scalar."""

    def __init__(self, config: Optional[Config] = None):
        self.config = config

    @staticmethod
    def create(config: Config) -> "KgeLoss":
        config.check(
            "train.loss",
            ["bce", "bce_mean", "bce_self_adversarial", "margin_ranking",
             "ce", "kl", "soft_margin", "se"],
        )
        loss = config.get("train.loss")
        if loss in ("bce", "bce_mean", "bce_self_adversarial"):
            offset = config.get("train.loss_arg")
            if math.isnan(offset):
                offset = 0.0
                config.set("train.loss_arg", offset, log=True)
            if loss == "bce":
                return BCEWithLogitsKgeLoss(config, offset=offset)
            elif loss == "bce_mean":
                return BCEWithLogitsKgeLoss(config, offset=offset, bce_type="mean")
            else:
                try:
                    temperature = float(
                        config.get("user.bce_self_adversarial_temperature")
                    )
                except KeyError:
                    temperature = 1.0
                config.log(f"Using adversarial temperature {temperature}")
                return BCEWithLogitsKgeLoss(
                    config, offset=offset, bce_type="self_adversarial",
                    temperature=temperature,
                )
        elif loss in ("kl", "ce"):
            return KLDivWithSoftmaxKgeLoss(config)
        elif loss == "margin_ranking":
            margin = config.get("train.loss_arg")
            if math.isnan(margin):
                margin = 1.0
                config.set("train.loss_arg", margin, log=True)
            return MarginRankingKgeLoss(config, margin=margin)
        elif loss == "soft_margin":
            return SoftMarginKgeLoss(config)
        elif loss == "se":
            return SEKgeLoss(config)
        raise ValueError(f"invalid value train.loss={loss}")

    def rows(self, scores, labels, shard=None, **kwargs) -> torch.Tensor:
        """The loss of each row, [n]; over column shards (``shard``: the
        columns ``lo, hi`` of this rank's scores and the mesh) the whole
        row's, the same on every rank of the model group."""
        if shard is not None:
            return self.rows_over_columns(scores, labels, shard[0], shard[2])
        return self.rows_whole(scores, labels, **kwargs)

    def rows_whole(self, scores, labels, **kwargs) -> torch.Tensor:
        raise NotImplementedError

    def rows_over_columns(self, scores, labels, lo: int, mesh) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, scores, labels, **kwargs) -> torch.Tensor:
        return torch.sum(self.rows(scores, labels, **kwargs))


class BCEWithLogitsKgeLoss(KgeLoss):
    """bce: summed elementwise BCE. bce_mean: positives + mean-of-negatives,
    halved. bce_self_adversarial: negatives weighted by a detached softmax
    over their scores (loss.py:138-190). The latter two assume the positive
    is in column 0 when labels are given as indexes or a one-hot matrix."""

    def __init__(self, config, offset=0.0, bce_type=None, temperature=1.0):
        super().__init__(config)
        self._bce_type = bce_type
        self._offset = offset
        self._temperature = temperature

    def rows_whole(self, scores, labels, **kwargs):
        labels_matrix = _labels_as_matrix(scores, labels)
        if self._offset != 0.0:
            scores = scores + self._offset
        losses = _bce_with_logits(scores, labels_matrix)
        if self._bce_type is None:
            return torch.sum(losses, dim=1)
        if labels.dim() == 1:
            pos_idx = labels
        else:
            pos_idx = torch.argmax(labels_matrix, dim=1)
        m = scores.shape[1]
        losses_pos = _pick_columns(losses, pos_idx)
        if self._bce_type == "mean":
            losses_neg = torch.sum(losses, dim=1) - losses_pos
            return (losses_pos + losses_neg / (m - 1)) / 2.0
        elif self._bce_type == "self_adversarial":
            neg_mask = 1.0 - labels_matrix
            # softmax over negative scores only (detached)
            neg_scores = scores.detach() * self._temperature
            neg_scores = torch.where(
                neg_mask > 0, neg_scores,
                torch.full_like(neg_scores, float("-inf")),
            )
            weights = torch.softmax(neg_scores, dim=1)
            losses_neg = torch.sum(weights * losses * neg_mask, dim=1)
            return (losses_pos + losses_neg) / 2.0
        raise NotImplementedError

    def rows_over_columns(self, scores, labels, lo, mesh):
        labels_matrix = _local_labels(scores, labels, lo)
        if self._offset != 0.0:
            scores = scores + self._offset
        losses = _bce_with_logits(scores, labels_matrix)
        if self._bce_type is None:
            return mesh.sum_columns(losses)
        if labels.dim() == 1:
            pos_idx = labels
        else:
            pos_idx = _argmax_columns(labels_matrix, lo, mesh)
        losses_pos = _pick_own(losses, pos_idx, lo, mesh)
        if self._bce_type == "mean":
            m = scores.shape[1] * mesh.model
            losses_neg = mesh.sum_columns(losses) - losses_pos
            return (losses_pos + losses_neg / (m - 1)) / 2.0
        elif self._bce_type == "self_adversarial":
            neg_mask = 1.0 - labels_matrix
            # the softmax over the whole row's negative scores (detached)
            neg_scores = scores.detach() * self._temperature
            neg_scores = torch.where(
                neg_mask > 0, neg_scores,
                torch.full_like(neg_scores, float("-inf")),
            )
            top = mesh.model_max(torch.max(neg_scores, dim=1).values)
            top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
            exps = torch.exp(neg_scores - top[:, None])
            weights = exps / mesh.model_sum(torch.sum(exps, dim=1))[:, None]
            losses_neg = mesh.sum_columns(weights * losses * neg_mask)
            return (losses_pos + losses_neg) / 2.0
        raise NotImplementedError


class KLDivWithSoftmaxKgeLoss(KgeLoss):
    """kl: cross entropy for index labels; KL divergence between the model
    softmax and the L1-normalized label matrix otherwise (loss.py:192-213)."""

    def rows_whole(self, scores, labels, **kwargs):
        if labels.dim() == 1:
            logz = torch.logsumexp(scores, dim=1)
            return logz - _pick_columns(scores, labels)
        labels = labels.to(scores.dtype)
        # guard for all-zero label rows (padded batch rows)
        norm = torch.sum(labels, dim=1, keepdim=True).clamp_min(1e-30)
        target = labels / norm
        log_probs = torch.log_softmax(scores, dim=1)
        # sum target * (log target - log_probs), with 0 * log 0 := 0
        tlogt = torch.where(
            target > 0, target * torch.log(target.clamp_min(1e-38)),
            torch.zeros_like(target),
        )
        return torch.sum(tlogt - target * log_probs, dim=1)

    def rows_over_columns(self, scores, labels, lo, mesh):
        logz = mesh.logsumexp_columns(scores)
        if labels.dim() == 1:
            return logz - _pick_own(scores, labels, lo, mesh)
        labels = labels.to(scores.dtype)
        norm = mesh.model_sum(torch.sum(labels, dim=1, keepdim=True))
        target = labels / norm.clamp_min(1e-30)
        tlogt = torch.where(
            target > 0, target * torch.log(target.clamp_min(1e-38)),
            torch.zeros_like(target),
        )
        # sum(tlogt - target * (scores - logz)): the rank's columns summed
        # over the group, plus logz times the row's whole target mass
        mass = mesh.model_sum(torch.sum(target, dim=1))
        return mesh.sum_columns(tlogt - target * scores) + logz * mass


class SoftMarginKgeLoss(KgeLoss):
    """log(1 + exp(-y * score)) with y in {-1, 1}, summed (loss.py:216-224)."""

    def rows_whole(self, scores, labels, **kwargs):
        labels = _labels_as_matrix(scores, labels) * 2 - 1
        return torch.sum(torch.log1p(torch.exp(-labels * scores)), dim=1)

    def rows_over_columns(self, scores, labels, lo, mesh):
        labels = _local_labels(scores, labels, lo) * 2 - 1
        return mesh.sum_columns(torch.log1p(torch.exp(-labels * scores)))


class MarginRankingKgeLoss(KgeLoss):
    """max(0, margin - pos + neg) summed over (positive, negative) pairs.

    Pairs each positive with its following negatives; requires negative
    sampling training with the fixed [pos | negs] column layout
    (loss.py:227-264). Assumes every row has its positive in column 0.
    """

    def __init__(self, config, margin: float):
        super().__init__(config)
        self._margin = margin
        self._train_type = config.get("train.type")
        if "negative_sampling" not in self._train_type:
            raise NotImplementedError(
                "margin ranking is only supported for negative_sampling training"
            )

    def rows_whole(self, scores, labels, **kwargs):
        pos = scores[:, :1]
        neg = scores[:, 1:]
        return torch.sum(torch.relu(self._margin - pos + neg), dim=1)

    def rows_over_columns(self, scores, labels, lo, mesh):
        # the positive (global column 0) from the rank that holds it, met
        # by every rank's negatives (``ModelCopy``: its gradient is summed
        # over the group's columns)
        zero = torch.zeros(scores.shape[0], dtype=torch.long, device=scores.device)
        pos = ModelCopy.apply(_pick_own(scores, zero, lo, mesh), mesh)
        cols = lo + torch.arange(scores.shape[1], device=scores.device)
        terms = torch.relu(self._margin - pos[:, None] + scores)
        return mesh.sum_columns(terms * (cols >= 1).to(scores.dtype))


class SEKgeLoss(KgeLoss):
    """Squared error against 0/1 labels, summed (loss.py:267-274)."""

    def rows_whole(self, scores, labels, **kwargs):
        labels = _labels_as_matrix(scores, labels)
        return torch.sum((scores - labels) ** 2, dim=1)

    def rows_over_columns(self, scores, labels, lo, mesh):
        labels = _local_labels(scores, labels, lo)
        return mesh.sum_columns((scores - labels) ** 2)
