"""Translation-family scorers: TransE, TransH and RotatE.

Scoring semantics match kge_tpu/models/translation.py and the reference
(kge/model/{transe,transh,rotate}.py), in the same float order. The
many-targets forms (sp_/_po) of the L1 and general L_p norms are broadcasted
[n, chunk, d] differences reduced over d, computed chunk by chunk over the
targets so that the intermediate stays bounded (about 128 MB) whatever the
number of targets; the pooled distance kernel (ops/dist_pool.py) takes their
per-row negatives.

``l_norm: 2`` is a matrix product instead: ``||q - c||^2 = ||q||^2 +
||c||^2 - 2 q.c`` (``_l2_expanded``), and for entity ranking and shared
negatives a factorization over augmented embeddings whose sqrt epilogue the
rank kernel applies in its tile (``_l2_factorization``). TransH has no
factorization: its evaluation ranks the score matrix of its sp_/_po forms.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from kge_tpu_torch.models.base import KgeModel, RelationalScorer
from kge_tpu_torch.ops.rank_kernel import NEG_SQRT_L2


def _p_norm(x: torch.Tensor, p: float, dim: int) -> torch.Tensor:
    """L_p norm over ``dim``."""
    if p == 1.0:
        return torch.sum(torch.abs(x), dim=dim)
    if p == 2.0:
        # the epsilon keeps the gradient finite at 0
        return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-30)
    return torch.sum(torch.abs(x) ** p, dim=dim) ** (1.0 / p)


def _p_norm_nonneg(x: torch.Tensor, p: float, dim: int) -> torch.Tensor:
    """L_p norm when entries of x are already non-negative."""
    if p == 1.0:
        return torch.sum(x, dim=dim)
    if p == 2.0:
        return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-30)
    return torch.sum(x ** p, dim=dim) ** (1.0 / p)


def _l2_expanded(query: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-||query_i - target_j||_2 for all pairs through the expansion
    ||q - t||^2 = ||q||^2 + ||t||^2 - 2 q.t: one matrix product instead of
    the [n, m, d] pairwise reduction. Clamped at 0 against cancellation."""
    cross = query @ targets.T
    q2 = torch.sum(query * query, dim=1, keepdim=True)
    t2 = torch.sum(targets * targets, dim=1)[None, :]
    sq = torch.clamp(q2 + t2 - 2.0 * cross, min=0.0)
    return -torch.sqrt(sq + 1e-30)


#: columns of an augmented L2 operand are padded to a multiple of this
#: (zeros at the end): the rank kernel's 16-byte copies need rows of whole
#: float4s, and a zero column leaves its FMA chain unchanged
_L2_PAD = 4


def _l2_factorization(q: torch.Tensor):
    """(query, target_map, score_map) writing -||q - c||_2 as an epilogued
    dot product of AUGMENTED embeddings:

        [2q | -1 | -||q||^2] . [c | ||c||^2 | 1] = -||q - c||^2

    followed by the named epilogue ``NEG_SQRT_L2``, -sqrt(max(-dot, 0) +
    1e-30), which the rank kernel applies in its tile. Both operands carry
    zero columns up to a multiple of 4 (d + 2 = 130 becomes 132)."""
    n, d = q.shape
    pad = -(d + 2) % _L2_PAD
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    query = torch.cat(
        [2.0 * q, -torch.ones((n, 1), dtype=q.dtype, device=q.device), -q2,
         q.new_zeros((n, pad))], dim=1,
    )

    def target_map(t):
        t2 = torch.sum(t * t, dim=1, keepdim=True)
        m = t.shape[0]
        return torch.cat(
            [t, t2, torch.ones((m, 1), dtype=t.dtype, device=t.device),
             t.new_zeros((m, pad))], dim=1,
        )

    return query, target_map, NEG_SQRT_L2


def _l2_expanded_neg(query: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """-||query_i - cand_ij||_2 for per-row candidates [n, k, d]: a batched
    contraction instead of the [n, k, d] difference chain."""
    cross = torch.einsum("nd,nkd->nk", query, cand)
    q2 = torch.sum(query * query, dim=1, keepdim=True)
    c2 = torch.sum(cand * cand, dim=2)
    sq = torch.clamp(q2 + c2 - 2.0 * cross, min=0.0)
    return -torch.sqrt(sq + 1e-30)


# cap on the broadcasted [n, chunk, d] pairwise intermediate (f32 elements);
# 32M elements = 128 MB
_PAIRWISE_BUDGET_ELEMS = 1 << 25


def _map_over_targets(score_chunk, targets: torch.Tensor, n: int) -> torch.Tensor:
    """Apply ``score_chunk(chunk_targets) -> [n, chunk]`` over row-chunks of
    ``targets`` [m, d] one after the other and concatenate to [n, m]. Under
    autograd every chunk is rematerialized in the backward pass: without
    that the chunks' [n, chunk, d] residuals would all be held at once,
    the full pairwise tensor that the chunking exists to avoid."""
    m, d = targets.shape
    chunk = max(128, _PAIRWISE_BUDGET_ELEMS // max(1, n * d))
    if m <= chunk:
        return score_chunk(targets)
    remat = torch.is_grad_enabled()
    out = []
    for start in range(0, m, chunk):
        part = targets[start:start + chunk]
        out.append(
            checkpoint(score_chunk, part, use_reentrant=False) if remat
            else score_chunk(part)
        )
    return torch.cat(out, dim=1)


class TransEScorer(RelationalScorer):
    """score = -||s + p - o||_l (reference transe.py:16-36). For l_norm=2
    every many-targets form is one matrix product (``_l2_expanded``); other
    norms are chunked [n, c, d] reductions."""

    def __init__(self, config, dataset, configuration_key=None):
        super().__init__(config, dataset, configuration_key)
        self._norm = float(self.get_option("l_norm"))
        #: L2's many-targets forms are matrix products; the other norms'
        #: are pairwise reductions, which callers route away from
        #: matmul-shaped scoring paths
        self.pairwise_many_targets = self._norm != 2.0

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        n = p_emb.shape[0]
        if combine == "spo":
            out = -_p_norm(s_emb + p_emb - o_emb, self._norm, dim=1)
        elif combine == "s_o" and self._norm == 2.0:
            # rows are the (s, o) pairs here: n (the relation count) would
            # scramble a reshape
            return _l2_expanded(o_emb - s_emb, p_emb)
        elif combine in ("sp_", "_po"):
            query = s_emb + p_emb if combine == "sp_" else o_emb - p_emb
            targets = o_emb if combine == "sp_" else s_emb
            if self._norm == 2.0:
                return _l2_expanded(query, targets).reshape(n, -1)

            def chunk_scores(chunk):
                # [n, 1, d] - [1, c, d], reduced over d
                diff = query[:, None, :] - chunk[None, :, :]
                return -_p_norm(diff, self._norm, dim=2)

            out = _map_over_targets(chunk_scores, targets, n)
        else:
            return super().score_emb(s_emb, p_emb, o_emb, combine)
        return out.reshape(n, -1)

    @staticmethod
    def _query(s_emb, p_emb, o_emb, slot):
        """Every slot reduces to -||q_row - candidate||, with q from the
        kept slots (relations too: q = o - s)."""
        if slot == 0:
            return o_emb - p_emb
        if slot == 1:
            return o_emb - s_emb
        return s_emb + p_emb

    def score_emb_neg(self, s_emb, p_emb, o_emb, slot):
        """Per-row candidates: the corrupted slot's embedding is [n, k, d],
        the kept ones [n, d]; returns [n, k]."""
        cand = (s_emb, p_emb, o_emb)[slot]
        query = self._query(s_emb, p_emb, o_emb, slot)
        if self._norm == 2.0:
            return _l2_expanded_neg(query, cand)
        return -_p_norm(query[:, None, :] - cand, self._norm, dim=2)

    def pooled_kernel_queries(self, s_emb, p_emb, o_emb, slot):
        """(kind, queries) for ``pooled_dist_scores``, or None when the
        slot's score is not a plain difference norm the kernel knows."""
        if self._norm != 1.0:
            return None
        return "l1", (self._query(s_emb, p_emb, o_emb, slot),)

    def factorize_slot(self, s_emb, p_emb, o_emb, slot):
        if self._norm != 2.0:
            return None
        return _l2_factorization(self._query(s_emb, p_emb, o_emb, slot))


class TransE(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        super().__init__(
            config=config, dataset=dataset, scorer=TransEScorer,
            configuration_key=configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )

    def prepare_job(self, job, **kwargs):
        super().prepare_job(job, **kwargs)
        _force_triple_negatives(self, job)


def _force_triple_negatives(model, job):
    """Resolve negative_sampling.implementation=auto away from the
    matmul-shaped choices for PAIRWISE distance scorers (L1/Lp): their
    many-targets (sp_/_po) forms are chunked reductions, so "all"/"batch"
    cost vocab/num times more work for nothing (the reference forces triple
    for TransE, transe.py:57-68). Preference order: "pool" when its
    requirements hold (no filtering, non-shared, negatives drawn on the
    device), else "triple". L2 scorers factorize and keep the standard
    auto ladder."""
    from kge_tpu_torch.job.train_negative_sampling import (
        TrainingJobNegativeSampling,
    )

    config = model.config
    if not isinstance(job, TrainingJobNegativeSampling):
        return
    if not getattr(model.get_scorer(), "pairwise_many_targets", False):
        return
    if config.get("negative_sampling.implementation") == "auto":
        filtering = any(
            config.get(f"negative_sampling.filtering.{s}") for s in "spo"
        )
        shared = config.get("negative_sampling.shared")
        on_device_ok = config.get("negative_sampling.on_device") != "never"
        pool_ok = (
            not filtering and not shared and on_device_ok
            and not config.get("negative_sampling.auto_exact")
        )
        config.set(
            "negative_sampling.implementation",
            "pool" if pool_ok else "triple", log=True,
        )


class TransHScorer(RelationalScorer):
    """TransE on relation hyperplanes: entities are projected onto the
    hyperplane with normal w_p before the translation (reference
    transh.py:16-81). The relation embedding stores [translation | normal]
    concatenated. Every many-targets form projects each candidate per
    relation, so none factorizes."""

    pairwise_many_targets = True

    def __init__(self, config, dataset, configuration_key=None):
        super().__init__(config, dataset, configuration_key)
        self._norm = float(self.get_option("l_norm"))

    @staticmethod
    def _transfer(ent_emb, norm_vec):
        norm_vec = norm_vec / torch.clamp(
            torch.linalg.vector_norm(norm_vec, dim=-1, keepdim=True), min=1e-12
        )
        return ent_emb - torch.sum(ent_emb * norm_vec, dim=-1, keepdim=True) * norm_vec

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        n = p_emb.shape[0]
        rel_emb, norm_vec = torch.chunk(p_emb, 2, dim=1)
        if combine == "spo":
            diff = (
                self._transfer(s_emb, norm_vec) + rel_emb
                - self._transfer(o_emb, norm_vec)
            )
            out = -_p_norm(diff, self._norm, dim=1)
        elif combine in ("sp_", "_po"):
            # each candidate is projected onto every row's hyperplane
            if combine == "sp_":
                query = self._transfer(s_emb, norm_vec) + rel_emb  # [n, d]
                targets = o_emb
            else:
                query = self._transfer(o_emb, norm_vec) - rel_emb
                targets = s_emb

            def chunk_scores(chunk):
                proj = self._transfer(chunk[None, :, :], norm_vec[:, None, :])
                return -_p_norm(query[:, None, :] - proj, self._norm, dim=2)

            out = _map_over_targets(chunk_scores, targets, n)
        else:
            return super().score_emb(s_emb, p_emb, o_emb, combine)
        return out.reshape(n, -1)

    def score_emb_neg(self, s_emb, p_emb, o_emb, slot):
        if slot == 1:
            # per-candidate hyperplanes: both kept entities are projected
            # under each candidate relation's normal
            rel3, w3 = torch.chunk(p_emb, 2, dim=2)  # [n, k, d]
            diff = (
                self._transfer(s_emb[:, None, :], w3) + rel3
                - self._transfer(o_emb[:, None, :], w3)
            )
            return -_p_norm(diff, self._norm, dim=2)
        rel_emb, norm_vec = torch.chunk(p_emb, 2, dim=1)
        if slot == 0:
            query = self._transfer(o_emb, norm_vec) - rel_emb
            cand = self._transfer(s_emb, norm_vec[:, None, :])
        else:
            query = self._transfer(s_emb, norm_vec) + rel_emb
            cand = self._transfer(o_emb, norm_vec[:, None, :])
        return -_p_norm(query[:, None, :] - cand, self._norm, dim=2)


class TransH(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        self._init_configuration(config, configuration_key)
        rel_key = self.configuration_key + ".relation_embedder"
        if config.get_default(rel_key + ".dim") < 0:
            # translation vector and hyperplane normal
            ent_dim = config.get_default(
                self.configuration_key + ".entity_embedder.dim"
            )
            config.set(rel_key + ".dim", ent_dim * 2, create=True, log=True)
        super().__init__(
            config=config, dataset=dataset, scorer=TransHScorer,
            configuration_key=self.configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )
        self.soft_constraint_weight = float(self.get_option("C"))

    def prepare_job(self, job, **kwargs):
        super().prepare_job(job, **kwargs)
        _force_triple_negatives(self, job)

    def penalty(self, batch=None, **kwargs):
        """Soft constraints of the TransH paper, weighted by C: entity norms
        at most 1, and translations orthogonal to their hyperplane's normal
        (transh.py:108-144)."""
        result = super().penalty(batch=batch, **kwargs)
        if self.soft_constraint_weight > 0.0:
            ent = self.get_s_embedder().embeddings
            p_ent = torch.sum(torch.relu(torch.sum(ent * ent, dim=1) - 1.0))
            rel_emb, norm_vec = torch.chunk(self.get_p_embedder().embeddings, 2, dim=1)
            eps = 1e-6  # guards the division for small translations
            ratio = torch.sum(rel_emb * norm_vec, dim=-1) / (
                torch.linalg.vector_norm(rel_emb, dim=1) + eps
            )
            p_rel = torch.sum(torch.relu(ratio ** 2 - eps ** 2))
            result = result + [
                ("transh.soft_constraints_ent", self.soft_constraint_weight * p_ent),
                ("transh.soft_constraints_rel", self.soft_constraint_weight * p_rel),
            ]
        return result


class RotatEScorer(RelationalScorer):
    """Relations are phase vectors rotating complex entity embeddings;
    score = -||abs(s*r - o)||_l (reference rotate.py:20-70).

    For l_norm=2 the many-targets forms are matrix products: the L2 norm
    over complex moduli equals the plain L2 norm of the concatenated [re |
    im] vector (the entity table's layout), so ``_l2_expanded`` and
    ``_l2_factorization`` apply directly."""

    def __init__(self, config, dataset, configuration_key=None):
        super().__init__(config, dataset, configuration_key)
        self._norm = float(self.get_option("l_norm"))
        self.pairwise_many_targets = self._norm != 2.0

    @staticmethod
    def _hadamard(a_re, a_im, b_re, b_im):
        return a_re * b_re - a_im * b_im, a_re * b_im + a_im * b_re

    def _modulus_norm(self, d_re, d_im, dim):
        mod = torch.sqrt(d_re * d_re + d_im * d_im + 1e-30)
        return -_p_norm_nonneg(mod, self._norm, dim=dim)

    def _entity_query(self, s_emb, p_emb, o_emb, slot):
        """(q_re, q_im) with score(candidate c of entity ``slot``) =
        -|| |q - c| ||: q = s*r for objects; for subjects
        || s*r - o || = || s - conj(r)*o || as rotations have unit modulus."""
        p_re, p_im = torch.cos(p_emb), torch.sin(p_emb)
        if slot == 0:
            o_re, o_im = torch.chunk(o_emb, 2, dim=1)
            return self._hadamard(p_re, -p_im, o_re, o_im)
        s_re, s_im = torch.chunk(s_emb, 2, dim=1)
        return self._hadamard(s_re, s_im, p_re, p_im)

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        n = p_emb.shape[0]
        if combine == "spo":
            s_re, s_im = torch.chunk(s_emb, 2, dim=1)
            o_re, o_im = torch.chunk(o_emb, 2, dim=1)
            sp_re, sp_im = self._hadamard(
                s_re, s_im, torch.cos(p_emb), torch.sin(p_emb)
            )
            out = self._modulus_norm(sp_re - o_re, sp_im - o_im, dim=1)
        elif combine in ("sp_", "_po"):
            slot = 2 if combine == "sp_" else 0
            q_re, q_im = self._entity_query(s_emb, p_emb, o_emb, slot)
            targets = o_emb if combine == "sp_" else s_emb
            if self._norm == 2.0:
                return _l2_expanded(
                    torch.cat([q_re, q_im], dim=1), targets
                ).reshape(n, -1)

            def chunk_scores(chunk):
                c_re, c_im = torch.chunk(chunk, 2, dim=1)
                d_re = q_re[:, None, :] - c_re[None, :, :]  # [n, c, d/2]
                d_im = q_im[:, None, :] - c_im[None, :, :]
                return self._modulus_norm(d_re, d_im, dim=2)

            out = _map_over_targets(chunk_scores, targets, n)
        else:
            return super().score_emb(s_emb, p_emb, o_emb, combine)
        return out.reshape(n, -1)

    def score_emb_neg(self, s_emb, p_emb, o_emb, slot):
        if slot == 1:
            s_re, s_im = torch.chunk(s_emb, 2, dim=1)
            o_re, o_im = torch.chunk(o_emb, 2, dim=1)
            p_re, p_im = torch.cos(p_emb), torch.sin(p_emb)  # [n, k, d/2]
            sp_re, sp_im = self._hadamard(
                s_re[:, None, :], s_im[:, None, :], p_re, p_im
            )
            d_re, d_im = sp_re - o_re[:, None, :], sp_im - o_im[:, None, :]
        else:
            q_re, q_im = self._entity_query(s_emb, p_emb, o_emb, slot)
            c_re, c_im = torch.chunk((s_emb, p_emb, o_emb)[slot], 2, dim=2)
            d_re = q_re[:, None, :] - c_re
            d_im = q_im[:, None, :] - c_im
        return self._modulus_norm(d_re, d_im, dim=2)

    def pooled_kernel_queries(self, s_emb, p_emb, o_emb, slot):
        # relation corruptions multiply the candidate into s, which is not
        # a plain difference: they keep the select route
        if self._norm != 1.0 or slot == 1:
            return None
        return "cmod", self._entity_query(s_emb, p_emb, o_emb, slot)

    def factorize_slot(self, s_emb, p_emb, o_emb, slot):
        # relation corruptions rotate the candidate into s (no difference),
        # so slot 1 does not factorize
        if self._norm != 2.0 or slot == 1:
            return None
        q_re, q_im = self._entity_query(s_emb, p_emb, o_emb, slot)
        return _l2_factorization(torch.cat([q_re, q_im], dim=1))


class RotatE(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        self._init_configuration(config, configuration_key)
        if self.get_option("entity_embedder.dim") % 2 != 0:
            raise ValueError(
                "RotatE requires embeddings of even dimensionality (got {})".format(
                    self.get_option("entity_embedder.dim")
                )
            )
        if self.get_option("relation_embedder.dim") < 0:
            self.set_option(
                "relation_embedder.dim",
                self.get_option("entity_embedder.dim") // 2,
                log=True,
            )
        super().__init__(
            config=config, dataset=dataset, scorer=RotatEScorer,
            configuration_key=self.configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )
        self._normalize_phases = self.get_option("normalize_phases")
        if (
            self._normalize_phases
            and self.get_option("relation_embedder.type") != "lookup_embedder"
        ):
            raise ValueError(
                "RotatE supports normalize_phases=True only with a lookup "
                "relation embedder; got "
                f"{self.get_option('relation_embedder.type')}"
            )

    def prepare_job(self, job, **kwargs):
        super().prepare_job(job, **kwargs)
        _force_triple_negatives(self, job)

    @torch.no_grad()
    def postprocess_params(self) -> None:
        """Renormalize relation phases into [-pi, pi) after every batch, in
        place; the rotation (and hence every score) is unchanged
        (rotate.py:104-125)."""
        super().postprocess_params()
        if self._normalize_phases:
            phases = self.get_p_embedder().embeddings
            phases.add_(math.pi).remainder_(2.0 * math.pi).sub_(math.pi)
