"""Translation-family scorers: TransE and RotatE.

Scoring semantics match kge_tpu/models/translation.py and the reference
(kge/model/{transe,rotate}.py). The many-targets forms (sp_/_po) are
broadcasted [n, chunk, d] differences reduced over d, computed chunk by
chunk over the targets so that the intermediate stays bounded (about 128 MB)
whatever the number of targets.

Ported: the L1 (and general L_p) forms, which training with per-row
negatives needs, with the queries of the pooled distance kernel
(ops/dist_pool.py). Not ported yet (see ROADMAP.md): ``l_norm: 2`` (kge_tpu
writes it as a matrix product with augmented embeddings and a sqrt epilogue;
it raises here), TransH, and entity-ranking evaluation of these models.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from kge_tpu_torch.models.base import KgeModel, RelationalScorer


def _p_norm(x: torch.Tensor, p: float, dim: int) -> torch.Tensor:
    """L_p norm over ``dim``."""
    if p == 1.0:
        return torch.sum(torch.abs(x), dim=dim)
    return torch.sum(torch.abs(x) ** p, dim=dim) ** (1.0 / p)


def _p_norm_nonneg(x: torch.Tensor, p: float, dim: int) -> torch.Tensor:
    """L_p norm when entries of x are already non-negative."""
    if p == 1.0:
        return torch.sum(x, dim=dim)
    return torch.sum(x ** p, dim=dim) ** (1.0 / p)


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


def _check_norm(scorer) -> float:
    norm = float(scorer.get_option("l_norm"))
    if norm == 2.0:
        raise NotImplementedError(
            f"{scorer.configuration_key}.l_norm=2 is not ported yet (kge_tpu "
            "scores it as a matrix product with a sqrt epilogue): see "
            "ROADMAP.md section A"
        )
    return norm


class TransEScorer(RelationalScorer):
    """score = -||s + p - o||_l (reference transe.py:16-36). The
    many-targets forms are chunked [n, c, d] reductions."""

    #: sp_/_po are pairwise reductions, not matrix products: callers route
    #: these scorers away from matmul-shaped scoring paths
    pairwise_many_targets = True

    def __init__(self, config, dataset, configuration_key=None):
        super().__init__(config, dataset, configuration_key)
        self._norm = _check_norm(self)

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        n = p_emb.shape[0]
        if combine == "spo":
            out = -_p_norm(s_emb + p_emb - o_emb, self._norm, dim=1)
        elif combine in ("sp_", "_po"):
            query = s_emb + p_emb if combine == "sp_" else o_emb - p_emb
            targets = o_emb if combine == "sp_" else s_emb

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
        return -_p_norm(query[:, None, :] - cand, self._norm, dim=2)

    def pooled_kernel_queries(self, s_emb, p_emb, o_emb, slot):
        """(kind, queries) for ``pooled_dist_scores``, or None when the
        slot's score is not a plain difference norm the kernel knows."""
        if self._norm != 1.0:
            return None
        return "l1", (self._query(s_emb, p_emb, o_emb, slot),)


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
    device), else "triple"."""
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


class RotatEScorer(RelationalScorer):
    """Relations are phase vectors rotating complex entity embeddings;
    score = -||abs(s*r - o)||_l (reference rotate.py:20-70)."""

    pairwise_many_targets = True

    def __init__(self, config, dataset, configuration_key=None):
        super().__init__(config, dataset, configuration_key)
        self._norm = _check_norm(self)

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
