"""Factorization-family scorers: DistMult, ComplEx, RESCAL, CP, SimplE,
RelationalTucker3.

Scoring semantics match kge_tpu/models/factorization.py and the reference
(kge/model/{distmult,complex,rescal,cp,simple,relational_tucker3}.py).
Every full-vocabulary combine is one elementwise product and one matrix
product, and every scorer factorizes its slots (``factorize_slot``), so
evaluation ranks all of them through the rank kernel.
"""

from __future__ import annotations

import torch

from kge_tpu_torch.models.base import KgeModel, RelationalScorer


def _neg_dot(query, candidates):
    """[n, k] scores: per-row dot of a query [n, d] with that row's k
    candidate embeddings [n, k, d], in one contraction."""
    return torch.einsum("nkd,nd->nk", candidates, query)


class DistMultScorer(RelationalScorer):
    """score = sum(s * p * o) (reference distmult.py:13-25)."""

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        n = s_emb.shape[0] if combine == "s_o" else p_emb.shape[0]
        if combine == "spo":
            out = torch.sum(s_emb * p_emb * o_emb, dim=1)
        elif combine == "sp_":
            out = (s_emb * p_emb) @ o_emb.T
        elif combine == "_po":
            out = (o_emb * p_emb) @ s_emb.T
        elif combine == "s_o":
            out = (s_emb * o_emb) @ p_emb.T
        else:
            return super().score_emb(s_emb, p_emb, o_emb, combine)
        return out.reshape(n, -1)

    def score_emb_neg(self, s_emb, p_emb, o_emb, slot):
        if slot == 0:
            return _neg_dot(o_emb * p_emb, s_emb)
        if slot == 1:
            return _neg_dot(s_emb * o_emb, p_emb)
        return _neg_dot(s_emb * p_emb, o_emb)

    def factorize_slot(self, s_emb, p_emb, o_emb, slot):
        if slot == 0:
            return o_emb * p_emb, None
        if slot == 1:
            return s_emb * o_emb, None
        return s_emb * p_emb, None


class DistMult(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        super().__init__(
            config=config, dataset=dataset, scorer=DistMultScorer,
            configuration_key=configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )


class ComplExScorer(RelationalScorer):
    """score = Re(<s, p, conj(o)>) over complex embeddings stored [re | im].

    Every combine is one elementwise product followed by a single matrix
    product (the "block trick" of the reference complex.py:18-44).
    """

    @staticmethod
    def _split(emb):
        return torch.chunk(emb, 2, dim=1)

    @classmethod
    def _sp_query(cls, s_emb, p_emb):
        # u = s*p (complex); score(o) = u_re . o_re + u_im . o_im
        s_re, s_im = cls._split(s_emb)
        p_re, p_im = cls._split(p_emb)
        return torch.cat(
            [s_re * p_re - s_im * p_im, s_re * p_im + s_im * p_re], dim=1
        )

    @classmethod
    def _po_query(cls, p_emb, o_emb):
        # w = p*conj(o); score(s) = s_re . w_re - s_im . w_im
        p_re, p_im = cls._split(p_emb)
        o_re, o_im = cls._split(o_emb)
        w_re = p_re * o_re + p_im * o_im
        w_im = p_im * o_re - p_re * o_im
        return torch.cat([w_re, -w_im], dim=1)

    @classmethod
    def _so_query(cls, s_emb, o_emb):
        # score(p) = p_re . (s_re*o_re + s_im*o_im) + p_im . (s_re*o_im - s_im*o_re)
        s_re, s_im = cls._split(s_emb)
        o_re, o_im = cls._split(o_emb)
        return torch.cat(
            [s_re * o_re + s_im * o_im, s_re * o_im - s_im * o_re], dim=1
        )

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        n = p_emb.shape[0]
        if combine == "spo":
            s_re, s_im = self._split(s_emb)
            p_re, p_im = self._split(p_emb)
            o_re, o_im = self._split(o_emb)
            out = torch.sum(
                (s_re * p_re - s_im * p_im) * o_re
                + (s_re * p_im + s_im * p_re) * o_im,
                dim=1,
            )
        elif combine == "sp_":
            out = self._sp_query(s_emb, p_emb) @ o_emb.T
        elif combine == "_po":
            out = self._po_query(p_emb, o_emb) @ s_emb.T
        elif combine == "s_o":
            n = s_emb.shape[0]
            out = self._so_query(s_emb, o_emb) @ p_emb.T
        else:
            return super().score_emb(s_emb, p_emb, o_emb, combine)
        return out.reshape(n, -1)

    def score_emb_neg(self, s_emb, p_emb, o_emb, slot):
        # the slot's query (as for sp_/_po/s_o) dotted against each row's
        # own candidates [n, k, d] in one contraction
        query = self.factorize_slot(
            *(None if i == slot else e
              for i, e in enumerate((s_emb, p_emb, o_emb))), slot
        )[0]
        return torch.einsum("nd,nkd->nk", query, (s_emb, p_emb, o_emb)[slot])

    def factorize_slot(self, s_emb, p_emb, o_emb, slot):
        if slot == 0:
            return self._po_query(p_emb, o_emb), None
        if slot == 1:
            return self._so_query(s_emb, o_emb), None
        return self._sp_query(s_emb, p_emb), None


class ComplEx(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        super().__init__(
            config=config, dataset=dataset, scorer=ComplExScorer,
            configuration_key=configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )


class RescalScorer(RelationalScorer):
    """score = s^T M_p o with M_p the d x d reshape of the relation embedding
    (reference rescal.py:23-50)."""

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        n = s_emb.shape[0] if combine == "s_o" else p_emb.shape[0]
        ent_dim = s_emb.shape[1]
        p_mix = p_emb.reshape(-1, ent_dim, ent_dim)

        if combine == "spo":
            out = torch.einsum("nd,nde,ne->n", s_emb, p_mix, o_emb)
        elif combine == "sp_":
            out = torch.einsum("nd,nde->ne", s_emb, p_mix) @ o_emb.T
        elif combine == "_po":
            out = torch.einsum("nde,ne->nd", p_mix, o_emb) @ s_emb.T
        elif combine == "s_o":
            # score(p) = vec(s o^T) . vec(M_p) with M_p row-major [d, e]
            pairwise = torch.einsum("nd,ne->nde", s_emb, o_emb).reshape(n, -1)
            out = pairwise @ p_emb.T
        else:
            return super().score_emb(s_emb, p_emb, o_emb, combine)
        return out.reshape(n, -1)

    def score_emb_neg(self, s_emb, p_emb, o_emb, slot):
        query = self.factorize_slot(
            *(None if i == slot else e
              for i, e in enumerate((s_emb, p_emb, o_emb))), slot
        )[0]
        return _neg_dot(query, (s_emb, p_emb, o_emb)[slot])

    def factorize_slot(self, s_emb, p_emb, o_emb, slot):
        if slot == 1:
            pairwise = torch.einsum("nd,ne->nde", s_emb, o_emb)
            return pairwise.reshape(s_emb.shape[0], -1), None
        ent_dim = (o_emb if slot == 0 else s_emb).shape[-1]
        p_mix = p_emb.reshape(-1, ent_dim, ent_dim)
        if slot == 0:
            return torch.einsum("nde,ne->nd", p_mix, o_emb), None
        return torch.einsum("nd,nde->ne", s_emb, p_mix), None


def _set_relation_dim_to_square(config, model_self) -> None:
    """relation_embedder.dim = entity_dim^2 (reference rescal.py:81-95)."""
    rel_key = model_self.configuration_key + ".relation_embedder"
    dim = config.get_default(rel_key + ".dim")
    if dim < 0:
        ent_dim = config.get_default(
            model_self.configuration_key + ".entity_embedder.dim"
        )
        config.set(rel_key + ".dim", ent_dim ** 2, create=True, log=True)


class Rescal(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        self._init_configuration(config, configuration_key)
        _set_relation_dim_to_square(config, self)
        super().__init__(
            config=config, dataset=dataset, scorer=RescalScorer,
            configuration_key=self.configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )


class CPScorer(RelationalScorer):
    """Canonical Polyadic: the subject uses the first half of the entity
    embedding, the object the second half (reference cp.py:15-28)."""

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        n = p_emb.shape[0]
        half = s_emb.shape[1] // 2
        s_h = s_emb[:, :half]
        o_t = o_emb[:, half:]

        if combine == "spo":
            out = torch.sum(s_h * p_emb * o_t, dim=1)
        elif combine == "sp_":
            out = (s_h * p_emb) @ o_t.T
        elif combine == "_po":
            out = (o_t * p_emb) @ s_h.T
        else:
            return super().score_emb(s_emb, p_emb, o_emb, combine)
        return out.reshape(n, -1)

    def score_emb_neg(self, s_emb, p_emb, o_emb, slot):
        half = (o_emb if slot == 0 else s_emb).shape[-1] // 2
        if slot == 0:
            return _neg_dot(o_emb[:, half:] * p_emb, s_emb[:, :, :half])
        if slot == 1:
            return _neg_dot(s_emb[:, :half] * o_emb[:, half:], p_emb)
        return _neg_dot(s_emb[:, :half] * p_emb, o_emb[:, :, half:])

    def factorize_slot(self, s_emb, p_emb, o_emb, slot):
        if slot == 0:
            half = o_emb.shape[-1] // 2
            return o_emb[:, half:] * p_emb, lambda t: t[:, : t.shape[-1] // 2]
        if slot == 1:
            half = s_emb.shape[-1] // 2
            return s_emb[:, :half] * o_emb[:, half:], None
        half = s_emb.shape[-1] // 2
        return s_emb[:, :half] * p_emb, lambda t: t[:, t.shape[-1] // 2:]


class CP(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        self._init_configuration(config, configuration_key)
        if self.get_option("entity_embedder.dim") % 2 != 0:
            raise ValueError(
                "CP requires embeddings of even dimensionality (got {})".format(
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
            config=config, dataset=dataset, scorer=CPScorer,
            configuration_key=self.configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )


class SimplEScorer(RelationalScorer):
    """Average of forward and backward CP scores (reference simple.py:13-33)."""

    def score_emb(self, s_emb, p_emb, o_emb, combine):
        n = p_emb.shape[0]
        s_h, s_t = torch.chunk(s_emb, 2, dim=1)
        p_fwd, p_bwd = torch.chunk(p_emb, 2, dim=1)
        o_h, o_t = torch.chunk(o_emb, 2, dim=1)

        if combine == "spo":
            out1 = torch.sum(s_h * p_fwd * o_t, dim=1)
            out2 = torch.sum(s_t * p_bwd * o_h, dim=1)
        elif combine == "sp_":
            out1 = (s_h * p_fwd) @ o_t.T
            out2 = (s_t * p_bwd) @ o_h.T
        elif combine == "_po":
            out1 = (o_t * p_fwd) @ s_h.T
            out2 = (o_h * p_bwd) @ s_t.T
        else:
            return super().score_emb(s_emb, p_emb, o_emb, combine)
        return ((out1 + out2) / 2.0).reshape(n, -1)

    def score_emb_neg(self, s_emb, p_emb, o_emb, slot):
        query = self.factorize_slot(
            *(None if i == slot else e
              for i, e in enumerate((s_emb, p_emb, o_emb))), slot
        )[0]
        return _neg_dot(query, (s_emb, p_emb, o_emb)[slot])

    def factorize_slot(self, s_emb, p_emb, o_emb, slot):
        # the query laid out as [head half | tail half] to match the
        # candidate embedding layout, divided by 2
        if slot == 0:
            p_fwd, p_bwd = torch.chunk(p_emb, 2, dim=1)
            o_h, o_t = torch.chunk(o_emb, 2, dim=1)
            q = torch.cat([p_fwd * o_t, p_bwd * o_h], dim=1)
        elif slot == 1:
            s_h, s_t = torch.chunk(s_emb, 2, dim=1)
            o_h, o_t = torch.chunk(o_emb, 2, dim=1)
            q = torch.cat([s_h * o_t, s_t * o_h], dim=1)
        else:
            s_h, s_t = torch.chunk(s_emb, 2, dim=1)
            p_fwd, p_bwd = torch.chunk(p_emb, 2, dim=1)
            q = torch.cat([s_t * p_bwd, s_h * p_fwd], dim=1)
        return q / 2.0, None


class SimplE(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        self._init_configuration(config, configuration_key)
        if self.get_option("entity_embedder.dim") % 2 != 0:
            raise ValueError(
                "SimplE requires embeddings of even dimensionality (got {})".format(
                    self.get_option("entity_embedder.dim")
                )
            )
        super().__init__(
            config=config, dataset=dataset, scorer=SimplEScorer,
            configuration_key=self.configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )


class RelationalTucker3(KgeModel):
    """RESCAL scoring with a Tucker3 relation embedder: the mixing matrix is
    the projection of a low-dimensional relation embedding (reference
    relational_tucker3.py)."""

    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        self._init_configuration(config, configuration_key)
        ent_dim = config.get_default(
            self.configuration_key + ".entity_embedder.dim"
        )
        config.set(
            self.configuration_key + ".relation_embedder.dim",
            ent_dim ** 2,
            create=True,
            log=True,
        )
        super().__init__(
            config=config, dataset=dataset, scorer=RescalScorer,
            configuration_key=self.configuration_key,
            init_for_load_only=init_for_load_only, device=device,
        )
