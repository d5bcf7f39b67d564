"""Factorization-family scorers: ComplEx.

Scoring semantics match kge_tpu/models/factorization.py and the reference
(kge/model/complex.py). DistMult, RESCAL, CP, SimplE and RelationalTucker3
are not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from kge_tpu_torch.models.base import KgeModel, RelationalScorer


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
