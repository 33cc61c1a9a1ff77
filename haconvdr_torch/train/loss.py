"""Contrastive ranking losses (counterpart of haconvdr_tpu/train/loss.py).

  * ``ranking_loss``        — cal_ranking_loss: CE over [in-batch positives
    | optional hard negatives], labels = arange(B); negatives may be one per
    example ``[B, D]`` or R per example ``[B, R, D]`` with ``neg_valid``;
  * ``ranking_loss_prepos`` — cal_ranking_loss_prepos: the positive score
    matrix plus alpha x the pseudo-prepos score matrix, then one BM25-hard-neg
    column, then one prepos-neg column;
  * ``kd_loss``             — cal_kd_loss (MSE).

As in the JAX package, per-example presence masks gate the optional terms:
absent pseudo columns add no alpha term, absent prepos negatives score
-1e9, and rows padded by the static-shape loader leave the mean and the
in-batch negatives.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e9


def _ce_rows(score_mat: torch.Tensor, valid_rows: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with labels = arange(B), averaged over valid rows."""
    picked = torch.log_softmax(score_mat, dim=1).diagonal()
    v = valid_rows.to(torch.float32)
    return -(picked * v).sum() / torch.clamp_min(v.sum(), 1.0)


def _mask_invalid_columns(pos_scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Padded examples do not act as in-batch negatives: their columns
    score -1e9 (the diagonal stays, so padded rows stay finite)."""
    B = pos_scores.shape[0]
    keep = valid.to(torch.bool)[None, :] | torch.eye(B, dtype=torch.bool, device=pos_scores.device)
    return torch.where(keep, pos_scores, torch.full_like(pos_scores, _NEG))


def _valid(valid: Optional[torch.Tensor], q: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.ones(q.shape[0], dtype=torch.int32, device=q.device)
    return valid


def ranking_loss(
    query_embs: torch.Tensor,  # [B, D]
    pos_doc_embs: torch.Tensor,  # [B, D]
    neg_doc_embs: Optional[torch.Tensor] = None,  # [B, D] or [B, R, D]
    valid: Optional[torch.Tensor] = None,  # [B]
    neg_valid: Optional[torch.Tensor] = None,  # [B, R] 0/1 (multi-negative padding)
) -> torch.Tensor:
    valid = _valid(valid, query_embs)
    score_mat = _mask_invalid_columns(query_embs @ pos_doc_embs.T, valid)
    if neg_doc_embs is not None:
        if neg_doc_embs.dim() == 3:
            neg_scores = torch.einsum("bd,brd->br", query_embs, neg_doc_embs)
            if neg_valid is not None:
                neg_scores = torch.where(
                    neg_valid.to(torch.bool), neg_scores, torch.full_like(neg_scores, _NEG)
                )
        else:
            neg_scores = (query_embs * neg_doc_embs).sum(dim=1)[:, None]
        score_mat = torch.cat([score_mat, neg_scores], dim=1)
    return _ce_rows(score_mat, valid)


def ranking_loss_prepos(
    query_embs: torch.Tensor,  # [B, D]
    pos_doc_embs: torch.Tensor,  # [B, D]
    bm25_neg_doc_embs: torch.Tensor,  # [B, D]
    pseudo_prepos_embs: Optional[torch.Tensor] = None,  # [B, D]
    prepos_neg_doc_embs: Optional[torch.Tensor] = None,  # [B, D]
    has_pseudo: Optional[torch.Tensor] = None,  # [B] 0/1
    has_prepos_neg: Optional[torch.Tensor] = None,  # [B] 0/1
    alpha: float = 1.0,
    is_pseudo_prepos: bool = True,
    is_prepos_neg: bool = True,
    valid: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    valid = _valid(valid, query_embs)
    score_mat = query_embs @ pos_doc_embs.T
    if is_pseudo_prepos and pseudo_prepos_embs is not None:
        pseudo = query_embs @ pseudo_prepos_embs.T
        if has_pseudo is not None:
            pseudo = pseudo * has_pseudo.to(torch.float32)[None, :]
        score_mat = score_mat + alpha * pseudo
    score_mat = _mask_invalid_columns(score_mat, valid)
    bm25 = (query_embs * bm25_neg_doc_embs).sum(dim=1)[:, None]
    score_mat = torch.cat([score_mat, bm25], dim=1)
    if is_prepos_neg and prepos_neg_doc_embs is not None:
        pn = (query_embs * prepos_neg_doc_embs).sum(dim=1)[:, None]
        if has_prepos_neg is not None:
            pn = torch.where(has_prepos_neg.to(torch.bool)[:, None], pn, torch.full_like(pn, _NEG))
        score_mat = torch.cat([score_mat, pn], dim=1)
    return _ce_rows(score_mat, valid)


def kd_loss(query_embs: torch.Tensor, kd_embs: torch.Tensor) -> torch.Tensor:
    return ((query_embs - kd_embs) ** 2).mean()
