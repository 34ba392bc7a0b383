"""Descriptor matching on packed descriptors (torch counterpart of
``okvis2x_tpu/frontend/matcher.py``).

The JAX package computes Hamming distances as a ±1 bf16 matmul,
(BITS - a·b) / 2, a TPU formulation.  Here the distances come from the
packed-descriptor kernels (``ops.hamming``), and the ±1 semantics are kept:
a row that is invalid (a zero ±1 vector) is at distance BITS/2 = 192 from
everything, and cells outside the `allowed` mask get BITS = 384.
`match_masked` runs on the fused match kernel; `hamming_matrix` and `match`
(whose ratio test needs the second-best distance) on the matrix kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from okvis2x_tpu_torch.ops import hamming

DESC_BITS = hamming.DESC_BITS


class Matches(NamedTuple):
    idx_b: torch.Tensor  # (N,) best match in B for each A (int64)
    dist: torch.Tensor  # (N,) float32 Hamming distance of the best match
    valid: torch.Tensor  # (N,) bool — passed the threshold


def hamming_matrix(packed_a, valid_a, packed_b, valid_b) -> torch.Tensor:
    """(N, M) float32 distances: Hamming where both rows are valid, else 192."""
    D = hamming.hamming_matrix_packed(packed_a, packed_b).to(torch.float32)
    both = valid_a[:, None] & valid_b[None, :]
    return torch.where(both, D, torch.full_like(D, DESC_BITS / 2))


def match(packed_a, valid_a, packed_b, valid_b, max_dist: float = 60.0,
          ratio: float = 0.0, mutual: bool = False) -> Matches:
    """Best match A -> B with a distance threshold, and optionally Lowe's
    ratio test against the second-best distance and a mutual check."""
    D = hamming_matrix(packed_a, valid_a, packed_b, valid_b)
    idx = torch.argmin(D, dim=1)
    d1 = torch.gather(D, 1, idx[:, None])[:, 0]
    ok = d1 <= max_dist
    if ratio > 0:
        # second-best: the row minimum with the best column taken out (an
        # equal distance elsewhere counts, as with a top-2 selection)
        d2 = D.scatter(1, idx[:, None], float("inf")).min(dim=1).values
        ok = ok & (d1 <= ratio * d2)
    if mutual:
        back = torch.argmin(D, dim=0)
        ok = ok & (back[idx] == torch.arange(D.shape[0], device=D.device))
    return Matches(idx_b=idx, dist=d1, valid=ok)


def match_masked(packed_a, valid_a, packed_b, valid_b, allowed, max_dist: float = 60.0,
                 mutual: bool = False) -> Matches:
    """Best match of each A row restricted to the `allowed` (N, M) mask (a
    contiguous bool tensor), optionally with a mutual check.  Runs on the
    fused match kernel: the (N, M) distances are never written."""
    d1, idx, back = hamming.hamming_match(
        packed_a, valid_a, packed_b, valid_b, allowed=allowed,
        fill_invalid=DESC_BITS // 2, fill_disallowed=DESC_BITS, want_cols=mutual)
    idx, d1 = idx[:, 0], d1[:, 0].to(torch.float32)
    ok = d1 <= max_dist
    if mutual:
        ok = ok & (back[idx] == torch.arange(idx.shape[0], device=idx.device))
    return Matches(idx_b=idx, dist=d1, valid=ok)
