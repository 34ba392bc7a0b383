"""Bag-of-binary-words place recognition (torch counterpart of
``okvis2x_tpu/frontend/bow.py``).

  * The vocabulary is a 2-level k-ary tree of binary words (B branches of
    L leaves), kept bit-packed as (B, 12) and (B*L, 12) int32 words, the
    layout of the packed descriptors.
  * Word assignment is the tree descent on the fused match kernel: the
    nearest of the B branches, then the nearest of that branch's L leaves
    (each row gathers only its own branch's leaves: N x L distances, not
    N x B*L).  The JAX package takes the argmax of ±1 dot products;
    the dot is BITS - 2 * Hamming, so the argmax of the one is the argmin of
    the other, first index on ties in both.
  * Scoring is tf-idf cosine over a host inverted index (`BowDatabase`,
    plain numpy, copied from the JAX package).

Online vocabulary training is not part of the port yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from okvis2x_tpu_torch import default_device
from okvis2x_tpu_torch.ops import hamming

# the vocabulary shipped with the JAX package: a data file, read in place
DEFAULT_VOCAB = (Path(__file__).resolve().parents[2] / "okvis2x_tpu" / "resources"
                 / "vocab_b64l64.npz")


class HierVocabulary:
    """Two-level vocabulary tree; leaf b*L + l hangs under branch b."""

    def __init__(self, branches: torch.Tensor, leaves: torch.Tensor):
        self.branches = branches  # (B, 12) int32 packed words
        self.leaves = leaves  # (B*L, 12) int32 packed words
        self.B = branches.shape[0]
        self.L = leaves.shape[0] // self.B

    @property
    def n_words(self) -> int:
        return self.leaves.shape[0]

    def to(self, device) -> "HierVocabulary":
        return HierVocabulary(self.branches.to(device), self.leaves.to(device))

    @classmethod
    def load(cls, path=DEFAULT_VOCAB, device=None) -> "HierVocabulary":
        """Read the packed .npz (uint32 words, LSB-first bits) as int32 onto
        `device` (None: the first CUDA device)."""
        device = default_device() if device is None else torch.device(device)
        z = np.load(path)

        def words(a):
            a = np.ascontiguousarray(np.asarray(a, np.uint32)).view(np.int32)
            return torch.from_numpy(a.copy()).to(device)

        return cls(words(z["branches"]), words(z["leaves"]))


def assign_packed(packed: torch.Tensor, valid: torch.Tensor,
                  vocab: HierVocabulary) -> torch.Tensor:
    """(N,) int64 word ids of packed descriptors (N, 12) int32.  Invalid rows
    get word 0, the word the JAX package's zero ±1 row falls to."""
    _, b, _ = hamming.hamming_match(packed, None, vocab.branches, None, site="bow")
    _, w, _ = hamming.hamming_match(packed, None, vocab.leaves, None, seg=vocab.L,
                                    row_seg=b[:, 0].to(torch.int32), site="bow")
    return torch.where(valid, w, torch.zeros_like(w))


class BowDatabase:
    """Host inverted index with tf-idf scoring (≙ DBoW2 Database::query)."""

    def __init__(self, k: int):
        self.k = k
        self.inv: List[Dict[int, float]] = [dict() for _ in range(k)]
        self.frame_tf: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.n_frames = 0
        self.word_df = np.zeros(k, np.int64)  # document frequency

    def _bow_vector(self, words: np.ndarray, valid: np.ndarray):
        w = words[valid]
        ids, counts = np.unique(w, return_counts=True)
        tf = counts / max(len(w), 1)
        return ids, tf

    def _idf(self) -> np.ndarray:
        return np.log(max(self.n_frames, 2) / np.maximum(self.word_df, 1))

    def add(self, frame_id: int, words: np.ndarray, valid: np.ndarray):
        ids, tf = self._bow_vector(words, valid)
        for wid, v in zip(ids, tf):
            self.inv[wid][frame_id] = float(v)
            self.word_df[wid] += 1
        self.frame_tf[frame_id] = (ids, tf)
        self.n_frames += 1

    def query(
        self,
        words: np.ndarray,
        valid: np.ndarray,
        exclude: set = frozenset(),
        top: int = 5,
    ) -> List[Tuple[int, float]]:
        """Returns [(frame_id, score)] best-first — cosine similarity of
        tf-idf vectors under the *current* idf (identical frames score 1.0,
        matching DBoW2's normalised scoring)."""
        if self.n_frames == 0:
            return []
        ids, tf = self._bow_vector(words, valid)
        idf = self._idf()
        q_idf = idf[ids]
        scores: Dict[int, float] = {}
        for wid, v, w_idf in zip(ids, tf, q_idf):
            for fid, u in self.inv[wid].items():
                if fid in exclude:
                    continue
                scores[fid] = scores.get(fid, 0.0) + v * u * w_idf * w_idf
        qn = float(np.linalg.norm(tf * q_idf)) + 1e-12
        out = []
        for fid, s in scores.items():
            f_ids, f_tf = self.frame_tf[fid]
            dn = float(np.linalg.norm(f_tf * idf[f_ids])) + 1e-12
            out.append((fid, s / (qn * dn)))
        out.sort(key=lambda x: -x[1])
        return out[:top]
