"""Bag-of-binary-words place recognition (torch counterpart of
``okvis2x_tpu/frontend/bow.py``).

  * A vocabulary is either flat, k binary words as a (k, 12) int32 tensor,
    or a 2-level k-ary tree of them (`HierVocabulary`: B branches of L
    leaves as (B, 12) and (B*L, 12)), all bit-packed in the layout of the
    packed descriptors.  The JAX package keeps the words as ±1 bfloat16
    rows of 384.
  * Word assignment runs on the fused match kernel: for a flat vocabulary
    one launch and the nearest word; for the tree the nearest of the B
    branches, then the nearest of that branch's L leaves (each row gathers
    only its own branch's leaves: N x L distances, not N x B*L).  The JAX
    package takes the argmax of ±1 dot products; the dot is BITS - 2 *
    Hamming, so the argmax of the one is the argmin of the other, first
    index on ties in both.
  * Training is binary k-means: assignment on the fused match kernel (site
    "vocab"), then a majority vote per bit (`index_add_` of the members'
    bits; a tie gives 1, as the JAX package's sign(sums + 1e-6) gives +1).
    The initial centres are a seeded permutation (`init_indices`); the JAX
    package draws it from jax.random, whose stream torch cannot reproduce,
    so the same seed gives another draw here.  `train_vocabulary_core`
    takes the indices, which makes the rest exact against the JAX package.
  * Scoring is tf-idf cosine over a host inverted index (`BowDatabase`,
    plain numpy, copied from the JAX package).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from okvis2x_tpu_torch import default_device
from okvis2x_tpu_torch.ops import hamming

_SHIFTS = torch.arange(32, dtype=torch.int32)

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


    def save(self, path):
        """Write the packed .npz the JAX package's `HierVocabulary.load` reads
        (uint32 words, LSB-first bits)."""
        def words(x):
            return np.ascontiguousarray(x.cpu().numpy()).view(np.uint32)

        np.savez_compressed(path, branches=words(self.branches), leaves=words(self.leaves),
                            B=self.B, L=self.L, version=1)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(N, 12) int32 words -> (N, 384) int32 bits, bit k of a row at bit
    k % 32 of word k // 32."""
    sh = _SHIFTS.to(packed.device)
    return ((packed[:, :, None] >> sh) & 1).reshape(packed.shape[0], -1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of `unpack_bits`: (N, 384) 0/1 -> (N, 12) int32 words."""
    sh = _SHIFTS.to(bits.device)
    w = (bits.reshape(bits.shape[0], -1, 32).to(torch.int64) << sh).sum(-1)
    return (w - ((w >> 31) << 32)).to(torch.int32)  # the uint32 bits as int32


def init_indices(n: int, k: int, seed: int = 0) -> torch.Tensor:
    """The initial centres of `train_vocabulary`: the first k of a seeded
    permutation of the n descriptors (all n when n < k), on the CPU."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(int(seed)))[:k]


def train_vocabulary_core(packed: torch.Tensor, init_idx: torch.Tensor,
                          iters: int = 8) -> torch.Tensor:
    """Binary k-means of packed descriptors (N, 12) from the centres
    `packed[init_idx]`: (k, 12) int32 words.  Each iteration assigns every
    descriptor to its nearest centre (the fused match kernel, first index on
    ties) and sets a centre's bit to 1 where at least half of its members
    have it; a centre without members keeps its bits."""
    centers = packed[init_idx.to(packed.device)].contiguous()
    k = centers.shape[0]
    bits = unpack_bits(packed)
    for _ in range(iters):
        _, a, _ = hamming.hamming_match(packed, None, centers, None, site="vocab")
        a = a[:, 0]
        ones = torch.zeros((k, bits.shape[1]), dtype=torch.int32, device=packed.device)
        ones.index_add_(0, a, bits)
        counts = torch.bincount(a, minlength=k).to(torch.int32)
        new = pack_bits(2 * ones >= counts[:, None])
        centers = torch.where((counts > 0)[:, None], new, centers)
    return centers


def train_vocabulary(packed: torch.Tensor, k: int = 256, iters: int = 8,
                     seed: int = 0) -> torch.Tensor:
    """Flat vocabulary of k words trained on packed descriptors (N, 12)."""
    return train_vocabulary_core(packed, init_indices(packed.shape[0], k, seed), iters)


def train_vocabulary_hier(packed: torch.Tensor, branch: int = 64, leaf: int = 64,
                          iters: int = 8, seed: int = 0) -> HierVocabulary:
    """Hierarchical binary k-means: `branch` words over the corpus, then
    `leaf` words inside every branch.  A branch with fewer than `leaf`
    members gets 2 * leaf - members more rows drawn with replacement from the
    corpus (numpy's default_rng(seed), as in the JAX package)."""
    rng = np.random.default_rng(seed)
    branches = train_vocabulary(packed, k=branch, iters=iters, seed=seed)
    assign = assign_packed(packed, None, branches).cpu().numpy()
    leaves = torch.zeros((branch * leaf, hamming.WORDS), dtype=torch.int32,
                         device=packed.device)
    for b in range(branch):
        rows = np.nonzero(assign == b)[0]
        if len(rows) < leaf:
            extra = rng.integers(0, packed.shape[0], leaf - len(rows) + leaf)
            rows = np.concatenate([rows, extra])
        sub = packed[torch.as_tensor(rows, device=packed.device)]
        leaves[b * leaf:(b + 1) * leaf] = train_vocabulary(sub, k=leaf, iters=iters,
                                                           seed=seed + 1 + b)
    return HierVocabulary(branches, leaves)


def assign_packed(packed: torch.Tensor, valid, vocab) -> torch.Tensor:
    """(N,) int64 word ids of packed descriptors (N, 12) int32 in a flat
    (k, 12) or tree vocabulary.  Rows that `valid` (None: all valid) marks
    invalid get word 0, the word the JAX package's zero ±1 row falls to."""
    if isinstance(vocab, HierVocabulary):
        _, b, _ = hamming.hamming_match(packed, None, vocab.branches, None, site="bow")
        _, w, _ = hamming.hamming_match(packed, None, vocab.leaves, None, seg=vocab.L,
                                        row_seg=b[:, 0].to(torch.int32), site="bow")
    else:
        _, w, _ = hamming.hamming_match(packed, None, vocab, None, site="bow")
        w = w[:, 0]
    return w if valid is None else torch.where(valid, w, torch.zeros_like(w))


def n_words(vocab) -> int:
    return vocab.n_words if isinstance(vocab, HierVocabulary) else vocab.shape[0]


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
