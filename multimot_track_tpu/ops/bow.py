"""Compact bag-of-words retrieval for large keyframe databases.

The direct descriptor-matmul place recognition (pipeline/keyframes) is
exact but scales with total stored descriptors; the reference's DBoW2
vocabulary + inverted index (Thirdparty/DBoW2, KeyFrameDatabase) exists
precisely to make retrieval sub-linear at thousands of keyframes.  The
device equivalent keeps everything dense:

  vocabulary  k-means over {-1,+1} descriptors (trained on the fly from
              the first keyframes — no ORBvoc.txt download; assignment is
              one matmul since Hamming distance is monotone in the dot
              product)
  signature   per-keyframe TF-IDF-weighted word histogram, L2-normalised
  retrieval   query signature . database signatures — one (K, V) matmul
              regardless of descriptor counts

This matches DBoW2's scoring model (TF-IDF with L1/L2 scoring,
TemplatedVocabulary::transform + BowVector) in dense-tensor form.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Vocabulary(NamedTuple):
    words: jnp.ndarray    # (V, D) float32 centroids in sign space
    idf: jnp.ndarray      # (V,) inverse-document-frequency weights


@functools.partial(jax.jit, static_argnames=("n_words", "iters"))
def train_vocabulary(
    key: jax.Array,
    desc: jnp.ndarray,     # (N, D) int8 sign descriptors (training set)
    valid: jnp.ndarray,    # (N,)
    n_words: int = 256,
    iters: int = 10,
) -> Vocabulary:
    """k-means in dot-product space (equivalent to Hamming for sign data)."""
    N, D = desc.shape
    x = desc.astype(jnp.float32)
    vf = valid.astype(jnp.float32)
    p = vf / jnp.maximum(vf.sum(), 1.0)
    init_idx = jax.random.choice(key, N, shape=(n_words,), replace=False, p=p)
    words = x[init_idx]

    def step(_, words):
        sims = x @ words.T                               # (N, V)
        assign = jnp.argmax(sims, axis=1)
        onehot = jax.nn.one_hot(assign, n_words) * vf[:, None]
        sums = onehot.T @ x                              # (V, D)
        counts = onehot.sum(0)[:, None]
        new = jnp.where(counts > 0, sums / jnp.maximum(counts, 1.0), words)
        return new

    words = jax.lax.fori_loop(0, iters, step, words)
    # idf from the training distribution (DBoW2 computes idf over training
    # features as well)
    sims = x @ words.T
    assign = jnp.argmax(sims, axis=1)
    df = jnp.zeros(n_words).at[assign].add(vf)
    idf = jnp.log(jnp.maximum(vf.sum(), 1.0) / jnp.maximum(df, 1.0) + 1.0)
    return Vocabulary(words=words, idf=idf)


@jax.jit
def signature(voc: Vocabulary, desc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """(N, D) descriptors -> (V,) L2-normalised TF-IDF word histogram."""
    sims = desc.astype(jnp.float32) @ voc.words.T
    assign = jnp.argmax(sims, axis=1)
    hist = jnp.zeros(voc.words.shape[0]).at[assign].add(valid.astype(jnp.float32))
    v = hist * voc.idf
    return v / jnp.maximum(jnp.linalg.norm(v), 1e-9)


@jax.jit
def retrieve(query_sig: jnp.ndarray, db_sigs: jnp.ndarray) -> jnp.ndarray:
    """Similarity of a query signature against a (K, V) database — the
    KeyFrameDatabase::DetectLoopCandidates scoring, one matvec."""
    return db_sigs @ query_sig
