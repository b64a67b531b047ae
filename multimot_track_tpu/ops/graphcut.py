"""Multi-label motion segmentation — the gco graph-cut subsystem, batched.

The reference ships (dormant) a full alpha-expansion MRF pipeline over
dynamic points (src/Tracking.cc:4445-4836 + src/gco):

  data term        D(i, l) = lambda * min(reproj_err(i | motion_l), cap)
                   with lambda = 80, cap = 16 (``DataEnergy``)
  smoothness       Potts, beta = 1, neighbor weight 100 * exp(-d / 49)
                   over a Delaunay adjacency (``SmoothnessEnergy``/``Delaunay``)
  hypotheses       PnP on 4-point minimal sets drawn from 6 nearest
                   neighbours (``GetMSS``/``GetModel``)

True max-flow alpha-expansion is inherently sequential; per SURVEY.md §7
("Graph-cut exactness") the device design solves the same energy with a
batched mean-field relaxation + ICM polish — dense linear algebra over a
k-NN graph, judged by end-metric (energy/segmentation) parity rather than
expansion-step parity.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from multimot_track_tpu.geometry import camera
from multimot_track_tpu.solvers import horn

LAMBDA = 80.0        # data-term scale (Tracking.cc DataEnergy)
COST_CAP = 16.0      # reprojection-error cap
SMOOTH_SCALE = 100.0  # neighbor weight = 100 * exp(-d / 49)
SMOOTH_DECAY = 49.0


class SegGraph(NamedTuple):
    nbr_idx: jnp.ndarray   # (N, K) neighbor indices
    nbr_w: jnp.ndarray     # (N, K) smoothness weights
    valid: jnp.ndarray     # (N,)


def build_knn_graph(uv: jnp.ndarray, valid: jnp.ndarray, k: int = 6) -> SegGraph:
    """k-NN adjacency in image space (stand-in for the Delaunay adjacency;
    same weight law)."""
    d2 = jnp.sum((uv[:, None, :] - uv[None, :, :]) ** 2, axis=-1)
    big = jnp.float32(1e12)
    N = uv.shape[0]
    eye = jnp.eye(N, dtype=bool)
    d2 = jnp.where(valid[None, :] & ~eye, d2, big)
    d2 = jnp.where(valid[:, None], d2, big)
    neg = -d2
    top, idx = jax.lax.top_k(neg, k)
    dist = jnp.sqrt(jnp.maximum(-top, 0.0))
    w = SMOOTH_SCALE * jnp.exp(-dist / SMOOTH_DECAY)
    w = jnp.where((-top) < big * 0.5, w, 0.0)
    return SegGraph(nbr_idx=idx.astype(jnp.int32), nbr_w=w, valid=valid)


def sample_motion_hypotheses(
    key: jax.Array,
    graph: SegGraph,
    Xw_last: jnp.ndarray,   # (N, 3) last-frame points (world)
    xyz_cur: jnp.ndarray,   # (N, 3) current-frame points (camera)
    n_hyp: int = 32,
    mss_size: int = 4,
) -> jnp.ndarray:
    """Minimal-sample-set hypotheses: pick a seed point, take ``mss_size``
    of its nearest neighbours (GetMSS), fit a rigid motion (GetModel's PnP
    replaced by Horn 3D-3D, same role).  Returns (n_hyp, 4, 4)."""
    N = graph.nbr_idx.shape[0]
    vf = graph.valid.astype(jnp.float32)
    p = vf / jnp.maximum(jnp.sum(vf), 1.0)
    seeds = jax.random.choice(key, N, shape=(n_hyp,), p=p)
    k = graph.nbr_idx.shape[1]
    take = min(mss_size - 1, k)  # static: shapes must not trace
    nbrs = graph.nbr_idx[seeds][:, :take]                  # (n_hyp, take)
    members = jnp.concatenate([seeds[:, None], nbrs], axis=1)  # (n_hyp, mss)
    src = Xw_last[members]
    dst = xyz_cur[members]
    return horn.rigid_align(src, dst)


def dedupe_hypotheses(T_hyp: jnp.ndarray, rot_tol: float = 0.01, t_tol: float = 0.05):
    """Mask near-identical motion hypotheses (keep the first of each group).

    Duplicate hypotheses split one rigid region across several labels and
    leave parallel label updates free to oscillate; alpha-expansion is
    immune because it sweeps labels sequentially.  Returns a (L,) bool mask
    of representatives.
    """
    L = T_hyp.shape[0]
    rel = jnp.einsum("aij,bjk->abik", T_hyp, jnp.linalg.inv(T_hyp))
    t = jnp.linalg.norm(rel[..., :3, 3], axis=-1)
    tr = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    ang = jnp.arccos(jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0))
    same = (t < t_tol) & (ang < rot_tol)
    earlier = jnp.tril(same, k=-1)                 # same as an earlier hypothesis
    return ~jnp.any(earlier, axis=1)


def data_costs(
    T_hyp: jnp.ndarray,     # (L, 4, 4) motion hypotheses (world -> cur cam)
    Xw_last: jnp.ndarray,   # (N, 3)
    uv_cur: jnp.ndarray,    # (N, 2)
    fx, fy, cx, cy,
) -> jnp.ndarray:
    """(N, L) capped, scaled reprojection costs (DataEnergy semantics)."""
    y = jnp.einsum("lij,nj->lni", T_hyp[:, :3, :3], Xw_last) + T_hyp[:, None, :3, 3]
    uv_hat = camera.project(y, fx, fy, cx, cy)
    err = jnp.linalg.norm(uv_hat - uv_cur[None], axis=-1)   # (L, N)
    return (LAMBDA * jnp.minimum(err, COST_CAP)).T          # (N, L)


def total_energy(labels, D, graph: SegGraph) -> jnp.ndarray:
    """E = sum_i D(i, l_i) + sum_edges w_ij [l_i != l_j] (Potts beta=1)."""
    data = jnp.sum(jnp.where(graph.valid, jnp.take_along_axis(D, labels[:, None], 1)[:, 0], 0.0))
    nl = labels[graph.nbr_idx]                               # (N, K)
    diff = (nl != labels[:, None]) & graph.valid[:, None] & graph.valid[graph.nbr_idx]
    smooth = 0.5 * jnp.sum(jnp.where(diff, graph.nbr_w, 0.0))
    return data + smooth


@functools.partial(jax.jit, static_argnames=("n_mf_iters", "n_icm_iters"))
def segment(
    D: jnp.ndarray,          # (N, L) data costs
    graph: SegGraph,
    n_mf_iters: int = 20,
    n_icm_iters: int = 5,
    temperature: float = 20.0,
):
    """Mean-field relaxation annealed to hard labels, ICM-polished.

    Returns (labels (N,), energy ()).
    """
    N, L = D.shape

    def gather_q(q):
        return q[graph.nbr_idx]                              # (N, K, L)

    def mf_step(i, q):
        temp = temperature * (0.5 ** (i.astype(jnp.float32) / 5.0))
        qn = gather_q(q)
        # expected Potts penalty for assigning label l at i
        pen = jnp.einsum("nk,nkl->nl", graph.nbr_w, 1.0 - qn)
        logits = -(D + pen) / jnp.maximum(temp, 1e-3)
        # damped update: parallel mean-field on a graph oscillates undamped
        return 0.5 * q + 0.5 * jax.nn.softmax(logits, axis=-1)

    q0 = jax.nn.softmax(-D / temperature, axis=-1)
    q = jax.lax.fori_loop(0, n_mf_iters, mf_step, q0)
    labels = jnp.argmax(q, axis=-1).astype(jnp.int32)

    def icm_step(_, labels):
        onehot = jax.nn.one_hot(labels, L)
        nb = onehot[graph.nbr_idx]                           # (N, K, L)
        pen = jnp.einsum("nk,nkl->nl", graph.nbr_w, 1.0 - nb)
        return jnp.argmin(D + pen, axis=-1).astype(jnp.int32)

    labels = jax.lax.fori_loop(0, n_icm_iters, icm_step, labels)
    e_mf = total_energy(labels, D, graph)
    # Constant-labeling guard: in the smoothness-dominated regime parallel
    # mean-field can fail to break the label symmetry and fragment (measured
    # ~10x the exact energy on random data costs with near-saturated
    # weights); the best single-label assignment has zero Potts cost and is
    # one masked column-sum + argmin.  Keep whichever energy is lower.
    data_cols = jnp.sum(jnp.where(graph.valid[:, None], D, 0.0), axis=0)  # (L,)
    const_lab = jnp.argmin(data_cols).astype(jnp.int32)
    e_const = data_cols[const_lab]
    take_const = e_const < e_mf
    labels = jnp.where(take_const, jnp.full_like(labels, const_lab), labels)
    return labels, jnp.minimum(e_mf, e_const)


# ---------------------------------------------------------------------------
# Exact native solver (alpha-expansion over max-flow) — the counterpart of
# the reference's gco library itself (src/gco/maxflow.cpp), built as
# native/graphcut.cc (Dinic max-flow + the Boykov-Veksler-Zabih move
# construction).  The jitted ``segment`` relaxation above remains the
# production path; this is the exactness oracle it is validated against
# (SURVEY.md §7 "Graph-cut exactness") and an offline host-side refiner.

_GC_DLL = None


def _graphcut_dll():
    global _GC_DLL
    if _GC_DLL is None:
        import ctypes
        import pathlib
        import subprocess

        native = pathlib.Path(__file__).resolve().parent.parent / "native"
        lib = native / "libmmt_graphcut.so"
        if not lib.exists():
            subprocess.run(
                ["make", "-C", str(native), "libmmt_graphcut.so"],
                check=True, capture_output=True,
            )
        dll = ctypes.CDLL(str(lib))
        dll.mmt_alpha_expansion.restype = ctypes.c_int
        dll.mmt_alpha_expansion.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        dll.mmt_binary_cut.restype = ctypes.c_float
        dll.mmt_binary_cut.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        _GC_DLL = dll
    return _GC_DLL


def graph_to_edges(graph: SegGraph):
    """Undirected unique edge list from the k-NN adjacency, with weights
    matched to ``total_energy``'s accounting (0.5 * sum over directed
    slots: an asymmetric neighbor pair carries half weight)."""
    import numpy as np

    idx = np.asarray(graph.nbr_idx)
    w = np.asarray(graph.nbr_w)
    valid = np.asarray(graph.valid)
    N, K = idx.shape
    acc = {}
    for i in range(N):
        if not valid[i]:
            continue
        for k in range(K):
            j = int(idx[i, k])
            if w[i, k] <= 0 or not valid[j] or j == i:
                continue
            key = (i, j) if i < j else (j, i)
            acc[key] = acc.get(key, 0.0) + 0.5 * float(w[i, k])
    if not acc:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float32))
    ei = np.asarray([k[0] for k in acc], np.int32)
    ej = np.asarray([k[1] for k in acc], np.int32)
    ew = np.asarray(list(acc.values()), np.float32)
    return ei, ej, ew


def segment_exact(D, graph: SegGraph, init_labels=None, max_sweeps: int = 8):
    """Exact alpha-expansion on the host (gco's role).  Invalid sites carry
    no data or smoothness cost during the solve; their returned labels are
    set to their own argmin-D afterwards (they are unconstrained).  Returns
    (labels (N,), energy ()) — energy comparable to ``total_energy``."""
    import ctypes

    import numpy as np

    D_orig = np.asarray(D, np.float32)
    # invalid sites contribute nothing (matches total_energy's masking)
    D = np.ascontiguousarray(
        np.where(np.asarray(graph.valid)[:, None], D_orig, 0.0).astype(np.float32)
    )
    N, L = D.shape
    ei, ej, ew = graph_to_edges(graph)
    labels = (
        np.asarray(init_labels, np.int32).copy()
        if init_labels is not None
        else np.argmin(D, axis=1).astype(np.int32)
    )
    energy = np.zeros(1, np.float32)
    dll = _graphcut_dll()
    dll.mmt_alpha_expansion(
        N, L, D.ctypes.data_as(ctypes.c_void_p),
        len(ew),
        np.ascontiguousarray(ei).ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(ej).ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(ew).ctypes.data_as(ctypes.c_void_p),
        max_sweeps,
        labels.ctypes.data_as(ctypes.c_void_p),
        energy.ctypes.data_as(ctypes.c_void_p),
    )
    valid = np.asarray(graph.valid)
    if not valid.all():
        labels = np.where(
            valid, labels, np.argmin(np.asarray(D_orig), axis=1).astype(np.int32)
        )
    return labels, float(energy[0])
