"""Triangle clustering (meshlets) for the cluster intersector.

A copy of ``chiaroscuro_tpu/accel/clusters.py`` (plain numpy); its output
equals the JAX package's exactly (tests/test_torch_cluster.py).  On the
H100 the cull is K3 (``ops/cull_triton.py``) and the visits K6/K7
(``csrc/intersect_cluster.cu``); the notes below are the JAX package's.

The reference accelerates ray casts with a per-ray recursive kd-tree walk
(``src/kdtree.cpp:248-281``).  That shape of traversal — divergent,
data-dependent, one node at a time — is the worst case for a 128-lane SIMD
machine: measured on a v5e, a lock-step ``lax.while_loop`` BVH walk does
~0.1 Mray/s on the 19k-triangle nanosuit scene while the *brute-force* dense
Pallas sweep does ~200 Mray/s on cornell.  The TPU-native replacement is a
**two-level scheme built around dense work**:

1. triangles are clustered into fixed-size *meshlets* of ``M`` triangles
   (recursive largest-axis centroid-median split, so every leaf holds
   between M/2 and M triangles — >=50% occupancy by construction, tight
   AABBs computed from member triangle bounds);
2. a dense AABB slab sweep (pure XLA, VPU-friendly: K clusters x 128-ray
   rows, all elementwise) culls clusters per ray row and emits a compacted
   per-row cluster id list;
3. a Pallas kernel visits only the listed clusters per row, running the
   same (M x 128) Moller-Trumbore block as the dense kernel
   (``ops/intersect_pallas.py``) with a *dynamic* trip count.

Divergence is thus quantized to 128-ray-row granularity — coherent primary
rows visit a handful of clusters, incoherent bounce rows degrade gracefully
toward the dense sweep — and every instruction issued is a full-width
vector op.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

# Absolute AABB padding, mirroring the reference's root-box pad
# (``kdtree.cpp:106-107``); also guards the slab test against fp rounding so
# a cluster containing the true closest hit is never culled.
BOX_PAD = 1.0e-4


@dataclasses.dataclass
class ClusterArrays:
    """Host-side (numpy) meshlet decomposition of a triangle soup.

    ``K`` clusters of exactly ``M`` slots; real triangles occupy a prefix of
    each cluster, padded slots hold degenerate (all-zero) triangles whose
    Moller-Trumbore determinant is 0 — they can never hit.

    ``G`` consecutive clusters form a *group* and ``KS = ceil(K / G)``
    counts the groups — diagnostic metadata only since round 5: the
    two-level supercluster cull that consumed per-group union boxes was
    deleted after the flat sweep with wide near-ordered candidate lists
    beat it 2.3x at its own K=23,436 design point (BENCH_r05 ``atrium3m``;
    docs/ROOFLINE.md r5 deletion record).
    """

    K: int
    M: int
    bbox_min: np.ndarray   # (K, 3) f32, padded by BOX_PAD
    bbox_max: np.ndarray   # (K, 3) f32
    tri_rows: np.ndarray   # (K*M, 9) f32 [v0|e1|e2] in cluster order
    orig_id: np.ndarray    # (K*M,) i32 original triangle id; INT32_MAX pad
    order: np.ndarray      # (T,) i32 cluster-order permutation of 0..T-1
    G: int = 16            # clusters per group (diagnostic metadata)
    KS: int = 0            # number of groups = ceil(K / G)


def build_clusters(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, M: int = 128,
    pack: bool = True, G: int = 16,
) -> ClusterArrays:
    """Median-split the triangle soup into meshlets of <= M triangles.

    Largest-centroid-extent axis, exact median — every split halves the set,
    so the recursion yields a balanced spatial ordering of the triangles.

    ``pack=True`` (default) then re-chunks that DFS ordering into *full*
    clusters of exactly M consecutive triangles: the kernel pays for K*M
    dense Moller-Trumbore slots whether they hold real triangles or padding,
    so slot occupancy is worth more than per-leaf box tightness (measured
    v5e/nanosuit: median leaves alone give 58% occupancy).  ``pack=False``
    keeps one cluster per median-split leaf (tighter boxes, more padding).
    """
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    T = len(v0)
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroid = (tri_min + tri_max) * 0.5

    clusters: list[np.ndarray] = []
    stack = [np.arange(T, dtype=np.int64)]
    while stack:
        ids = stack.pop()
        if len(ids) <= M:
            clusters.append(ids)
            continue
        c = centroid[ids]
        axis = int((c.max(axis=0) - c.min(axis=0)).argmax())
        order = np.argsort(c[:, axis], kind="stable")
        half = len(ids) // 2
        # Push right first so the left child is processed next (DFS order =
        # spatial locality in the flattened cluster sequence).
        stack.append(ids[order[half:]])
        stack.append(ids[order[:half]])

    if pack and T > M:
        dfs = np.concatenate(clusters)
        clusters = [dfs[i : i + M] for i in range(0, T, M)]

    K = len(clusters)
    bmin = np.empty((K, 3), np.float32)
    bmax = np.empty((K, 3), np.float32)
    tri_rows = np.zeros((K * M, 9), np.float32)
    orig_id = np.full(K * M, np.iinfo(np.int32).max, np.int32)
    order_out = np.empty(T, np.int64)
    pos = 0
    for k, ids in enumerate(clusters):
        bmin[k] = tri_min[ids].min(axis=0) - BOX_PAD
        bmax[k] = tri_max[ids].max(axis=0) + BOX_PAD
        n = len(ids)
        base = k * M
        tri_rows[base : base + n, 0:3] = v0[ids]
        tri_rows[base : base + n, 3:6] = v1[ids] - v0[ids]
        tri_rows[base : base + n, 6:9] = v2[ids] - v0[ids]
        orig_id[base : base + n] = ids
        order_out[pos : pos + n] = ids
        pos += n

    KS = -(-K // G)
    return ClusterArrays(
        K=K, M=M, bbox_min=bmin, bbox_max=bmax,
        tri_rows=tri_rows, orig_id=orig_id,
        order=order_out.astype(np.int32),
        G=G, KS=KS,
    )


def cluster_arrays_from_numpy(fields: Mapping) -> ClusterArrays:
    """ClusterArrays from values keyed by its field names — e.g. the JAX
    package's ``build_clusters`` output read out field by field, so that
    both packages visit the very same clusters."""
    return ClusterArrays(**{
        f.name: (np.array(fields[f.name]) if f.type == "np.ndarray"
                 else int(fields[f.name]))
        for f in dataclasses.fields(ClusterArrays)
    })
