"""HDBSCAN on a dense distance matrix, in numpy.

The port segments trajectories with this, always: the card's machine has
no scikit-learn, and the JAX package's ``segment_traj`` calls
``sklearn.cluster.HDBSCAN``. It follows scikit-learn 1.9.0's own steps for
a dense matrix, so its labels are sklearn's label for label:

1. core distances: each row's ``min_samples``-th smallest entry, the point
   itself counted (``np.partition``, ``_reachability.pyx``);
2. mutual reachability ``max(core_i, core_j, d_ij)``;
3. Prim's minimum spanning tree from node 0, the first minimum taken by
   ``argmin`` (``_linkage.pyx: mst_from_mutual_reachability``);
4. the edges sorted by one ``np.argsort`` call of the default kind, so
   ties break as sklearn's do (``hdbscan.py: _process_mst``);
5. the single-linkage tree through a union-find (``make_single_linkage``),
   the condensed tree at ``min_cluster_size`` (``_condense_tree``) and the
   cluster stabilities (``_compute_stability``);
6. excess-of-mass selection without ``allow_single_cluster`` and sklearn's
   label numbering (``_get_clusters``, ``_do_labelling``).

Points that join no selected cluster are labelled -1 (noise).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

MST_EDGE_DTYPE = np.dtype([("current_node", np.int64),
                           ("next_node", np.int64),
                           ("distance", np.float64)])
HIERARCHY_DTYPE = np.dtype([("left_node", np.intp), ("right_node", np.intp),
                            ("value", np.float64), ("cluster_size", np.intp)])
CONDENSED_DTYPE = np.dtype([("parent", np.intp), ("child", np.intp),
                            ("value", np.float64), ("cluster_size", np.intp)])


def mutual_reachability(distances: np.ndarray, min_samples: int) -> np.ndarray:
    """``max(core_i, core_j, d_ij)`` with each core distance the row's
    ``min_samples``-th smallest entry (the diagonal included)."""
    d = np.array(distances, dtype=np.float64)
    core = np.partition(d, min_samples - 1, axis=1)[:, min_samples - 1]
    return np.maximum(np.maximum(core[:, None], core[None, :]), d)


def minimum_spanning_tree(reach: np.ndarray) -> np.ndarray:
    """Prim's tree over the dense graph, from node 0; the edges in the
    order they join."""
    n = reach.shape[0]
    mst = np.empty(n - 1, dtype=MST_EDGE_DTYPE)
    labels = np.arange(n, dtype=np.int64)
    current = 0
    min_reach = np.full(n, np.inf, dtype=np.float64)
    for i in range(n - 1):
        keep = labels != current
        labels = labels[keep]
        min_reach = np.minimum(min_reach[keep], reach[current][labels])
        j = np.argmin(min_reach)
        mst[i] = (current, labels[j], min_reach[j])
        current = int(labels[j])
    return mst


def single_linkage(mst: np.ndarray) -> np.ndarray:
    """The dendrogram of the edges sorted by distance, in scipy's linkage
    layout: cluster ``n + i`` is the merge of row ``i``."""
    mst = mst[np.argsort(mst["distance"])]
    n = mst.shape[0] + 1
    parent = np.full(2 * n - 1, -1, dtype=np.intp)
    size = np.concatenate([np.ones(n, np.intp), np.zeros(n - 1, np.intp)])
    out = np.zeros(n - 1, dtype=HIERARCHY_DTYPE)

    def find(x: int) -> int:
        root = x
        while parent[root] != -1:
            root = parent[root]
        while x != root and parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, (a, b, dist) in enumerate(mst.tolist()):
        ra, rb = find(a), find(b)
        out[i] = (ra, rb, dist, size[ra] + size[rb])
        parent[ra] = parent[rb] = n + i
        size[n + i] = size[ra] + size[rb]
    return out


def _bfs_hierarchy(hierarchy: np.ndarray, root: int) -> List[int]:
    n = hierarchy.shape[0] + 1
    queue, out = [root], []
    while queue:
        out.extend(queue)
        queue = [x - n for x in queue if x >= n]
        if queue:
            queue = [c for node in queue for c in
                     (int(hierarchy[node]["left_node"]),
                      int(hierarchy[node]["right_node"]))]
    return out


def condense_tree(hierarchy: np.ndarray, min_cluster_size: int) -> np.ndarray:
    """The tree pruned of clusters under ``min_cluster_size``: rows of
    (parent cluster, child, lambda = 1 / distance, child size)."""
    root = 2 * hierarchy.shape[0]
    n = hierarchy.shape[0] + 1
    next_label = n + 1
    nodes = _bfs_hierarchy(hierarchy, root)
    relabel = np.empty(root + 1, dtype=np.intp)
    relabel[root] = n
    ignore = np.zeros(len(nodes), dtype=bool)
    rows = []

    def count(node: int) -> int:
        return int(hierarchy[node - n]["cluster_size"]) if node >= n else 1

    def fall_out(parent: int, sub: int, lam: float) -> None:
        for s in _bfs_hierarchy(hierarchy, sub):
            if s < n:
                rows.append((parent, s, lam, 1))
            ignore[s] = True

    for node in nodes:
        if ignore[node] or node < n:
            continue
        left, right, dist, _ = hierarchy[node - n].tolist()
        lam = 1.0 / dist if dist > 0.0 else np.inf
        lc, rc = count(left), count(right)
        if lc >= min_cluster_size and rc >= min_cluster_size:
            relabel[left] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[left], lam, lc))
            relabel[right] = next_label
            next_label += 1
            rows.append((relabel[node], relabel[right], lam, rc))
        elif lc < min_cluster_size and rc < min_cluster_size:
            fall_out(relabel[node], left, lam)
            fall_out(relabel[node], right, lam)
        elif lc < min_cluster_size:
            relabel[right] = relabel[node]
            fall_out(relabel[node], left, lam)
        else:
            relabel[left] = relabel[node]
            fall_out(relabel[node], right, lam)
    return np.array(rows, dtype=CONDENSED_DTYPE)


def stabilities(condensed: np.ndarray) -> Dict[int, float]:
    """Each cluster's sum of (lambda - its birth lambda) x size over the
    rows it is the parent of, in row order."""
    parents = condensed["parent"]
    smallest = int(parents.min())
    largest_child = max(int(condensed["child"].max()), smallest)
    births = np.full(largest_child + 1, np.nan, dtype=np.float64)
    for _, child, value, _ in condensed.tolist():
        births[child] = value
    births[smallest] = 0.0
    result = np.zeros(int(parents.max()) - smallest + 1, dtype=np.float64)
    for parent, _, value, size in condensed.tolist():
        result[parent - smallest] += (value - births[parent]) * size
    return {i + smallest: float(v) for i, v in enumerate(result)}


def _bfs_clusters(cluster_tree: np.ndarray, root: int) -> List[int]:
    out, queue = [], np.array([root], dtype=np.intp)
    children, parents = cluster_tree["child"], cluster_tree["parent"]
    while len(queue) > 0:
        out.extend(queue.tolist())
        queue = children[np.isin(parents, queue)]
    return out


class _TreeUnionFind:
    """sklearn's ``TreeUnionFind``: union by rank, path compression."""

    def __init__(self, size: int) -> None:
        self.parent = list(range(size))
        self.rank = [0] * size

    def union(self, x: int, y: int) -> None:
        xr, yr = self.find(x), self.find(y)
        if self.rank[xr] < self.rank[yr]:
            self.parent[xr] = yr
        elif self.rank[xr] > self.rank[yr]:
            self.parent[yr] = xr
        else:
            self.parent[yr] = xr
            self.rank[xr] += 1

    def find(self, x: int) -> int:
        path = []
        while self.parent[x] != x:
            path.append(x)
            x = self.parent[x]
        for p in path:
            self.parent[p] = x
        return x


def select_clusters(condensed: np.ndarray,
                    stability: Dict[int, float]) -> np.ndarray:
    """Excess-of-mass selection (the root never selected) and the labels:
    clusters numbered in order of their ids, noise -1."""
    stability = dict(stability)
    nodes = sorted(stability, reverse=True)[:-1]
    cluster_tree = condensed[condensed["cluster_size"] > 1]
    is_cluster = {c: True for c in nodes}
    for node in nodes:
        kids = cluster_tree["child"][cluster_tree["parent"] == node]
        subtree = np.sum([stability[int(c)] for c in kids])
        if subtree > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree
        else:
            for sub in _bfs_clusters(cluster_tree, node):
                if sub != node:
                    is_cluster[sub] = False
    clusters = {c for c, keep in is_cluster.items() if keep}
    label_of = {c: i for i, c in enumerate(sorted(clusters))}

    root = int(condensed["parent"].min())
    uf = _TreeUnionFind(int(condensed["parent"].max()) + 1)
    for parent, child, _, _ in condensed.tolist():
        if child not in clusters:
            uf.union(parent, child)
    labels = np.empty(root, dtype=np.intp)
    for point in range(root):
        cluster = uf.find(point)
        labels[point] = -1 if cluster == root else label_of[cluster]
    return labels


def hdbscan(distances: np.ndarray, min_cluster_size: int = 3,
            min_samples: Optional[int] = None) -> np.ndarray:
    """Cluster labels of the points of a symmetric dense distance matrix
    (``HDBSCAN(min_cluster_size, min_samples, metric="precomputed")``;
    ``min_samples`` defaults to ``min_cluster_size``)."""
    distances = np.asarray(distances, dtype=np.float64)
    n = distances.shape[0]
    if distances.ndim != 2 or distances.shape[1] != n:
        raise ValueError(f"expected a square distance matrix, got shape "
                         f"{distances.shape}")
    if n == 1:
        raise ValueError("n_samples=1 while HDBSCAN requires more than one "
                         "sample")
    min_samples = min_cluster_size if min_samples is None else min_samples
    if min_samples > n:
        raise ValueError(f"min_samples ({min_samples}) must be at most the "
                         f"number of samples in X ({n})")
    tree = single_linkage(minimum_spanning_tree(
        mutual_reachability(distances, min_samples)))
    condensed = condense_tree(tree, min_cluster_size)
    return select_clusters(condensed, stabilities(condensed))
