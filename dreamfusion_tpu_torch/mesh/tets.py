"""Tetrahedral grid and its static marching-tets topology
(``dreamfusion_tpu/mesh/tets.py``; numpy only).

Each cube of an n³ lattice is split into 6 tetrahedra around its main
diagonal, and the unique-edge topology is computed once on the host:

  * ``unique_edges [E, 2]`` — sorted vertex-id pairs
  * ``tet_edges [F, 6]``    — per-tet edge → unique-edge index

so a marching-tets step (``ops/marching_tets.py``) gathers and writes at
fixed slots.  ``load_cached_tet_grid`` keeps the topology in a file: at
``tet_grid_size`` 128 it takes seconds to build.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "tets"


@dataclass
class TetGrid:
    vertices: np.ndarray       # [V, 3] float32 in [-1, 1]
    indices: np.ndarray        # [F, 4] int32
    unique_edges: np.ndarray   # [E, 2] int32 (sorted pairs)
    tet_edges: np.ndarray      # [F, 6] int32 → unique edge ids
    resolution: int

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_tets(self) -> int:
        return len(self.indices)

    @property
    def num_edges(self) -> int:
        return len(self.unique_edges)


# the 6 tets of a cube around the main diagonal (0,0,0)-(1,1,1)
_CUBE_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 7, 5],
    [0, 5, 7, 4],
    [0, 4, 7, 6],
    [0, 6, 7, 2],
    [0, 2, 7, 3],
], dtype=np.int64)

# the tet's edges in the order of the marching-tets table:
# (0,1) (0,2) (0,3) (1,2) (1,3) (2,3)
TET_EDGE_PAIRS = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                          dtype=np.int64)


def generate_tet_grid(n: int) -> TetGrid:
    """n³ cubes → 6n³ tets over [-1, 1]³; n = tet_grid_size // 2 gives the
    tet density of the DMTet reference's quartet grids of that size."""
    g = n + 1
    ax = np.arange(g, dtype=np.float32)
    xx, yy, zz = np.meshgrid(ax, ax, ax, indexing="ij")
    verts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3) / n * 2.0 - 1.0

    def vid(i, j, k):
        return (i * g + j) * g + k

    ci, cj, ck = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                             indexing="ij")
    ci, cj, ck = ci.ravel(), cj.ravel(), ck.ravel()
    # cube corner ids, bit order (x, y, z): corner c = (cx, cy, cz)
    corners = np.stack([
        vid(ci + ((c >> 2) & 1), cj + ((c >> 1) & 1), ck + (c & 1))
        for c in range(8)
    ], axis=-1)                                              # [n^3, 8]
    tets = corners[:, _CUBE_TETS].reshape(-1, 4).astype(np.int64)
    return build_topology(verts.astype(np.float32), tets, n)


def build_topology(vertices: np.ndarray, tets: np.ndarray,
                   resolution: int) -> TetGrid:
    """Unique-edge topology of any tet mesh."""
    edges = tets[:, TET_EDGE_PAIRS]                          # [F, 6, 2]
    edges = np.sort(edges, axis=-1).reshape(-1, 2)           # [F*6, 2]
    keys = edges[:, 0].astype(np.int64) * len(vertices) + edges[:, 1]
    uniq_keys, inverse = np.unique(keys, return_inverse=True)
    unique_edges = np.stack([uniq_keys // len(vertices),
                             uniq_keys % len(vertices)], axis=-1)
    return TetGrid(
        vertices=vertices.astype(np.float32),
        indices=tets.astype(np.int32),
        unique_edges=unique_edges.astype(np.int32),
        tet_edges=inverse.reshape(-1, 6).astype(np.int32),
        resolution=resolution,
    )


def load_cached_tet_grid(cache_path, n: int) -> TetGrid:
    """``generate_tet_grid(n)`` through a file cache."""
    cache_path = str(cache_path)
    if os.path.exists(cache_path):
        d = np.load(cache_path)
        return TetGrid(vertices=d["vertices"], indices=d["indices"],
                       unique_edges=d["unique_edges"],
                       tet_edges=d["tet_edges"],
                       resolution=int(d["resolution"]))
    grid = generate_tet_grid(n)
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    tmp = f"{cache_path}.tmp{os.getpid()}.npz"
    np.savez(tmp, vertices=grid.vertices, indices=grid.indices,
             unique_edges=grid.unique_edges, tet_edges=grid.tet_edges,
             resolution=grid.resolution)
    os.replace(tmp, cache_path)
    return grid
