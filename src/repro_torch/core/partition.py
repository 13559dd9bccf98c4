r"""Attribute partitioning for divide-and-conquer planning (DESIGN.md §12).

The port's copy of ``repro.core.partition`` (host numpy, unchanged): the
same blocks and the same index arrays for the same workload.  Plus
:func:`group_rows`, the port's one grouping of equal integer rows (the
straddlers by their parts' shapes, the mixture marginals' cliques by their
sizes).

The monolithic PlanTable IR tops out where the downward closure stops fitting
in memory (d=100 all-≤3-way is 166k cliques / 1.3M incidence entries; d=500
would be 20M+).  Following "Accurate and Scalable Matrix Mechanisms via
Divide and Conquer" (PAPERS.md, arXiv 2604.00868), this module splits the
attribute set into *blocks* so each block's sub-workload closes over a small
clique set and can be planned independently:

* :func:`partition_attributes` — blocks from the workload's
  clique-interaction graph.  Connected components are used *exactly* (no
  workload clique straddles a component cut, so D&C is lossless there); when
  the graph is connected — or the user passes ``blocks=`` / ``max_block=`` —
  oversized components are split by a greedy min-cut heuristic (weighted
  greedy graph-growing: repeatedly attach the attribute with the heaviest
  edge weight into an open block, ties toward the emptiest block).

* :func:`decompose` — the workload restricted to each block.  A clique fully
  inside a block keeps its importance; a clique that straddles a cut is
  *projected*: each nonempty intersection with a block joins that block's
  sub-workload (importance accumulated), and the full marginal is later
  re-assembled by the **product-of-blocks correction** — the straddling
  marginal is estimated as the normalized outer product of its per-block
  projections (an independence approximation across the cut; DESIGN.md §12
  documents the variance proxy).  All bookkeeping (which row lives where,
  which flat parts belong to which straddler) is emitted as index arrays so
  the composite plan's variance assembly is pure segment-sums — the
  straddler scan itself is vectorized per size class, never a per-clique
  Python loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .domain import Clique, Domain, MarginalWorkload
from .plantable import _group_by_len

BlocksSpec = Union[None, int, Sequence[Sequence[int]]]

#: default block-size cap when a forced split must pick one (≈ the largest
#: all-≤3-way closure that is still cheap to build).
DEFAULT_MAX_BLOCK = 32

# row_block markers for workload rows that are not plain in-block cliques
ROW_STRADDLER = -1
ROW_EMPTY = -2


@dataclass(frozen=True)
class Partition:
    """Disjoint attribute blocks covering every attribute the workload uses."""

    domain: Domain
    blocks: Tuple[Clique, ...]        # sorted attr tuples, disjoint
    cut_weight: float                 # Σ Imp_A over straddling cliques

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def block_of_array(self) -> np.ndarray:
        """(n_attrs,) block id per attribute (-1: unused by the workload)."""
        out = np.full(self.domain.n_attrs, -1, np.int64)
        for b, attrs in enumerate(self.blocks):
            out[list(attrs)] = b
        return out


def interaction_weights(workload: MarginalWorkload
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(active-attribute mask, dense symmetric co-occurrence weight matrix).

    Edge (i, j) accumulates Imp_A over every workload clique containing both
    attributes — vectorized per size class (one ``np.add.at`` per column
    pair), so a d=500 all-≤2-way workload scans with no per-clique loop.
    """
    d = workload.domain.n_attrs
    adj = np.zeros((d, d))
    active = np.zeros(d, bool)
    w = workload.weight_array()
    for k, (ridx, mat) in _group_by_len(workload.cliques).items():
        if k == 0:
            continue
        active[np.unique(mat)] = True
        wk = w[ridx]
        for j1 in range(k):
            for j2 in range(j1 + 1, k):
                np.add.at(adj, (mat[:, j1], mat[:, j2]), wk)
    adj += adj.T
    return active, adj


def _connected_components(active: np.ndarray, adj: np.ndarray) -> List[List[int]]:
    """Union-find over the nonzero edges among active attributes."""
    parent = np.arange(len(active))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ei, ej = np.nonzero(np.triu(adj, 1))
    for a, b in zip(ei.tolist(), ej.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    comps: Dict[int, List[int]] = {}
    for a in np.nonzero(active)[0].tolist():
        comps.setdefault(find(a), []).append(a)
    return sorted(comps.values(), key=lambda c: c[0])


def _greedy_split(comp: List[int], adj: np.ndarray, g: int) -> List[List[int]]:
    """Split one component into ``g`` balanced blocks, greedily minimizing cut.

    Weighted greedy graph-growing: seed each block with the heaviest-degree
    unassigned attribute, then repeatedly place the attribute with the
    largest total edge weight into any non-full block (ties toward the
    emptiest block).  O(|comp|² · g) — fine for the ≤ thousands of
    attributes this planner targets.
    """
    comp = sorted(comp)
    nc = len(comp)
    g = max(1, min(g, nc))
    if g == 1:
        return [comp]
    cap = math.ceil(nc / g)
    sub = adj[np.ix_(comp, comp)]
    degree = sub.sum(axis=1)
    unassigned = set(range(nc))
    blocks: List[List[int]] = [[] for _ in range(g)]
    # attach[i, b] = total edge weight from local attr i into block b
    attach = np.zeros((nc, g))
    for b in range(g):
        if not unassigned:
            break
        seed = max(unassigned, key=lambda i: (degree[i], -i))
        blocks[b].append(seed)
        unassigned.discard(seed)
        attach[:, b] += sub[:, seed]
    while unassigned:
        open_b = [b for b in range(g) if len(blocks[b]) < cap]
        fill = np.array([len(blocks[b]) for b in open_b], dtype=float)
        cand = np.fromiter(unassigned, np.int64, count=len(unassigned))
        gain = attach[np.ix_(cand, open_b)] - 1e-12 * fill
        ci, bi = np.unravel_index(int(np.argmax(gain)), gain.shape)
        i, b = int(cand[ci]), open_b[int(bi)]
        blocks[b].append(i)
        unassigned.discard(i)
        attach[:, b] += sub[:, i]
    return [sorted(comp[i] for i in blk) for blk in blocks if blk]


def partition_attributes(workload: MarginalWorkload, blocks: BlocksSpec = None,
                         max_block: Optional[int] = None) -> Partition:
    """Blocks from the clique-interaction graph (DESIGN.md §12).

    * default: the connected components, exactly — no clique straddles a cut;
    * ``max_block=s``: components larger than ``s`` are split by the greedy
      min-cut heuristic into ``ceil(size/s)`` blocks;
    * ``blocks=g`` (int): components are split (largest first) until at least
      ``g`` blocks exist; components are never merged;
    * ``blocks=[[...], ...]`` (explicit): user-supplied attribute groups —
      validated disjoint and covering every workload attribute.
    """
    dom = workload.domain
    active, adj = interaction_weights(workload)
    for c in workload.cliques:          # 1-cliques have no edges; still active
        for a in c:
            active[a] = True

    if blocks is not None and not isinstance(blocks, int):
        seen: set = set()
        out = []
        for grp in blocks:
            grp = tuple(sorted(int(a) for a in grp))
            if not grp:
                raise ValueError("empty block in explicit blocks=")
            if seen & set(grp):
                raise ValueError(f"explicit blocks overlap on "
                                 f"{sorted(seen & set(grp))}")
            seen.update(grp)
            out.append(grp)
        missing = set(np.nonzero(active)[0].tolist()) - seen
        if missing:
            raise ValueError(f"explicit blocks= do not cover workload "
                             f"attributes {sorted(missing)}")
        return Partition(dom, tuple(out), _cut_weight(workload, out))

    comps = _connected_components(active, adj)
    if max_block is not None:
        if max_block < 1:
            raise ValueError("max_block must be >= 1")
        split = []
        for comp in comps:
            split.extend(_greedy_split(comp, adj,
                                       math.ceil(len(comp) / max_block)))
        comps = split
    if isinstance(blocks, int):
        target = max(1, blocks)
        comps = [list(c) for c in comps]
        while len(comps) < target:
            big = max(range(len(comps)), key=lambda i: len(comps[i]))
            if len(comps[big]) < 2:
                break
            halves = _greedy_split(comps[big], adj, 2)
            comps[big:big + 1] = [list(h) for h in halves]
        comps.sort(key=lambda c: c[0])
    out = tuple(tuple(sorted(c)) for c in comps)
    return Partition(dom, out, _cut_weight(workload, out))


def _cut_weight(workload: MarginalWorkload, blocks: Sequence[Clique]) -> float:
    block_of = {}
    for b, grp in enumerate(blocks):
        for a in grp:
            block_of[a] = b
    return float(sum(workload.weight(c) for c in workload.cliques
                     if len({block_of[a] for a in c}) > 1))


# ---------------------------------------------------------------------------
# Workload decomposition
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class Decomposition:
    """The workload split across a partition, with flat re-assembly indices.

    ``row_block[r]`` places original workload row ``r``: a block id for a
    clique fully inside one block, ``ROW_STRADDLER`` for a clique crossing a
    cut, ``ROW_EMPTY`` for the empty clique.  In-block rows carry ``row_pos``
    (their position in the owning block's sub-workload).  Straddlers explode
    into *parts* — flat arrays ``part_row / part_block / part_pos /
    part_cells`` with one entry per nonempty block-intersection, grouped by
    row — that drive the product-of-blocks variance proxy and
    reconstruction; part ``i``'s clique is
    ``block_workloads[part_block[i]].cliques[part_pos[i]]``.
    """

    workload: MarginalWorkload
    partition: Partition
    block_workloads: List[MarginalWorkload]
    row_block: np.ndarray
    row_pos: np.ndarray
    part_row: np.ndarray
    part_block: np.ndarray
    part_pos: np.ndarray
    part_cells: np.ndarray
    #: Σ importance over ∅ workload rows — no block sub-workload carries
    #: them, but the shared σ²_∅ serves them, so the SoV closed form adds
    #: this straight onto v_∅ (variance_coeff(∅, ∅) = 1).
    empty_weight: float = 0.0
    #: (m,) importance per original workload row (overrides folded in) —
    #: the weight convention of the composite's loss reporting.
    row_weight: Optional[np.ndarray] = None

    @property
    def n_straddlers(self) -> int:
        return int((self.row_block == ROW_STRADDLER).sum())

    def part_clique(self, i: int) -> Clique:
        return self.block_workloads[int(self.part_block[i])] \
            .cliques[int(self.part_pos[i])]

    def parts_of(self, row: int) -> List[Tuple[int, Clique]]:
        """(block, part clique) pairs of one straddling workload row."""
        sel = np.nonzero(self.part_row == row)[0]
        return [(int(self.part_block[i]), self.part_clique(i)) for i in sel]


def decompose(workload: MarginalWorkload, partition: Partition,
              weights=None) -> Decomposition:
    """Split ``workload`` across ``partition`` (vectorized per size class).

    ``weights`` optionally overrides per-clique importances (same mapping
    convention the selectors take).  Block sub-workload cliques are deduped
    per (block, width) with importances accumulated — a straddler's weight
    lands on each of its projections, merging with any in-block clique it
    coincides with.
    """
    dom = workload.domain
    wk = workload.cliques
    m = len(wk)
    if weights is None:
        w_row = workload.weight_array()
    else:
        w_row = np.array([float(weights.get(c, workload.weight(c)))
                          for c in wk])
    block_of = partition.block_of_array()
    nb = partition.n_blocks
    base = max(dom.n_attrs, 2)

    row_block = np.empty(m, np.int64)
    row_pos = np.full(m, -1, np.int64)
    # per block, per width: list of candidate chunks
    #   ("row",  global row-idx array,  (g, width) attr matrix, weights)
    #   ("part", global part-idx array, (g, width) attr matrix, weights)
    cand: List[Dict[int, list]] = [dict() for _ in range(nb)]
    part_row_l: List[np.ndarray] = []
    part_block_l: List[np.ndarray] = []
    n_parts = 0

    for k, (ridx, mat) in sorted(_group_by_len(wk).items()):
        if k == 0:
            # ∅ workload rows ride with block 0 (∅ is in every block's
            # closure; block 0 measures the shared total) so its importance
            # constrains σ²_∅ in the block-0 selection.  ROW_EMPTY survives
            # only for the degenerate no-blocks workload.
            if nb:
                row_block[ridx] = 0
                cand[0].setdefault(0, []).append(
                    ("row", ridx, mat, w_row[ridx]))
            else:
                row_block[ridx] = ROW_EMPTY
            continue
        blk = block_of[mat]
        inb = (blk == blk[:, :1]).all(axis=1)
        row_block[ridx] = np.where(inb, blk[:, 0], ROW_STRADDLER)
        if inb.any():
            for b in np.unique(blk[inb, 0]):
                sel = inb & (blk[:, 0] == b)
                cand[int(b)].setdefault(k, []).append(
                    ("row", ridx[sel], mat[sel], w_row[ridx[sel]]))
        if inb.all():
            continue
        # straddlers: sort each row's attrs by block id, find part boundaries
        srows = ridx[~inb]
        sa = mat[~inb]
        sblk = blk[~inb]
        order = np.argsort(sblk, axis=1, kind="stable")
        sb = np.take_along_axis(sblk, order, 1)
        sa = np.take_along_axis(sa, order, 1)
        new_part = np.ones_like(sb, bool)
        new_part[:, 1:] = sb[:, 1:] != sb[:, :-1]
        firsts = np.nonzero(new_part.ravel())[0]      # flat start of each part
        widths = np.diff(np.append(firsts, sb.size))  # parts never cross rows
        prow = srows[firsts // k]
        pblock = sb.ravel()[firsts]
        pw = w_row[prow]
        sa_flat = sa.ravel()
        for w_ in np.unique(widths):
            wsel = widths == w_
            mats = sa_flat[firsts[wsel][:, None]
                           + np.arange(int(w_), dtype=np.int64)]
            gidx = n_parts + np.nonzero(wsel)[0]
            for b in np.unique(pblock[wsel]):
                bsel = pblock[wsel] == b
                cand[int(b)].setdefault(int(w_), []).append(
                    ("part", gidx[bsel], mats[bsel], pw[wsel][bsel]))
        part_row_l.append(prow)
        part_block_l.append(pblock)
        n_parts += len(prow)

    part_row = (np.concatenate(part_row_l) if part_row_l
                else np.zeros(0, np.int64))
    part_block = (np.concatenate(part_block_l) if part_block_l
                  else np.zeros(0, np.int64))
    part_pos = np.full(n_parts, -1, np.int64)
    part_cells = np.ones(n_parts)

    # per block: dedupe candidates per width, accumulate weights, and build
    # the sub-workload over the FULL domain (global attribute ids) so
    # PlanTable and the fused engines apply unchanged
    block_workloads: List[MarginalWorkload] = []
    shape = np.asarray(dom.sizes, np.float64)
    for b in range(nb):
        cliques_b: List[Clique] = []
        weights_b: Dict[Clique, float] = {}
        cells_b: List[float] = []
        for width in sorted(cand[b]):
            chunks = cand[b][width]
            allk = []
            for _, _, mat_, _ in chunks:
                key = np.zeros(len(mat_), np.int64)
                for off in range(width):
                    key = key * base + mat_[:, off]
                allk.append(key)
            allk = np.concatenate(allk)
            uk, first, inv = np.unique(allk, return_index=True,
                                       return_inverse=True)
            umat = np.concatenate([c[2] for c in chunks], axis=0)[first]
            uw = np.zeros(len(uk))
            np.add.at(uw, inv, np.concatenate([c[3] for c in chunks]))
            pos0 = len(cliques_b)
            new_cl = [tuple(r) for r in umat.tolist()]
            cliques_b.extend(new_cl)
            for c, wt in zip(new_cl, uw.tolist()):
                weights_b[c] = wt
            cells_b.extend(np.prod(shape[umat], axis=1).tolist())
            at = 0
            for kind, idx, mat_, _ in chunks:
                g = len(mat_)
                upos = pos0 + inv[at:at + g]
                if kind == "row":
                    row_pos[idx] = upos
                else:
                    part_pos[idx] = upos
                at += g
        if part_block.size:
            bsel = part_block == b
            if bsel.any():
                part_cells[bsel] = np.asarray(cells_b)[part_pos[bsel]]
        block_workloads.append(
            MarginalWorkload(dom, tuple(cliques_b), weights_b))

    return Decomposition(workload, partition, block_workloads, row_block,
                         row_pos, part_row, part_block, part_pos, part_cells,
                         float(w_row[row_block == ROW_EMPTY].sum()), w_row)


def group_rows(sig: np.ndarray) -> List[np.ndarray]:
    """The groups of equal rows of an integer matrix: index arrays, each
    ascending, the groups in the lexicographic order of their rows.  The
    columns are packed into as few int64 words as hold them before the one
    stable sort (a sort over many narrow columns is slow)."""
    sig = np.asarray(sig, np.int64)
    if not len(sig):
        return []
    sig = sig - sig.min(axis=0)
    words, word, span = [], np.zeros(len(sig), np.int64), 1
    for j, rj in enumerate((sig.max(axis=0) + 1).tolist()):
        if span * rj >= 1 << 62:
            words.append(word)
            word, span = np.zeros(len(sig), np.int64), 1
        word = word * rj + sig[:, j]
        span *= rj
    packed = np.stack(words + [word], axis=1)
    order = np.lexsort(packed.T[::-1])
    cuts = np.flatnonzero(np.any(np.diff(packed[order], axis=0), axis=1)) + 1
    return np.split(order, cuts)
