"""A frozen copy of the repository's ``graph_builder`` data module, for the
benchmark's reference; it imports nothing of the program.

Heuristic spatial-relation graph builder for document pages.

Re-implements the relation semantics of the reference builder (reference:
gnn/data_generator/data_process/utils/graph_utils.py:425-834): six edge
types — left-right, right-left, top-bottom, bottom-top, child, parent —
derived from textline/cell bounding boxes, with the same occlusion
filtering, left-neighbor column cleaning and top-neighbor row cleaning.

Design differences from the reference (same outputs):
  * boxes live in flat numpy arrays and all pairwise interval overlaps are
    precomputed once — the reference recomputes interval intersections in
    O(N^3) Python object calls;
  * edges accumulate in an index-based set; the dense ``N x 6 x N``
    adjacency (or a COO edge list for the sparse path) is emitted at
    the end;
  * the builder returns edge lists *and* the dense tensor so the data
    pipeline can feed either the dense path or the sparse path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

EDGE_LABELS = ("lr", "rl", "tb", "bt", "child", "parent")
LR, RL, TB, BT, CHILD, PARENT = range(6)


@dataclass
class Box:
    """One graph node: a textline or table cell with geometry + metadata."""

    x: float
    y: float
    w: float
    h: float
    text: str = ""
    label: Optional[str] = None
    cell_type: Optional[str] = None
    is_textline: bool = True
    parent: Optional[int] = None  # parent cell index (textline -> cell)
    index: int = -1
    # Directional neighbor index lists, filled during edge building.
    lefts: List[int] = field(default_factory=list)
    rights: List[int] = field(default_factory=list)
    tops: List[int] = field(default_factory=list)
    bottoms: List[int] = field(default_factory=list)


def boxes_from_textlines(textlines: Sequence[Dict[str, Any]]) -> List[Box]:
    """Build Box nodes from cassia-style dicts with ``location``/``polygon``.

    Width/height get the reference's +1 (graph_utils.py:277-279).
    Items typed ``cell``/``table`` become table cells, everything else is a
    textline (graph_utils.py:284-290).
    """
    boxes: List[Box] = []
    for i, item in enumerate(textlines):
        poly = np.asarray(item.get("location") or item["polygon"], dtype=np.float64)
        x, y = poly[:, 0].min(), poly[:, 1].min()
        w = poly[:, 0].max() - x + 1.0
        h = poly[:, 1].max() - y + 1.0
        cell_type = item.get("type")
        boxes.append(
            Box(
                x=float(x), y=float(y), w=float(w), h=float(h),
                text=str(item.get("text", "")),
                label=item.get("label"),
                cell_type=cell_type,
                is_textline=cell_type not in ("cell", "table"),
                index=i,
            )
        )
    return boxes


def _interval_overlap(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Pairwise 1-D interval intersection lengths, clipped at 0."""
    lo = np.maximum(starts[:, None], starts[None, :])
    hi = np.minimum((starts + lengths)[:, None], (starts + lengths)[None, :])
    return np.maximum(hi - lo, 0.0)


class HeuristicGraph:
    """Build the 6-relation edge set over a page's boxes."""

    def __init__(self, items: Sequence[Dict[str, Any]], edge_type: str = "normal_binary"):
        self.boxes = boxes_from_textlines(items)
        # Node order: textlines first (input order), then cells, rows, cols
        # (reference: graph_utils.py:439-447). The reference's
        # textline->cell parenting never matches (cell names are
        # "cell_<i>", textline names "text_line<i>" — graph_utils.py:
        # 292-310), so textline parents stay None here too.
        self.textlines = [b for b in self.boxes if b.is_textline]
        self.cells = [b for b in self.boxes if not b.is_textline]
        self.rows = self._detect_groups(self.cells, axis="row")
        self.cols = self._detect_groups(self.cells, axis="col")
        self.order: List[Box] = self.textlines + self.cells
        self.num_entity_nodes = len(self.order)
        self.num_nodes = self.num_entity_nodes + len(self.rows) + len(self.cols)
        self.edges: Set[Tuple[int, int, int]] = set()  # (src, label, dst)

        self._ids = {id(b): k for k, b in enumerate(self.order)}
        xs = np.array([b.x for b in self.order])
        ys = np.array([b.y for b in self.order])
        ws = np.array([b.w for b in self.order])
        hs = np.array([b.h for b in self.order])
        self.xs, self.ys, self.ws, self.hs = xs, ys, ws, hs
        # y-interval overlaps gate left/right relations; x-interval overlaps
        # gate top/bottom relations (graph_utils.py:25-38).
        self.y_overlap = _interval_overlap(ys, hs)
        self.x_overlap = _interval_overlap(xs, ws)

        tl_idx = [self._ids[id(b)] for b in self.textlines]
        cell_idx = [self._ids[id(b)] for b in self.cells]
        for group in (tl_idx, cell_idx):
            self._build_left_right(group)
            self._build_top_bottom(group)
        self._build_child_parent()
        self._clean_left_right(tl_idx)
        self._clean_top_bottom(tl_idx)

        self.edge_type = edge_type
        self.adj = self._adjacency(edge_type)

    # ------------------------------------------------------------------
    # Left/right relation
    # ------------------------------------------------------------------
    def _is_left_of(self, i: int, j: int, refs: List[int]) -> bool:
        """Is node i directly left of j given candidate occluders ``refs``?

        Same rule set as CellNode.is_left_of (graph_utils.py:111-174).
        """
        if j in self.order[i].rights:
            return True
        xs, ws, hs = self.xs, self.ws, self.hs
        yov = self.y_overlap
        if xs[j] < xs[i] or yov[i, j] <= 0.0:
            return False
        if yov[i, j] > 0.9 * min(hs[i], hs[j]) and xs[j] - xs[i] < 0.1 * min(ws[i], ws[j]):
            return True
        if not refs:
            return True
        blockers = [
            c for c in refs
            if yov[i, c] > 0.0
            and xs[c] + ws[c] < xs[j] + ws[j] * 0.1
            and xs[c] >= xs[i] + ws[i] * 0.8
            and yov[i, c] > min(hs[i], hs[c]) / 5.0
            and (yov[c, j] > hs[j] / 2.0 or yov[i, c] > 0.8 * min(hs[c], hs[i]))
        ]
        return not blockers

    def _build_left_right(self, group: List[int]) -> None:
        """(reference: graph_utils.py:470-502)."""
        xs, hs = self.xs, self.hs
        by_y = sorted(group, key=lambda k: self.ys[k])
        for i in by_y:
            collide = [
                j for j in by_y
                if j != i and xs[j] >= xs[i]
                and self.y_overlap[i, j] > 0.4 * min(hs[i], hs[j])
            ]
            for j in collide:
                if self._is_left_of(i, j, collide) and j not in self.order[i].rights:
                    self.edges.add((i, LR, j))
                    self.edges.add((j, RL, i))
                    self.order[i].rights.append(j)
                    self.order[j].lefts.append(i)

    def _clean_left_right(self, tl_idx: List[int]) -> None:
        """Keep only the nearest column of left-neighbors per node
        (reference: graph_utils.py:504-563)."""
        xs, ws, hs = self.xs, self.ws, self.hs
        for i in tl_idx:
            node = self.order[i]
            if len(node.lefts) <= 1:
                continue
            left_sorted = sorted(node.lefts, key=lambda k: xs[k])
            overlapping = [
                c for c in left_sorted
                if xs[c] + ws[c] > xs[i] and xs[c] > xs[i] - 0.5 * hs[i]
            ]
            candidates = [c for c in left_sorted if c not in overlapping]
            # Cluster candidates into columns by x-projection overlap chains.
            columns: List[List[int]] = []
            current: List[int] = []
            for c in candidates:
                if current and self.x_overlap[current[-1], c] > 0.5 * min(
                    ws[current[-1]], ws[c]
                ):
                    current.append(c)
                else:
                    if current:
                        columns.append(current)
                    current = [c]
            if current:
                columns.append(current)
            keep = columns[-1] if columns else []
            removals = overlapping + [c for c in candidates if c not in keep]
            for c in removals:
                self.order[c].rights.remove(i)
                self.edges.discard((c, LR, i))
                self.edges.discard((i, RL, c))
            node.lefts = keep

    # ------------------------------------------------------------------
    # Top/bottom relation
    # ------------------------------------------------------------------
    def _nearest_above(self, i: int, group: List[int]) -> Optional[int]:
        """Nearest textline above node i (reference: graph_utils.py:350-397,
        dr='t'): best vertical gap among candidates that overlap in x and
        lie above; empty-text candidates are skipped."""
        xs, ys, ws, hs = self.xs, self.ys, self.ws, self.hs
        best, best_dist = None, 50000.0
        for j in group:
            if not self.order[j].text:
                continue
            if self.x_overlap[i, j] <= 0.0:
                # The reference's no-x-overlap branch can never yield a
                # finite 'above' distance (graph_utils.py:371-393), so
                # these candidates are unreachable; skip them.
                continue
            if ys[j] < ys[i]:
                dist = ys[i] - ys[j] - hs[j]
                if dist < best_dist:
                    best, best_dist = j, dist
        return best

    def _build_top_bottom(self, group: List[int]) -> None:
        """(reference: graph_utils.py:591-602)."""
        by_x = sorted(group, key=lambda k: self.xs[k])
        for i in by_x:
            top = self._nearest_above(i, by_x)
            if top is not None:
                self.edges.add((top, TB, i))
                self.edges.add((i, BT, top))
                self.order[i].tops.append(top)
                self.order[top].bottoms.append(i)

    def _clean_top_bottom(self, tl_idx: List[int]) -> None:
        """Keep only the nearest row of top-neighbors per node
        (reference: graph_utils.py:604-651)."""
        ys, ws = self.ys, self.ws
        for i in tl_idx:
            node = self.order[i]
            if len(node.tops) <= 1:
                continue
            top_sorted = sorted(node.tops, key=lambda k: ys[k])
            rows: List[List[int]] = []
            current: List[int] = []
            for c in top_sorted:
                if current and self.y_overlap[current[-1], c] > 0.5 * min(
                    ws[current[-1]], ws[c]
                ):
                    current.append(c)
                else:
                    if current:
                        rows.append(current)
                    current = [c]
            if current:
                rows.append(current)
            keep = rows[-1]
            for c in [c for c in top_sorted if c not in keep]:
                self.order[c].bottoms.remove(i)
                self.edges.discard((c, TB, i))
                self.edges.discard((i, BT, c))
            node.tops = keep

    # ------------------------------------------------------------------
    # Child/parent relation + row/column grouping
    # ------------------------------------------------------------------
    def _detect_groups(self, cells: List[Box], axis: str) -> List[List[Box]]:
        """Greedy row/column grouping of table cells
        (reference: graph_utils.py:685-741)."""
        groups: List[List[Box]] = []
        used: Set[int] = set()
        for a, cell in enumerate(cells):
            if a in used:
                continue
            aligned = [a]
            if axis == "col":
                pos_margin, size_margin = cell.w / 4.0, cell.w / 6.0
                pos = lambda b: b.x  # noqa: E731
                size = lambda b: b.w  # noqa: E731
            else:
                pos_margin, size_margin = cell.h / 2.0, cell.h / 4.0
                pos = lambda b: b.y  # noqa: E731
                size = lambda b: b.h  # noqa: E731
            for b, other in enumerate(cells):
                if b == a or b in used:
                    continue
                if (
                    abs(pos(other) - pos(cell)) <= pos_margin
                    and abs(size(other) - size(cell)) <= size_margin
                ):
                    aligned.append(b)
            used.update(aligned)
            if len(aligned) > 1:
                groups.append([cells[k] for k in aligned])
        return groups

    def _build_child_parent(self) -> None:
        """(reference: graph_utils.py:653-683). Rows/cols are appended as
        extra nodes after entity nodes, in detection order."""
        extra = self.num_entity_nodes
        for group in self.rows + self.cols:
            for member in group:
                m = self._ids[id(member)]
                self.edges.add((m, PARENT, extra))
                self.edges.add((extra, CHILD, m))
            extra += 1

    # ------------------------------------------------------------------
    # Adjacency emission
    # ------------------------------------------------------------------
    def edge_list(self) -> np.ndarray:
        """COO edges ``(E, 3)`` int32 rows of (src, relation, dst)."""
        if not self.edges:
            return np.zeros((0, 3), dtype=np.int32)
        return np.array(sorted(self.edges), dtype=np.int32)

    def _adjacency(self, edge_type: str) -> np.ndarray:
        """Dense ``N x 6 x N`` float16 adjacency
        (reference: graph_utils.py:743-834)."""
        n = self.num_nodes
        adj = np.zeros((n, len(EDGE_LABELS), n), dtype=np.float32)
        if edge_type == "normal_binary":
            for src, label, dst in self.edges:
                adj[src, label, dst] = 1.0
        elif edge_type in ("fc_similarity", "fc_binary"):
            coords = self._scaled_corners()
            for i in range(n):
                adj[i, :, i] = 1.0
            if edge_type == "fc_binary":
                adj[...] = 1.0
                # keep the reference's exact output: every entry 1.
            else:
                dist = _pairwise_rect_distance(coords)
                sim = (1.0 - dist / np.sqrt(2.0)) ** 2
                for l in range(len(EDGE_LABELS)):
                    adj[:, l, :] = sim
                for i in range(n):
                    adj[i, :, i] = 1.0
        else:
            raise ValueError(f"Invalid edge type: {edge_type}")
        return adj.astype(np.float16)

    def _scaled_corners(self) -> np.ndarray:
        """Per-node (x1, y1, x2, y2) scaled to the page bounding box
        (reference: graph_utils.py:744-749). Includes row/col pseudo-nodes."""
        geoms = [(b.x, b.y, b.w, b.h) for b in self.order]
        for group in self.rows + self.cols:
            gx = min(b.x for b in group)
            gy = min(b.y for b in group)
            # Reference Row/Column extents (graph_utils.py:407-422):
            # width/height of the first member, summed along the axis.
            if group in self.rows:
                geoms.append((gx, gy, sum(b.w for b in group), group[0].h))
            else:
                geoms.append((gx, gy, group[0].w, sum(b.h for b in group)))
        arr = np.array(geoms, dtype=np.float64)
        min_x = arr[:, 0].min()
        min_y = arr[:, 1].min()
        max_x = (arr[:, 0] + arr[:, 2]).max()
        max_y = (arr[:, 1] + arr[:, 3]).max()
        dx = abs(max_x - min_x)
        dy = abs(max_y - min_y)
        out = np.zeros((len(geoms), 4))
        out[:, 0] = (arr[:, 0] - min_x) / dx
        out[:, 1] = (arr[:, 1] - min_y) / dy
        out[:, 2] = (arr[:, 0] + arr[:, 2] - min_x) / dx
        out[:, 3] = (arr[:, 1] + arr[:, 3] - min_y) / dy
        return out


def _pairwise_rect_distance(rects: np.ndarray) -> np.ndarray:
    """Vectorized rectangle gap distance (reference: graph_utils.py:754-780)."""
    x1, y1, x1b, y1b = rects[:, 0], rects[:, 1], rects[:, 2], rects[:, 3]
    dx = np.maximum.reduce([x1[:, None] - x1b[None, :], x1[None, :] - x1b[:, None], np.zeros((len(rects), len(rects)))])
    dy = np.maximum.reduce([y1[:, None] - y1b[None, :], y1[None, :] - y1b[:, None], np.zeros((len(rects), len(rects)))])
    return np.sqrt(dx * dx + dy * dy)


def build_heuristic_adjacency(
    textlines: Sequence[Dict[str, Any]],
    edge_type: str = "normal_binary",
    num_edges: int = 6,
) -> np.ndarray:
    """One-call dense builder, trimmed to the input textline count
    (reference: gnn/data_generator/data_process/heuristic_graph_builder.py:56-83)."""
    graph = HeuristicGraph(textlines, edge_type)
    n = len(textlines)
    return np.asarray(graph.adj[:n, :num_edges, :n])
