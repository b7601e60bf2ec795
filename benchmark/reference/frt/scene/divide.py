"""Host-side simulation of the reference's BVH build (`group_divide`) to
recover the post-divide DFS leaf ordering.

Why this exists: the reference's shadow rays use an early-exit group walk
(`intersect_world(w, r, /*stop_after_first_hit*/true)`): children are
visited in array order and the walk stops at the first child subtree that
yields any t > 0 intersection (src/shapes/group.c:108-123); `hit(xs, true)`
then only sees that one leaf's positive hits (src/renderer/renderer.c:73-93).
A non-blocking hit found first (e.g. a ceiling plane beyond the light)
therefore MASKS a real blocker later in the array — shadows depend on the
child ordering produced by `group_divide` (src/shapes/group.c:299-370).
To match the reference's images we replicate that ordering exactly, NaN
semantics included: splitting a box with infinite extent yields NaN mid
planes (bounding_box.c:177-214 via `-inf + inf`), NaN containment tests are
false, so groups bounded by infinite planes never reorder.

All arithmetic here is scalar Python float (IEEE double, same as C).
`compile_scene` takes the C++ copy of this walk (`native/`) where it
builds, held to this one bit for bit, and this one elsewhere.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from benchmark.reference.frt import native

EPSILON = 1e-5
INF = float("inf")


def _equal(a: float, b: float) -> bool:
    """linalg.h:8 `equal` macro. NaN-involving compares are false in C too."""
    d = a - b
    if d != d:               # NaN
        return False
    return abs(d) < EPSILON


class Box:
    """Bounding_box (bounding_box.c): min starts +inf, max starts -inf."""

    __slots__ = ("min", "max")

    def __init__(self):
        self.min = [INF, INF, INF]
        self.max = [-INF, -INF, -INF]

    def add_array(self, p):
        """bounding_box_add_array: `if (p < min)` — false for NaN, so NaN
        coordinates never enter the box."""
        for i in range(3):
            if p[i] < self.min[i]:
                self.min[i] = p[i]
            if p[i] > self.max[i]:
                self.max[i] = p[i]

    def add_box(self, other: "Box"):
        self.add_array(other.min)
        self.add_array(other.max)

    def contains_array(self, p) -> bool:
        return (self.min[0] <= p[0] <= self.max[0]
                and self.min[1] <= p[1] <= self.max[1]
                and self.min[2] <= p[2] <= self.max[2])

    def contains_box(self, other: "Box") -> bool:
        return self.contains_array(other.min) and self.contains_array(other.max)

    def transform(self, m) -> "Box":
        """bounding_box_transform: re-fit the 8 transformed corners.
        m: flat row-major 16 floats. IEEE: 0 * inf = NaN, matching C."""
        res = Box()
        corners = (
            (self.min[0], self.min[1], self.min[2]),
            (self.min[0], self.min[1], self.max[2]),
            (self.min[0], self.max[1], self.min[2]),
            (self.min[0], self.max[1], self.max[2]),
            (self.max[0], self.min[1], self.min[2]),
            (self.max[0], self.min[1], self.max[2]),
            (self.max[0], self.max[1], self.min[2]),
            (self.max[0], self.max[1], self.max[2]),
        )
        for (x, y, z) in corners:
            # matrix_array_multiply: left-to-right sum (linalg.c:260-270)
            p = [m[r * 4 + 0] * x + m[r * 4 + 1] * y
                 + m[r * 4 + 2] * z + m[r * 4 + 3] for r in range(3)]
            res.add_array(p)
        return res

    def split(self) -> Tuple["Box", "Box"]:
        """bounding_box_split_bounds: halve the longest axis. fmax ignores
        NaN; `equal(inf, inf)` is false (inf - inf = NaN), reproducing the
        reference's axis selection on infinite boxes."""
        dx = abs(self.max[0] - self.min[0])
        dy = abs(self.max[1] - self.min[1])
        dz = abs(self.max[2] - self.min[2])
        greatest = _fmax(_fmax(dx, dy), dz)
        x0, y0, z0 = self.min
        x1, y1, z1 = self.max
        if _equal(greatest, dx):
            x0 = x1 = x0 + dx / 2.0
        elif _equal(greatest, dy):
            y0 = y1 = y0 + dy / 2.0
        else:
            z0 = z1 = z0 + dz / 2.0
        left = Box()
        left.min = list(self.min)
        left.max = [x1, y1, z1]
        right = Box()
        right.min = [x0, y0, z0]
        right.max = list(self.max)
        return left, right


def _fmax(a, b):
    """C fmax: NaN-ignoring."""
    if a != a:
        return b
    if b != b:
        return a
    return a if a > b else b


@dataclass
class Node:
    """Mirror of `struct shape` for the divide walk. `transform` is the
    node's LOCAL transform (flat row-major 16).

    kind 'leafblock' is a vectorized stand-in for a run of identity-
    transform triangle leaves (large meshes): `block_boxes` (n, 6)
    min3|max3 object boxes, `block_ids` (n,) leaf ids. The native
    serializer expands it in C++; the Python fallback expands it with
    expand_leafblocks()."""
    kind: str                       # 'group' | 'csg' | 'leafblock' | leaf
    transform: List[float]
    children: List["Node"] = field(default_factory=list)   # group
    left: Optional["Node"] = None                          # csg
    right: Optional["Node"] = None
    leaf_id: int = -1               # document-order id for leaves
    tag: int = -1                   # csg-internal id (node nid / leaf row)
    obj_box: Optional[Box] = None   # object-space bbox for primitive leaves
    block_boxes: Optional[object] = None   # leafblock: (n, 6) float64
    block_ids: Optional[object] = None     # leafblock: (n,) int64
    block_tags: Optional[object] = None    # leafblock: per-leaf csg tags
    _bbox: Optional[Box] = None
    _bbox_inverse: Optional[Box] = None

    # ---- bounds (each shape type's bounds(), cached like bbox_valid) ----

    def bounds(self) -> Box:
        if self._bbox is None:
            if self.kind == "group":
                b = Box()
                for c in self.children:
                    b.add_box(c.parent_space_bounds())
            elif self.kind == "csg":
                b = Box()
                b.add_box(self.left.parent_space_bounds())
                b.add_box(self.right.parent_space_bounds())
            else:
                b = self.obj_box
            self._bbox = b
            self._bbox_inverse = b.transform(self.transform)
        return self._bbox

    def parent_space_bounds(self) -> Box:
        self.bounds()
        return self._bbox_inverse

    def invalidate(self):
        self._bbox = None
        self._bbox_inverse = None


IDENTITY = [1.0, 0.0, 0.0, 0.0,
            0.0, 1.0, 0.0, 0.0,
            0.0, 0.0, 1.0, 0.0,
            0.0, 0.0, 0.0, 1.0]


def leaf_box(kind: str, minimum=0.0, maximum=0.0, r1=0.0, r2=0.0,
             points=None) -> Box:
    """Object-space bounding boxes per shape type (src/shapes/*.c bounds)."""
    b = Box()
    if kind in ("sphere", "cube"):
        b.add_array((-1.0, -1.0, -1.0))
        b.add_array((1.0, 1.0, 1.0))
    elif kind == "plane":
        b.add_array((-INF, 0.0, -INF))
        b.add_array((INF, 0.0, INF))
    elif kind == "cylinder":
        b.add_array((-1.0, minimum, -1.0))
        b.add_array((1.0, maximum, 1.0))
    elif kind == "cone":
        limit = _fmax(abs(minimum), abs(maximum))
        b.add_array((-limit, minimum, -limit))
        b.add_array((limit, maximum, limit))
    elif kind == "toroid":
        b.add_array((-r1 - r2, -r2, -r1 - r2))
        b.add_array((r1 + r2, r2, r1 + r2))
    elif kind in ("triangle", "smooth_triangle"):
        for p in points:
            b.add_array((float(p[0]), float(p[1]), float(p[2])))
    else:
        raise ValueError(f"no bounds for {kind}")
    return b


def expand_leafblocks(node: Node):
    """Replace every leafblock child with its individual triangle leaves
    (Python-fallback path; the native serializer expands in C++)."""
    if node.kind == "csg":
        expand_leafblocks(node.left)
        expand_leafblocks(node.right)
        return
    if node.kind != "group":
        return
    new_children: List[Node] = []
    for c in node.children:
        if c.kind == "leafblock":
            for i in range(len(c.block_ids)):
                b = Box()
                b.min = [float(x) for x in c.block_boxes[i, :3]]
                b.max = [float(x) for x in c.block_boxes[i, 3:]]
                new_children.append(Node(
                    kind="triangle", transform=list(IDENTITY),
                    leaf_id=int(c.block_ids[i]),
                    tag=(c.block_tags[i] if c.block_tags is not None
                         else -1),
                    obj_box=b))
        else:
            expand_leafblocks(c)
            new_children.append(c)
    node.children = new_children


def _partition_children(g: Node):
    """partition_children (group.c:183-297): classify children into
    left/middle/right by containment in the split halves, then reorder the
    array in place with the reference's exact swap passes (which are NOT
    stable for non-left / non-middle elements)."""
    box = g.bounds()
    left_box, right_box = box.split()

    ch = g.children
    n = len(ch)
    left_map = [False] * n
    right_map = [False] * n
    left_count = middle_count = right_count = 0
    for i, c in enumerate(ch):
        cb = c.parent_space_bounds()
        if left_box.contains_box(cb):
            left_map[i] = True
            left_count += 1
        elif right_box.contains_box(cb):
            right_map[i] = True
            right_count += 1
        else:
            middle_count += 1

    left_start = middle_start = right_start = -1

    # pass 1: lefts to the front
    i = j = 0
    while i < n and j < n:
        if left_map[i]:
            if left_start < 0:
                left_start = i
            i += 1
            j += 1
        else:
            while j < n and not left_map[j]:
                j += 1
            if j < n:
                ch[i], ch[j] = ch[j], ch[i]
                left_map[i], left_map[j] = left_map[j], left_map[i]
                right_map[i], right_map[j] = right_map[j], right_map[i]

    # pass 2: middles next, rights last
    j = i
    while i < n and j < n:
        if not right_map[i]:
            if middle_start < 0:
                middle_start = i
            i += 1
            j += 1
        else:
            while j < n and right_map[j]:
                j += 1
            if j < n:
                ch[i], ch[j] = ch[j], ch[i]
                left_map[i], left_map[j] = left_map[j], left_map[i]
                right_map[i], right_map[j] = right_map[j], right_map[i]

    if i < n:
        right_start = i
    return (left_count, middle_count, right_count,
            left_start, middle_start, right_start)


def divide(node: Node, threshold: int):
    """group_divide (group.c:299-370): partition, wrap left/right runs in
    subgroups ([left_subgroup, right_subgroup, middles...] order), recurse
    into every child."""
    if node.kind == "csg":
        divide(node.left, threshold)
        divide(node.right, threshold)
        return
    if node.kind != "group":
        return

    if threshold < len(node.children):
        (left_count, middle_count, right_count,
         left_start, middle_start, right_start) = _partition_children(node)
        if middle_count != len(node.children):
            new_children: List[Node] = []
            if left_count > 0:
                sub = Node(kind="group", transform=list(IDENTITY),
                           children=node.children[left_start:
                                                  left_start + left_count])
                new_children.append(sub)
            if right_count > 0:
                sub = Node(kind="group", transform=list(IDENTITY),
                           children=node.children[right_start:
                                                  right_start + right_count])
                new_children.append(sub)
            if middle_count > 0:
                new_children.extend(
                    node.children[middle_start:middle_start + middle_count])
            node.children = new_children
            node.invalidate()

    for c in node.children:
        divide(c, threshold)


def collect_leaf_order(node: Node, out: List[int]):
    """DFS leaf ids in post-divide child-array order (= the order the
    early-exit shadow walk visits leaves). A CSG subtree is ONE leaf: the
    group walk stops when the csg's *filtered* hit list has a positive t
    (group.c:108-123 sees the csg as a single child)."""
    if node.kind == "group":
        for c in node.children:
            collect_leaf_order(c, out)
    else:
        out.append(node.leaf_id)


def shadow_ranks(root: Node, threshold: int, n_leaves: int):
    """Divide the tree, then return rank[leaf_id] = visit position, through
    the C++ walk (native/divide_core.cpp) where it built, else through
    `shadow_ranks_python`, the reference it is held to, bit for bit."""
    if native.available():
        return native.shadow_ranks(root, threshold, n_leaves)
    return shadow_ranks_python(root, threshold, n_leaves)


def shadow_ranks_python(root: Node, threshold: int, n_leaves: int):
    """The Python walk: divide the tree in place, then return
    rank[leaf_id] = visit position."""
    expand_leafblocks(root)
    divide(root, threshold)
    order: List[int] = []
    collect_leaf_order(root, order)
    assert sorted(order) == list(range(n_leaves)), \
        f"leaf ids inconsistent: {sorted(order)[:5]}... vs {n_leaves}"
    rank = [0] * n_leaves
    for pos, lid in enumerate(order):
        rank[lid] = pos
    return rank
