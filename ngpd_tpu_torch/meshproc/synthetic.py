"""Synthetic CAD-style training meshes (numpy), a copy of
``ngpd_tpu/meshproc/synthetic.py`` that builds the port's ``TriMesh`` (on
the CPU; ``TriMesh.to`` moves it).

The reference trains its patch network on a large synthetic corpus of
CAD-like shapes (the GCN-Denoiser paper's Synthetic dataset); the repo
snapshot ships only a handful of mostly-organic scan meshes, which is
exactly the CAD-generalization gap docs/GOLDEN.md and docs/TRAINING.md
measure on fandisk/trim-star. These generators produce watertight
triangle meshes with the feature statistics those shapes need — planar
regions meeting at sharp convex AND concave creases, cylindrical
blends, circular crease loops — procedurally, so the training mix can
be widened without any external data.

All functions return a ``TriMesh`` with float32 vertices welded across
shared edges (manifold, so face-face adjacency and the patch extractor
work unchanged). ``cad_suite()`` is the curated training set.
"""

from __future__ import annotations

import numpy as np

from .trimesh import TriMesh

__all__ = [
    "box",
    "cylinder",
    "wedge",
    "stairs",
    "lbracket",
    "icosphere",
    "torus",
    "revolve",
    "fillet_box",
    "chamfer_box",
    "cone",
    "spherecone",
    "cross",
    "cad_suite",
]


def _weld(verts: np.ndarray, faces: np.ndarray, decimals: int = 5) -> TriMesh:
    """Merge duplicate vertices (grid seams) and drop degenerate faces."""
    key = np.round(verts, decimals)
    _, first, inv = np.unique(
        key, axis=0, return_index=True, return_inverse=True
    )
    f = inv[faces]
    ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 2] != f[:, 0])
    return TriMesh.from_numpy(
        verts[first].astype(np.float32), f[ok].astype(np.int32)
    )


def _grid_patch(origin, du, dv, nu: int, nv: int, flip: bool = False):
    """Triangulated nu x nv quad grid spanning origin + u*du + v*dv."""
    origin, du, dv = (np.asarray(a, np.float64) for a in (origin, du, dv))
    us = np.linspace(0.0, 1.0, nu + 1)
    vs = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    verts = origin + uu[..., None] * du + vv[..., None] * dv
    verts = verts.reshape(-1, 3)
    idx = np.arange((nu + 1) * (nv + 1)).reshape(nu + 1, nv + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    faces = np.concatenate(
        [np.stack([a, b, d], 1), np.stack([a, d, c], 1)], axis=0
    )
    if flip:
        faces = faces[:, ::-1]
    return verts, faces


def _assemble(patches) -> TriMesh:
    verts, faces, off = [], [], 0
    for v, f in patches:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return _weld(np.concatenate(verts), np.concatenate(faces))


def box(extents=(1.0, 0.7, 0.5), n: int = 8) -> TriMesh:
    """Grid-subdivided cuboid: six planes, twelve sharp 90-degree
    creases, eight corners."""
    ex, ey, ez = extents
    x, y, z = (np.array([ex, 0, 0]), np.array([0, ey, 0]),
               np.array([0, 0, ez]))
    o = -0.5 * (x + y + z)
    patches = [
        _grid_patch(o, y, x, n, n),                # bottom (z-)
        _grid_patch(o + z, x, y, n, n),            # top (z+)
        _grid_patch(o, x, z, n, n),                # front (y-)
        _grid_patch(o + y, z, x, n, n),            # back (y+)
        _grid_patch(o, z, y, n, n),                # left (x-)
        _grid_patch(o + x, y, z, n, n),            # right (x+)
    ]
    return _assemble(patches)


def cylinder(radius: float = 0.4, height: float = 1.0,
             segments: int = 24, rings: int = 8) -> TriMesh:
    """Capped cylinder: curved sheet meeting flat caps in two circular
    creases (the fandisk failure mode)."""
    th = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    zs = np.linspace(-height / 2, height / 2, rings + 1)
    ring = np.stack([radius * np.cos(th), radius * np.sin(th)], axis=1)
    side_v = np.concatenate(
        [np.concatenate([ring, np.full((segments, 1), z)], 1) for z in zs]
    )
    faces = []
    for r in range(rings):
        for s in range(segments):
            a = r * segments + s
            b = r * segments + (s + 1) % segments
            c = a + segments
            d = b + segments
            faces.extend([[a, b, d], [a, d, c]])
    side_f = np.asarray(faces)

    def cap(z, flip):
        # Triangle fan plus one interior ring so caps carry patches.
        inner = 0.5 * ring
        v = np.concatenate([
            np.array([[0.0, 0.0, z]]),
            np.concatenate([inner, np.full((segments, 1), z)], 1),
            np.concatenate([ring, np.full((segments, 1), z)], 1),
        ])
        f = []
        for s in range(segments):
            s2 = (s + 1) % segments
            f.append([0, 1 + s, 1 + s2])
            f.extend([
                [1 + s, 1 + segments + s, 1 + segments + s2],
                [1 + s, 1 + segments + s2, 1 + s2],
            ])
        f = np.asarray(f)
        return v, (f[:, ::-1] if flip else f)

    return _assemble([
        (side_v, side_f),
        cap(height / 2, flip=False),
        cap(-height / 2, flip=True),
    ])


def extrude_polygon(poly2d, depth: float = 1.0, n_edge: int = 6,
                    n_depth: int = 6, kernel=None) -> TriMesh:
    """Watertight extrusion of a CCW simple polygon along +z.

    Sides are ``n_edge x n_depth`` grids per polygon edge; caps are
    fans from ``kernel`` (default: the vertex centroid — pass an
    interior kernel point for non-star polygons) over the same
    subdivided boundary, so every boundary edge is shared exactly twice
    and the result is manifold."""
    poly = np.asarray(poly2d, np.float64)
    m = len(poly)
    dz = np.array([0.0, 0.0, depth])
    patches = []
    for i in range(m):
        p = np.array([*poly[i], 0.0])
        q = np.array([*poly[(i + 1) % m], 0.0])
        patches.append(_grid_patch(p, q - p, dz, n_edge, n_depth))
    # Subdivided boundary loop (matches the side grids' edge points).
    loop = []
    for i in range(m):
        p, q = poly[i], poly[(i + 1) % m]
        for t in np.linspace(0.0, 1.0, n_edge, endpoint=False):
            loop.append(p + t * (q - p))
    loop = np.asarray(loop)
    centroid = (np.mean(poly, axis=0) if kernel is None
                else np.asarray(kernel, np.float64))
    nb = len(loop)
    for z, flip in ((depth, False), (0.0, True)):
        v = np.concatenate([
            np.array([[*centroid, z]]),
            np.concatenate([loop, np.full((nb, 1), z)], 1),
        ])
        f = np.array(
            [[0, 1 + s, 1 + (s + 1) % nb] for s in range(nb)]
        )
        patches.append((v, f[:, ::-1] if flip else f))
    return _assemble(patches)


def wedge(angle_deg: float = 35.0, length: float = 1.2,
          n: int = 8) -> TriMesh:
    """Triangular prism with one acute crease — sharper than any box
    edge, the hardest convex feature."""
    a = np.deg2rad(angle_deg)
    poly = [[0.0, 0.0], [1.0, 0.0], [np.cos(a), np.sin(a)]]
    return extrude_polygon(poly, depth=length, n_edge=n, n_depth=n)


def stairs(steps: int = 4, n: int = 4, depth: float = 1.0) -> TriMesh:
    """Staircase block: alternating convex and CONCAVE right-angle
    creases (concave features are absent from every scan mesh in the
    shipped corpus)."""
    w = 1.0 / steps
    poly = [[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]]
    for s in range(steps - 1, -1, -1):
        poly.append([s * w, (s + 1) * w])
        if s > 0:
            poly.append([s * w, s * w])
    return extrude_polygon(
        poly, depth=depth, n_edge=n, n_depth=2 * n,
        kernel=(1.0 - w / 2, w / 2),  # sees every tread from below
    )


def lbracket(arm: float = 1.0, thick: float = 0.35, width: float = 0.6,
             n: int = 6) -> TriMesh:
    """L-shaped bracket: an interior concave corner between two arms —
    the machine-part junction fandisk is full of."""
    t, a = thick, arm
    poly = [[0, 0], [a, 0], [a, t], [t, t], [t, a], [0, a]]
    # The corner square is the star kernel of the L.
    return extrude_polygon(
        poly, depth=width, n_edge=n, n_depth=n, kernel=(t / 2, t / 2)
    )


def icosphere(subdiv: int = 3, radius: float = 0.6) -> TriMesh:
    """Subdivided icosahedron — the smooth organic control shape."""
    phi = (1 + np.sqrt(5)) / 2
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    for _ in range(subdiv):
        mids = {}
        verts = list(v)

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in mids:
                mids[key] = len(verts)
                verts.append((verts[i] + verts[j]) / 2)
            return mids[key]

        nf = []
        for t in f:
            a, b, c = (int(i) for i in t)
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf.extend([[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]])
        v, f = np.array(verts), np.array(nf)
    v = radius * v / np.linalg.norm(v, axis=1, keepdims=True)
    return TriMesh.from_numpy(v.astype(np.float32), f.astype(np.int32))


def torus(r_major: float = 0.5, r_minor: float = 0.2,
          n_major: int = 32, n_minor: int = 16) -> TriMesh:
    """Torus — smoothly varying curvature including negative (saddle)
    regions."""
    th = np.linspace(0, 2 * np.pi, n_major, endpoint=False)
    ph = np.linspace(0, 2 * np.pi, n_minor, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    x = (r_major + r_minor * np.cos(pp)) * np.cos(tt)
    y = (r_major + r_minor * np.cos(pp)) * np.sin(tt)
    z = r_minor * np.sin(pp)
    v = np.stack([x, y, z], -1).reshape(-1, 3)
    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a = i * n_minor + j
            b = i * n_minor + (j + 1) % n_minor
            c = ((i + 1) % n_major) * n_minor + j
            d = ((i + 1) % n_major) * n_minor + (j + 1) % n_minor
            faces.extend([[a, d, b], [a, c, d]])
    return TriMesh.from_numpy(
        v.astype(np.float32), np.asarray(faces, np.int32)
    )


def revolve(profile, segments: int = 28) -> TriMesh:
    """Surface of revolution of an (r, z) polyline around the z axis.

    The profile must start and end ON the axis (r == 0) so the result
    is watertight: axis endpoints become single apex vertices with
    triangle fans, interior points become ``segments``-wide rings
    joined by quad strips. Orientation is fixed afterwards by the
    signed-volume test, so the profile may be authored in either
    direction."""
    prof = np.asarray(profile, np.float64)
    # ValueError (not assert): a bad profile silently yields a
    # non-watertight mesh, and asserts vanish under ``python -O``.
    if not (abs(prof[0, 0]) < 1e-12 and abs(prof[-1, 0]) < 1e-12):
        raise ValueError("profile must start and end on the axis (r == 0)")
    if not (prof[1:-1, 0] > 1e-9).all():
        raise ValueError("interior profile points need r > 0")
    th = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    cs, sn = np.cos(th), np.sin(th)

    verts, rows = [], []
    for r, z in prof:
        if r < 1e-12:
            rows.append((len(verts), True))
            verts.append([0.0, 0.0, z])
        else:
            rows.append((len(verts), False))
            verts.extend(np.stack([r * cs, r * sn, np.full(segments, z)], 1))
    faces = []
    for (a0, a_apex), (b0, b_apex) in zip(rows[:-1], rows[1:]):
        for s in range(segments):
            s2 = (s + 1) % segments
            if a_apex:
                faces.append([a0, b0 + s, b0 + s2])
            elif b_apex:
                faces.append([a0 + s, b0, a0 + s2])
            else:
                faces.append([a0 + s, b0 + s, b0 + s2])
                faces.append([a0 + s, b0 + s2, a0 + s2])
    mesh = _weld(np.asarray(verts), np.asarray(faces))
    v, f = mesh.v.numpy(), mesh.f.numpy()
    vol = np.sum(np.einsum(
        "ij,ij->i", v[f[:, 0]], np.cross(v[f[:, 1]], v[f[:, 2]])
    ))
    if vol < 0:
        mesh = TriMesh.from_numpy(v, f[:, ::-1].copy())
    return mesh


def _subdivided(points, per_edge: int):
    """Polyline with ``per_edge`` extra samples inside every segment."""
    pts = np.asarray(points, np.float64)
    out = []
    for p, q in zip(pts[:-1], pts[1:]):
        for t in np.linspace(0.0, 1.0, per_edge, endpoint=False):
            out.append(p + t * (q - p))
    out.append(pts[-1])
    return np.asarray(out)


def _rounded_square(side: float, radii, arc_pts: int = 6):
    """CCW square outline with per-corner fillet radii (0 = sharp)."""
    h = side / 2
    corners = [(h, h), (-h, h), (-h, -h), (h, -h)]  # CCW
    angles = [0.0, np.pi / 2, np.pi, 3 * np.pi / 2]
    poly = []
    for (cx, cy), a0, r in zip(corners, angles, radii):
        if r <= 0:
            poly.append([cx, cy])
            continue
        ctr = (cx - np.sign(cx) * r, cy - np.sign(cy) * r)
        for t in np.linspace(a0, a0 + np.pi / 2, arc_pts):
            poly.append([ctr[0] + r * np.cos(t), ctr[1] + r * np.sin(t)])
    return poly


def fillet_box(side: float = 1.0, depth: float = 0.8,
               radii=(0.3, 0.0, 0.18, 0.0), n: int = 5) -> TriMesh:
    """Extruded square with FILLETED vertical edges: cylindrical blends
    meeting planes tangentially (fandisk's dominant feature), mixed
    with sharp edges on the un-rounded corners."""
    return extrude_polygon(
        _rounded_square(side, radii), depth=depth, n_edge=n, n_depth=n,
        kernel=(0.0, 0.0),
    )


def chamfer_box(side: float = 1.0, depth: float = 0.8,
                cut: float = 0.22, n: int = 5) -> TriMesh:
    """Extruded square with 45-degree CHAMFERED vertical edges: pairs
    of shallow 135-degree creases flanking each removed 90-degree edge
    — a crease class no other suite shape carries."""
    h = side / 2
    poly = [
        [h, h - cut], [h - cut, h], [-(h - cut), h], [-h, h - cut],
        [-h, -(h - cut)], [-(h - cut), -h], [h - cut, -h], [h, -(h - cut)],
    ]
    return extrude_polygon(
        poly, depth=depth, n_edge=n, n_depth=n, kernel=(0.0, 0.0)
    )


def cone(radius: float = 0.55, height: float = 1.1,
         segments: int = 28) -> TriMesh:
    """Capped cone: curvature increasing toward the apex, plus the
    circular base crease."""
    prof = _subdivided(
        [[0.0, 0.0], [radius, 0.0], [0.0, height]], per_edge=5
    )
    return revolve(prof, segments=segments)


def spherecone(r_sphere: float = 0.5, segments: int = 28) -> TriMesh:
    """Cone-sphere junction ("ice cream"): a downward cone meeting a
    sphere along a circular crease, with the smooth spherical cap above
    — the cone/sphere intersection feature family."""
    zc = 0.35  # sphere center height; junction circle at the equator
    apex = [0.0, -0.8]
    arc = [
        [r_sphere * np.cos(t), zc + r_sphere * np.sin(t)]
        for t in np.linspace(0.0, np.pi / 2, 8)
    ]
    prof = np.concatenate([_subdivided([apex, arc[0]], per_edge=6), arc[1:]])
    return revolve(prof, segments=segments)


def cross(arm: float = 0.6, width: float = 0.4, depth: float = 0.5,
          n: int = 5) -> TriMesh:
    """Plus-sign extrusion: four CONCAVE right-angle corners between
    arms (the interior-junction statistics of machine parts)."""
    w = width / 2
    poly = [
        [arm, w], [w, w], [w, arm], [-w, arm], [-w, w], [-arm, w],
        [-arm, -w], [-w, -w], [-w, -arm], [w, -arm], [w, -w], [arm, -w],
    ]
    return extrude_polygon(
        poly, depth=depth, n_edge=n, n_depth=n, kernel=(0.0, 0.0)
    )


def cad_suite() -> dict:
    """The curated synthetic training mix: every entry is watertight and
    feature-rich; names are stable so datasets are reproducible."""
    return {
        "syn_box": box(n=10),
        "syn_box_flat": box(extents=(1.3, 1.0, 0.25), n=9),
        "syn_cylinder": cylinder(segments=28, rings=10),
        "syn_cylinder_squat": cylinder(
            radius=0.55, height=0.5, segments=32, rings=6
        ),
        "syn_wedge": wedge(angle_deg=35.0),
        "syn_wedge_sharp": wedge(angle_deg=20.0),
        "syn_stairs": stairs(steps=4, n=5),
        "syn_lbracket": lbracket(),
        "syn_icosphere": icosphere(subdiv=3),
        "syn_torus": torus(),
        # Round-3 additions: fillet/chamfer blends and cone/sphere
        # junctions — the crease families the goldens still miss most.
        "syn_fillet_box": fillet_box(),
        "syn_chamfer_box": chamfer_box(),
        "syn_cone": cone(),
        "syn_spherecone": spherecone(),
        "syn_cross": cross(),
    }
