"""Slabs with halos: the point smoother and the level ops across ranks
(the line smoothers on slabs are in :mod:`.lines`).

Counterpart of the point half of ``emg3d_tpu/parallel/shmap.py`` and of
the GSPMD partitioning the JAX package leaves to its compiler.  Every
rank holds, of each sharded level, a **slab**: its owned node planes
along each sharded grid axis (y, z or both) plus one ghost node plane on
each side that has a neighbour, and the cells between them.  So a slab
is a level of its own, of cell shape ``Slab.local_shape``, whose
boundary planes are the ghosts; the port's point kernels K1/K2 run on it
unchanged (:func:`gauss_seidel_point_sharded`).

Ownership.  Along a sharded axis the node planes are split at the
boundaries of :func:`partition`; rank i owns nodes ``[t_i, t_{i+1})``
and the cells of the same indices (cell k lies between nodes k and
k+1).  Its slab holds nodes ``t_i − 1 .. t_{i+1}``: cell ``t_i − 1``,
between the lower ghost node and the first owned node, is owned by the
lower neighbour and shared: the residual at the first owned node reads
the neighbour's cell-direction source there (tests/test_parallel.py:
99-102 records that bug), and both sides' nodes deposit into its edges.

Exchanges.  Messages run along one mesh axis at a time, z before y: a
y message carries the z ghost positions that the z exchange has just
filled, so 2-D corner values arrive with the y exchange (the JAX
package's order, shmap.py:189-191).  A message is one packed buffer of
whole planes: "up" carries the sender's last owned node planes and its
last owned cell plane into the receiver's lower ghosts; "down" carries
the sender's first owned node planes (and, in a colour step, the shared
cell plane) into the receiver's upper ghosts.

- A colour step of 8-colour Gauss-Seidel updates the nodes of one parity
  per axis, so at each rank boundary exactly one side updates its
  boundary node plane.  That side sends its three boundary planes (two
  node-registered, the shared cell plane) across: one message per
  boundary and colour step, exact copies, no deposits to add
  (:meth:`Slab.colour_exchange`).  The JAX package instead computes a
  zero-halo bulk overlapped with the exchange and fixes the boundary
  stripes after it (``_point_bulk``/``_point_boundary_fix``); the port
  exchanges after each step, the same numbers to rounding.  The overlap
  is performance work (ROADMAP).
- The transfers run on the slab: restriction after an "up" refresh of
  the residual (it reads the lower neighbour's last node plane),
  prolongation from the coarse slab, whose ghosts cover every fine
  plane the slab holds.  The partition nests (:func:`partition`), so
  coarse and fine rank boundaries line up.
- At the first replicated level the residual is gathered on every rank
  (:meth:`Slab.gather`: one ``all_gather`` of the owned edges) and every
  rank runs the same coarse tail.

Transport: one ``batch_isend_irecv`` per axis and exchange, under
either backend; NCCL moves device tensors, gloo host tensors, so under
gloo a message on a card is staged through the host.  ``SENDS`` counts
the messages this rank sent.
"""
import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..ops import point_gs, smoothers, stencil, transfers
from .sharding import VALID_AXES, mesh_sizes

__all__ = ['Space', 'WHOLE', 'Slab', 'partition', 'joint_partition',
           'supported_mesh', 'level_sharded', 'sharded_count',
           'gauss_seidel_point_sharded', 'shard_levels', 'restrict',
           'prolongate', 'SENDS', 'reset_sends', 'MIN_LINE_PLANES']

# Messages this rank sent since the last reset_sends(): 'colour' in the
# point and line smoothers' colour steps (across a line's transverse
# axes), 'line' along a line axis split over ranks (after each colour
# step of the Schur-complement smoother, .lines), 'reduced' the
# all_gathers of its reduced systems (one per colour step, one per line
# state), 'halo' in the refreshes of the transfers and of the Krylov
# vectors, 'sums' the all_reduces of norms and inner products
# (Slab.reduce).
SENDS = {'colour': 0, 'halo': 0, 'line': 0, 'reduced': 0, 'sums': 0}

# Node planes every rank keeps along a line axis split over ranks for
# the Schur-complement smoother (the JAX package's supported_line,
# shmap.py:102-119, on this partition): an interface station and an
# interior of two or more.  Below it the level is gathered (.lines).
MIN_LINE_PLANES = 4

_GRID_AXIS = {'y': 1, 'z': 2}


def reset_sends():
    for k in SENDS:
        SENDS[k] = 0


def _enough_planes(shape, sizes):
    """Each sharded axis needs ≥ 2 node planes per rank (shmap.py:85).
    :func:`partition` splits the cells, so that takes ≥ 2 cells per rank
    (the JAX package's rule, n + 1 ≥ 2p nodes, admits n = 2p − 1 too)."""
    return all(shape[_GRID_AXIS[name]] >= 2 * p
               for name, p in sizes.items())


def supported_mesh(mesh, shape):
    """The point pipeline runs on ('y',), ('z',) or ('y', 'z') meshes
    where every rank keeps two node planes (shmap.py:92-96)."""
    if mesh is None or tuple(mesh.mesh_dim_names) not in VALID_AXES:
        return False
    return _enough_planes(shape, mesh_sizes(mesh))


def level_sharded(shape, mesh, min_local_planes):
    """Whether a level of cell shape ``shape`` is distributed: the JAX
    package's rule (every rank keeps ``min_local_planes`` cells along
    each sharded axis, ``emg3d_tpu/solver.py:870-888``) where the point
    pipeline supports the mesh."""
    return supported_mesh(mesh, shape) and all(
        shape[_GRID_AXIS[name]] >= min_local_planes * p
        for name, p in mesh_sizes(mesh).items())


def partition(mesh, shapes, finest=None):
    """Node-plane boundaries of the sharded levels ``shapes`` (finest
    first, each the next one's parent).

    Returns one ``{axis: (t_0, ..., t_P)}`` per level, rank i owning
    nodes ``[t_i, t_{i+1})``.  The coarsest level's n cells are split as
    evenly as they allow, the last rank also owning node n; each finer
    level doubles its boundaries along an axis it coarsens, so a coarse
    rank boundary is a fine one (node c is fine node 2c): the partition
    nests, and the transfers need no plane moved between ranks.  A rank
    owns about 2^k·n/P planes of a level k coarsenings finer, the ranks'
    shares differing by at most 2^k planes plus the last node.  (Split
    nodes instead, and the spare node of the coarsest level doubles into
    2^k extra planes of one rank.)

    ``finest`` (``{axis: boundaries}`` of the finest level, as
    :func:`joint_partition` gives them) fixes the finest level instead:
    each coarser level halves the boundaries along an axis it coarsens,
    which must then be even.
    """
    out = [dict() for _ in shapes]
    for name, p in mesh_sizes(mesh).items():
        ax = _GRID_AXIS[name]
        if finest is not None:
            t = tuple(finest[ax])
            if t[0] != 0 or t[-1] != shapes[0][ax] + 1:
                raise ValueError(f"finest boundaries {t} along axis {ax} of "
                                 f"the level {shapes[0]}")
            out[0][ax] = t
            for lvl in range(1, len(shapes)):
                n, nc = shapes[lvl - 1][ax], shapes[lvl][ax]
                if n == 2 * nc:
                    if any(v % 2 for v in t[:-1]):
                        raise ValueError(f"boundaries {t} do not nest into "
                                         f"the level {shapes[lvl]}")
                    t = tuple(v // 2 for v in t[:-1]) + (nc + 1,)
                elif n != nc:
                    raise ValueError(f"level {shapes[lvl - 1]} is not the "
                                     f"parent of {shapes[lvl]}")
                out[lvl][ax] = t
            continue
        n = shapes[-1][ax]
        t = [(i * n + p // 2) // p for i in range(p)] + [n + 1]
        out[-1][ax] = tuple(t)
        for lvl in range(len(shapes) - 2, -1, -1):
            n, nc = shapes[lvl][ax], shapes[lvl + 1][ax]
            if n == 2 * nc:
                t = [2 * v for v in t[:-1]] + [n + 1]
            elif n != nc:
                raise ValueError(f"level {shapes[lvl]} is not the parent "
                                 f"of {shapes[lvl + 1]}")
            out[lvl][ax] = tuple(t)
    return out


def joint_partition(mesh, hierarchies):
    """The finest level's boundaries shared by several hierarchies.

    ``hierarchies`` lists, per semicoarsening direction of a solve, the
    cell shapes of its sharded levels (finest first; every list starts
    at the same finest level).  Along each sharded axis the hierarchy
    that coarsens it most often sets the finest boundaries
    (:func:`partition` of its levels): they are multiples of 2^k for its
    k coarsenings, so every hierarchy, coarsening that axis k times or
    fewer, nests into them.  Returns ``{axis: boundaries}``.
    """
    finest = {}
    for name in mesh.mesh_dim_names:
        ax = _GRID_AXIS[name]
        deepest = max(hierarchies, key=lambda shapes: sum(
            a[ax] != b[ax] for a, b in zip(shapes, shapes[1:])))
        finest[ax] = partition(mesh, deepest)[0][ax]
    return finest


def _dim(t, ax):
    """Tensor dimension of grid axis ``ax`` (leading lane axes allowed)."""
    return t.ndim - 3 + ax


def _index(t, slices):
    """An index of ``t`` taking ``slices[ax]`` along grid axis ``ax``."""
    idx = [slice(None)] * t.ndim
    for ax, sl in slices.items():
        idx[_dim(t, ax)] = sl
    return tuple(idx)


def _backend():
    return dist.get_backend()


def _wire(t):
    """A contiguous real tensor the backend moves: device tensors for
    NCCL, host tensors for gloo."""
    r = torch.view_as_real(t) if t.is_complex() else t
    if _backend() != 'nccl' and r.device.type != 'cpu':
        r = r.cpu()
    return r.contiguous()


class Space:
    """Sums over a level's edges, each edge once: the residual norms and
    the Krylov solvers' inner products.  This base is a whole level on
    one process (:data:`WHOLE`): every edge is owned and the sum over
    the ranks is the sum itself.  A :class:`Slab` sums its owned edges,
    then over the ranks, so every rank gets the same numbers (and takes
    the same branches)."""

    def owned_view(self, f, c):
        """The edges of component ``c`` of ``f`` that this process owns."""
        return f

    def reduce(self, t):
        """The sum of ``t`` over the ranks."""
        return t

    def norm(self, r):
        """‖r‖₂ over the whole level, as a float."""
        acc = sum(torch.sum(v.real ** 2 + v.imag ** 2)
                  for v in (self.owned_view(f, c) for c, f in enumerate(r)))
        with trace.span('sync'):
            return float(torch.sqrt(self.reduce(acc)))


WHOLE = Space()


class Slab(Space):
    """One rank's part of a sharded level of global cell shape ``shape``.

    ``parts`` is the level's entry of :func:`partition`.  Per sharded
    axis ``ax``: ``owned[ax] = (a, b)`` the owned node planes, ``lo[ax]``
    and ``hi[ax]`` the first and last node plane of the slab (a ghost
    where a neighbour exists), ``nbr[ax] = (lower, upper)`` the
    neighbours' global ranks or None.  ``local_shape`` is the slab's
    cell shape.
    """

    def __init__(self, shape, mesh, parts):
        self.shape = tuple(shape)
        self.mesh, self.parts = mesh, parts
        self.owned, self.lo, self.hi, self.nbr = {}, {}, {}, {}
        self.coord, self.dim_name = {}, {}
        # The whole level's (eta_x, ..., hz) on the host where a line
        # smoother gathers this level (shard_levels), else None.
        self.whole = None
        coord = mesh.get_coordinate()
        ranks = mesh.mesh
        # Every rank's owned node planes, by global rank (for gather).
        grid_axes = [_GRID_AXIS[name] for name in mesh.mesh_dim_names]
        self.owned_by_rank = {
            int(ranks[idx]): {ax: parts[ax][i:i + 2]
                              for ax, i in zip(grid_axes, idx)}
            for idx in np.ndindex(*ranks.shape)}
        for d, name in enumerate(mesh.mesh_dim_names):
            ax = _GRID_AXIS[name]
            t, i = parts[ax], coord[d]
            last = len(t) - 2
            a, b = t[i], t[i + 1]
            self.owned[ax] = (a, b)
            self.coord[ax], self.dim_name[ax] = i, name
            self.lo[ax] = a - 1 if i > 0 else 0
            self.hi[ax] = b if i < last else self.shape[ax]

            def rank(j, d=d):
                idx = list(coord)
                idx[d] = j
                return int(ranks[tuple(idx)])
            self.nbr[ax] = (rank(i - 1) if i > 0 else None,
                            rank(i + 1) if i < last else None)
        self.axes = tuple(sorted(self.owned))
        self.local_shape = tuple(
            self.hi[ax] - self.lo[ax] if ax in self.owned else self.shape[ax]
            for ax in range(3))

    # -- layout -----------------------------------------------------------

    def owned_cells(self, ax):
        a, b = self.owned[ax]
        return a, min(b, self.shape[ax])

    def _globals(self, owned, c):
        """{sharded axis: global slice} of the planes of component ``c``
        that a rank owning node planes ``owned`` owns: cells along ``c``
        (the last rank's last node has no cell), nodes across it."""
        return {ax: slice(a, min(b, self.shape[ax]) if ax == c else b)
                for ax, (a, b) in owned.items()}

    def cut(self, t, cells):
        """The slab of a global tensor; ``cells[ax]`` says whether grid
        axis ``ax`` is cell-registered."""
        for ax in self.axes:
            n = self.hi[ax] - self.lo[ax] + (0 if cells[ax] else 1)
            t = t.narrow(_dim(t, ax), self.lo[ax], n)
        return t.contiguous()

    def cut_field(self, e):
        """Slabs of edge fields: component c is cell-registered along c."""
        return tuple(self.cut(f, [ax == c for ax in range(3)])
                     for c, f in enumerate(e))

    def cut_arrays(self, arrays):
        """Slabs of (eta_x, eta_y, eta_z, zeta, hx, hy, hz)."""
        cube = tuple(self.cut(a, (True,) * 3) for a in arrays[:4])
        widths = tuple(h.narrow(0, self.lo[ax], self.hi[ax] - self.lo[ax])
                       .contiguous() if ax in self.owned else h
                       for ax, h in enumerate(arrays[4:]))
        return cube + widths

    def split(self, ax):
        """Whether grid axis ``ax`` is divided between ranks here."""
        return ax in self.owned and self.nbr[ax] != (None, None)

    def line_supported(self, ax):
        """Whether lines along ``ax`` run the Schur-complement smoother:
        every rank keeps MIN_LINE_PLANES node planes along it."""
        return min(np.diff(self.parts[ax])) >= MIN_LINE_PLANES

    def local_colour(self, colour):
        """The slab's colour of a global colour: the parity of an axis
        flips where the slab starts at an odd node (_Halo.coords,
        shmap.py:263-277)."""
        par = [colour % 2, (colour // 2) % 2, colour // 4]
        for ax in self.axes:
            par[ax] ^= self.lo[ax] & 1
        return par[0] + 2 * par[1] + 4 * par[2]

    # -- exchanges ----------------------------------------------------------

    @staticmethod
    def _planes(fields, ax, up, cell, send):
        """The planes of a message along ``ax``: what an ``up`` message
        sends from the sender's top (last owned node planes, local -2;
        last owned cell, local -1) or a ``down`` message from its bottom
        (first owned node planes, local 1; shared cell, local 0), and
        where it lands on the receiver (``up``: lower ghosts, local 0;
        ``down``: upper ghosts, local -1).  The cell-registered component
        rides along where ``cell``."""
        out = []
        for c, f in enumerate(fields):
            if c == ax and not cell:
                continue
            if send:
                idx = (-1 if c == ax else -2) if up else \
                    (0 if c == ax else 1)
            else:
                idx = 0 if up else -1
            out.append(f.select(_dim(f, ax), idx))
        return out

    def _stage(self, fields, ax, msgs, counter):
        """Run one axis's messages: ``msgs`` is a list of (peer, up,
        cell, send); sends take this rank's planes, receives land in its
        ghosts.  Waits for all of them."""
        nccl = _backend() == 'nccl'
        ops, landing = [], []
        for peer, up, cell, send in msgs:
            planes = self._planes(fields, ax, up, cell, send)
            if send:
                buf = _wire(torch.cat([p.reshape(-1) for p in planes]))
                ops.append(dist.P2POp(dist.isend, buf, peer))
                SENDS[counter] += 1
            else:
                n = sum(p.numel() for p in planes)
                buf = torch.empty(
                    (n, 2) if planes[0].is_complex() else (n,),
                    dtype=planes[0].real.dtype,
                    device=planes[0].device if nccl else 'cpu')
                ops.append(dist.P2POp(dist.irecv, buf, peer))
                landing.append((buf, planes))
        if not ops:
            return
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for buf, planes in landing:
            flat = buf.to(planes[0].device)
            if planes[0].is_complex():
                flat = torch.view_as_complex(flat)
            pos = 0
            for p in planes:
                p.copy_(flat[pos:pos + p.numel()].view(p.shape))
                pos += p.numel()

    def colour_exchange(self, e, colour):
        """Bring every copy of the edges that global ``colour``'s step
        changed up to date: at each boundary the side whose boundary
        node plane has the colour's parity sends its three planes."""
        self.exchange(e, dict(enumerate(
            (colour % 2, (colour // 2) % 2, colour // 4))))

    def exchange(self, e, par, line_axis=None):
        """The messages after a colour step that updated the nodes of
        parity ``par[ax]`` along each sharded axis ``ax`` (point and
        line smoothers; a line's transverse axes), and every station
        along ``line_axis``, a line axis split over ranks (the Schur
        smoother, .lines: a rank updates its stations' ex, the shared
        cell below its first owned node included, and their transverse
        edges, its owned node planes).  Along the line axis a rank sends
        its last owned node planes up and its first owned node plane
        with the shared cell down, and receives their counterparts."""
        for ax in sorted(self.axes, reverse=True):      # z, then y
            (a, b), (lower, upper) = self.owned[ax], self.nbr[ax]
            msgs = []
            if ax == line_axis:
                if upper is not None:
                    msgs += [(upper, True, False, True),
                             (upper, False, True, False)]
                if lower is not None:
                    msgs += [(lower, True, False, False),
                             (lower, False, True, True)]
                self._stage(e, ax, msgs, 'line')
                continue
            if upper is not None:
                mine = (b - 1) % 2 == par[ax]
                msgs.append((upper, mine, True, mine))
            if lower is not None:
                mine = a % 2 == par[ax]
                msgs.append((lower, not mine, True, mine))
            self._stage(e, ax, msgs, 'colour')

    def refresh(self, fields, down=True):
        """Fill the ghosts from their owners: lower ghosts (node planes
        and the shared cell) from the lower neighbour, and where
        ``down``, the upper ghost node planes from the upper one."""
        for ax in sorted(self.axes, reverse=True):      # z, then y
            lower, upper = self.nbr[ax]
            msgs = []
            if upper is not None:
                msgs.append((upper, True, True, True))
                if down:
                    msgs.append((upper, False, False, False))
            if lower is not None:
                msgs.append((lower, True, True, False))
                if down:
                    msgs.append((lower, False, False, True))
            self._stage(fields, ax, msgs, 'halo')

    # -- level ops ----------------------------------------------------------

    def pec(self, fields):
        """Zero the tangential edges on the global boundary planes the
        slab holds (PEC); ghost planes are no boundary.  In place."""
        for c, f in enumerate(fields):
            for ax in range(3):
                if ax == c:
                    continue
                dim = _dim(f, ax)
                if ax not in self.owned or self.lo[ax] == 0:
                    f.select(dim, 0).zero_()
                if ax not in self.owned or self.hi[ax] == self.shape[ax]:
                    f.select(dim, -1).zero_()
        return fields

    def owned_view(self, f, c):
        """The owned edges of this rank's slab of component ``c`` (a
        leading axis, a stack's slots, rides along)."""
        glob = self._globals(self.owned, c)
        return f[_index(f, {
            ax: slice(g.start - self.lo[ax], g.stop - self.lo[ax])
            for ax, g in glob.items()})]

    def reduce(self, t):
        """The sum of ``t`` over all ranks, on ``t``'s device (one
        ``all_reduce``, which may overwrite ``t``)."""
        wire = _wire(t.reshape(-1))
        dist.all_reduce(wire)
        SENDS['sums'] += 1
        out = wire.to(t.device)
        if t.is_complex():
            out = torch.view_as_complex(out)
        return out.reshape(t.shape)

    def line_gather(self, t, ax):
        """``t`` of every rank along grid axis ``ax`` (this rank's line
        group), in their order: one ``all_gather``, counted in
        ``SENDS['reduced']``."""
        group = self.mesh.get_group(self.dim_name[ax])
        wire = _wire(t)
        parts = [torch.empty_like(wire)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, wire, group=group)
        SENDS['reduced'] += 1
        out = []
        for p in parts:
            p = p.to(t.device)
            out.append(torch.view_as_complex(p) if t.is_complex() else p)
        return out

    def gather(self, fields):
        """The whole level's fields on every rank: one all_gather of each
        rank's owned edges (packed, padded to the largest share), placed
        by the partition."""
        nx, ny, nz = self.shape
        shapes = ((nx, ny + 1, nz + 1), (nx + 1, ny, nz + 1),
                  (nx + 1, ny + 1, nz))
        full = [torch.zeros(f.shape[:-3] + sh, dtype=f.dtype,
                            device=f.device)
                for f, sh in zip(fields, shapes)]
        # Every rank's owned index of each component, by global rank.
        index = [[_index(g, self._globals(owned, c))
                  for c, g in enumerate(full)]
                 for _, owned in sorted(self.owned_by_rank.items())]
        sizes = [sum(g[i].numel() for g, i in zip(full, idx))
                 for idx in index]
        mine = torch.cat([self.owned_view(f, c).reshape(-1)
                          for c, f in enumerate(fields)])
        mine = torch.cat([mine, mine.new_zeros(max(sizes) - mine.numel())])
        wire = _wire(mine)
        parts = [torch.empty_like(wire) for _ in sizes]
        dist.all_gather(parts, wire)
        for buf, idx in zip(parts, index):
            flat = buf.to(fields[0].device)
            if fields[0].is_complex():
                flat = torch.view_as_complex(flat)
            pos = 0
            for g, i in zip(full, idx):
                block = g[i]
                g[i] = flat[pos:pos + block.numel()].view(block.shape)
                pos += block.numel()
        return tuple(full)

    def coarse_range(self, ax, coarsen):
        """Node planes ``(c0, c1)`` of the coarse level that the slab's
        transfers read or write along ``ax``."""
        if not coarsen[ax]:
            return self.lo[ax], self.hi[ax]
        return self.lo[ax] // 2, (self.hi[ax] + 1) // 2


def gauss_seidel_point_sharded(e, s, state, nu, slab):
    """nu sweeps of 8-colour point Gauss-Seidel on a rank's slab; updates
    ``e`` in place (counterpart of ``gauss_seidel_point_shmap``,
    shmap.py:558-692).

    ``state`` is the slab's :func:`.ops.point_gs.point_state`.  Each
    colour step of ``smoothers.color_sequence(nu)`` runs through the
    port's kernel wrapper (K1 or K2 by the state; the plain version
    where :func:`..ops._build.kernels` says no) with the slab's colour,
    then :meth:`Slab.colour_exchange`.  ``e`` and ``s`` must hold valid
    ghosts; ``e``'s are valid after.
    """
    for colour in smoothers.color_sequence(nu):
        point_gs.gauss_seidel_point(e, s, state, 1,
                                    _seq=[slab.local_colour(colour)])
        slab.colour_exchange(e, colour)
    return e


def sharded_count(shapes, mesh, min_local_planes):
    """How many leading levels of the cell shapes ``shapes`` are
    sharded (:func:`level_sharded`)."""
    m = 0
    while m < len(shapes) and level_sharded(shapes[m], mesh,
                                            min_local_planes):
        m += 1
    return m


def shard_levels(levels, mesh, min_local_planes, device, finest=None):
    """Distribute a level hierarchy built on the host: the leading levels
    that :func:`level_sharded` admits become this rank's slabs
    (``lev.slab``; ``lev.shape`` the slab's cell shape), the rest stay
    whole.  Every tensor moves to ``device``.  ``finest`` fixes the
    finest level's boundaries (:func:`partition`).  A sharded level
    whose lines along a divided axis are too short per rank for the
    Schur smoother keeps its whole arrays on the host (``slab.whole``):
    its line smoother gathers it."""
    m = sharded_count([lev.shape for lev in levels], mesh, min_local_planes)
    parts = partition(mesh, [lev.shape for lev in levels[:m]], finest) \
        if m else []

    def move(w):
        if w is None:
            return None
        if isinstance(w, tuple):
            return tuple(move(v) for v in w)
        return w.to(device)

    for lvl, lev in enumerate(levels):
        if lvl < m:
            lev.slab = Slab(lev.shape, mesh, parts[lvl])
            if any(lev.slab.split(ax) and not lev.slab.line_supported(ax)
                   for ax in lev.slab.axes):
                lev.slab.whole = lev.arrays
            lev.arrays = lev.slab.cut_arrays(lev.arrays)
            lev.shape = lev.slab.local_shape
        lev.arrays = move(lev.arrays)
        lev.rweights = move(lev.rweights)
        lev.pweights = move(lev.pweights)
    return levels


def _pad_lo(t, ax):
    """One zero plane before the first along grid axis ``ax``."""
    dim = _dim(t, ax)
    return torch.cat([torch.zeros_like(t.narrow(dim, 0, 1)), t], dim=dim)


def restrict(r, lev, clev):
    """The coarse source of a sharded level's residual ``r`` (its slab).

    To a sharded coarse level: refresh ``r``'s lower ghosts, pad every
    axis whose slab starts at an odd node with one plane (so local node
    0 is even, as the global restriction assumes) and restrict with the
    weights of the coarse slab's planes; every owned coarse plane reads
    only fine planes of the slab, the ghosts come from a refresh.  To a
    replicated level: gather the residual, restrict it whole.  PEC
    applied either way.
    """
    slab = lev.slab
    if clev.slab is None:
        rc = transfers.restrict(*slab.gather(r), lev.rweights, lev.coarsen)
        return stencil.pec_mask_apply(*rc)
    slab.refresh(r, down=False)
    weights = list(lev.rweights)
    for ax in slab.axes:
        if lev.coarsen[ax]:
            if slab.lo[ax] % 2:
                r = tuple(_pad_lo(f, ax) for f in r)
            c0, c1 = slab.coarse_range(ax, lev.coarsen)
            weights[ax] = tuple(w[c0:c1 + 1] for w in weights[ax])
    rc = transfers.restrict(*r, tuple(weights), lev.coarsen)
    clev.slab.pec(rc)
    clev.slab.refresh(rc)
    return rc


def prolongate(e, ec, lev, clev):
    """``e`` plus the interpolated coarse correction, on the slab.

    ``ec`` is the coarse level's slab (sharded) or whole field
    (replicated; cut to the planes the slab reads).  The coarse planes
    ``Slab.coarse_range`` cover every fine plane of the slab, ghosts
    included, so the result holds valid ghosts with no exchange: a ghost
    is computed from the same coarse values and weights as its owner
    computes it.  PEC applied.
    """
    slab = lev.slab
    coarsen = lev.coarsen
    pw = list(lev.pweights)
    for ax in slab.axes:
        c0, c1 = slab.coarse_range(ax, coarsen)
        if clev.slab is None:
            ec = tuple(f.narrow(_dim(f, ax), c0, c1 - c0 + (c != ax))
                       for c, f in enumerate(ec))
        if coarsen[ax]:
            pw[ax] = pw[ax][c0:c1]

    out = []
    for f, c in zip(e, transfers.interpolate(*ec, tuple(pw), coarsen)):
        for ax in slab.axes:
            # The slab's planes of the interpolated ones (those start at
            # fine node 2·c0).
            c0 = slab.coarse_range(ax, coarsen)[0]
            start = slab.lo[ax] - (2 * c0 if coarsen[ax] else c0)
            c = c.narrow(_dim(c, ax), start, f.shape[_dim(f, ax)])
        out.append(f + c)
    return tuple(slab.pec(out))
