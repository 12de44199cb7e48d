"""Observe the port's entry functions from outside the program.

:class:`Capture` replaces a few module attributes of ``repro_torch`` with
thin wrappers that call the original and note what went in and out;
nothing inside the program is edited. Install it before the first solve:
the registry resolves the kernel functions when it builds an entry.

* ``core.solver.separate`` (every run): the round-0 separation of the
  next solve that :meth:`Capture.expect_cycles` announced, its triangles
  and the chord slots it wrote, copied (a few thousand entries), for the
  reference to check against the instance the benchmark made.
* With ``traced=True``, and while :attr:`Capture.recording` is set:
  ``kernels.triangle_mp.ops.mp_phase`` (the triangles of each call, by
  reference: no device work inside the range it runs in),
  ``kernels.cycle_intersect.ops.intersect_rows`` (each launch's shape)
  and ``core.solver.contract_csr`` (live edges and nodes in and out, as
  four device reductions a call: microseconds against the call's
  hundreds of milliseconds).
"""
from __future__ import annotations


class Capture:
    def __init__(self, traced: bool):
        self.traced = traced
        self.recording = False
        self.cycles = []        # one dict per announced solve
        self.mp_calls = []      # (tri, tri_valid, iters)
        self.intersect_calls = []   # (R, W, Wj)
        self.contractions = []  # (edges_in, nodes_in, edges_out, nodes_out)
        self._want = None
        self._undo = []

    def _patch(self, module, name, make):
        orig = getattr(module, name)
        setattr(module, name, make(orig))
        self._undo.append((module, name, orig))

    def install(self) -> "Capture":
        from repro_torch.core import solver
        self._patch(solver, "separate", self._separate)
        if self.traced:
            from repro_torch.kernels.cycle_intersect import ops as isect
            from repro_torch.kernels.triangle_mp import ops as tri
            self._patch(tri, "mp_phase", self._mp_phase)
            self._patch(isect, "intersect_rows", self._intersect)
            self._patch(solver, "contract_csr", self._contract_csr)
        return self

    def uninstall(self) -> None:
        while self._undo:
            module, name, orig = self._undo.pop()
            setattr(module, name, orig)

    def expect_cycles(self, num_valid_edges: int) -> None:
        """Keep the cycles of the next separation call, a solve's round 0
        on an instance whose first ``num_valid_edges`` slots are its
        edges."""
        self._want = num_valid_edges

    def take_cycles(self):
        """The cycles kept since the last call, or None."""
        self._want = None
        return self.cycles.pop() if self.cycles else None

    def _separate(self, orig):
        def separate(inst, *args, **kw):
            sep = orig(inst, *args, **kw)
            if self._want is not None:
                E, self._want = self._want, None
                out = sep.instance
                self.cycles.append(dict(
                    tri=sep.triangles.edges.clone(),
                    valid=sep.triangles.valid.clone(),
                    first_chord=E,
                    chord_u=out.u[E:].clone(), chord_v=out.v[E:].clone(),
                    chord_cost=out.cost[E:].clone(),
                    chord_valid=out.edge_valid[E:].clone()))
            return sep
        return separate

    def _mp_phase(self, orig):
        def mp_phase(cost, edge_valid, tri, tri_valid, iters):
            if self.recording and tri.shape[0] and cost.shape[0]:
                self.mp_calls.append((tri, tri_valid, iters))
            return orig(cost, edge_valid, tri, tri_valid, iters)
        return mp_phase

    def _intersect(self, orig):
        def intersect_rows(ci, cj):
            if self.recording and ci.numel() and cj.numel():
                self.intersect_calls.append(
                    (ci.shape[0], ci.shape[1], cj.shape[1]))
            return orig(ci, cj)
        return intersect_rows

    def _contract_csr(self, orig):
        def contract_csr(inst, *args, **kw):
            res, csr = orig(inst, *args, **kw)
            if self.recording:
                self.contractions.append((
                    inst.edge_valid.sum(), inst.node_valid.sum(),
                    res.instance.edge_valid.sum(),
                    res.instance.node_valid.sum()))
            return res, csr
        return contract_csr
