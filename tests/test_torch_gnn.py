"""The port's GNN family (``repro_torch.models.gnn``, the registry's GNN
archs) against the JAX package's, on the CPU, on the same params and
inputs: the JAX ``init_params`` trees go to the port through
``convert.gnn_params_from_numpy``, the batches are numpy arrays from a
seed fed to both.

Each ``(arch, shape)`` pair of ``tests/test_models_gnn.py`` runs at its
``TINY_MOL`` / ``TINY_CLS`` shapes with the config cut to 2 layers of
width 16 (MACE: 8 channels). Held: ``node_repr`` (and the energies of the
energy task) and the registry's loss within rtol 1e-4 / atol 1e-5; the
gradient of every param leaf within rtol 1e-3 / atol 1e-5 x max(1, the
largest |gradient| of the tree) (the random unnormalised inputs give
gradients up to ~100, where an entry near 0 is a difference of large
float32 terms: 1.1e-5 off at a tree maximum of 84); one AdamW
step of the registry's ``step_fn``: every param within rtol 1e-4 / atol
1e-8 (the warm-up keeps the first step's rate at 3e-6). The scatters sum
with ``index_add`` in the port (GNN aggregation feeds no decision), the
gathers, matmuls and einsums take other orders than XLA's: hence
tolerances, not bits. The GraphCast native path is held at the weather
example's config; ``icosphere`` and ``build_topology`` are equal exactly.
The physical properties of ``tests/test_models_gnn.py`` are held in the
port alone.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs  # noqa: E402,F401  (registers the JAX archs)
from repro.configs.base import GNN_SHAPES as J_GNN_SHAPES  # noqa: E402
from repro.configs.base import REGISTRY as JREGISTRY  # noqa: E402
from repro.configs.base import ShapeCell as JShapeCell  # noqa: E402
from repro.models.gnn import common as jcommon  # noqa: E402
from repro.models.gnn import graphcast as jgc  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import GNN_SHAPES, ShapeCell  # noqa: E402
from repro_torch.convert import gnn_params_from_numpy  # noqa: E402
from repro_torch.examples import weather_graphcast as tweather  # noqa: E402
from repro_torch.models.gnn import common as tcommon  # noqa: E402
from repro_torch.models.gnn import egnn as teg  # noqa: E402
from repro_torch.models.gnn import graphcast as tgc  # noqa: E402
from repro_torch.models.gnn import mace as tmc  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_ATOL_REL = 1e-3, 1e-5
STEP_TOL = dict(rtol=1e-4, atol=1e-8)
GNN_IDS = ["dimenet", "egnn", "mace", "graphcast"]
TINY = {
    "molecule": dict(n_nodes=8, n_edges=16, batch=4, d_feat=8,
                     task="energy"),
    "full_graph_sm": dict(n_nodes=32, n_edges=64, d_feat=12, n_classes=5,
                          task="node_cls"),
}
PAIRS = [("dimenet", "molecule"), ("egnn", "molecule"), ("mace", "molecule"),
         ("graphcast", "full_graph_sm"), ("dimenet", "full_graph_sm"),
         ("egnn", "full_graph_sm")]
CUT = {"dimenet": dict(n_blocks=2, d_hidden=16),
       "egnn": dict(n_layers=2, d_hidden=16),
       "mace": dict(n_layers=2, d_hidden=8),
       "graphcast": dict(n_layers=2, d_hidden=16)}


def _archs(aid):
    j = JREGISTRY[aid]
    t = get_arch(aid)
    return (dataclasses.replace(j, cfg=dataclasses.replace(j.cfg,
                                                           **CUT[aid])),
            dataclasses.replace(t, cfg=dataclasses.replace(t.cfg,
                                                           **CUT[aid])))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pairs(t, j, path=""):
    """(path, port leaf, JAX leaf) by key name and list index."""
    if isinstance(t, dict):
        assert set(t) == set(j), (path, sorted(t), sorted(j))
        for k in t:
            yield from _pairs(t[k], j[k], f"{path}/{k}")
    elif isinstance(t, list):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            yield from _pairs(a, b, f"{path}/{i}")
    elif t is not None:
        yield path, t.detach().numpy(), np.asarray(j)


def _assert_grads(got, want):
    """Every leaf of the port's gradient tree against the JAX tree's, by
    name (see the module note for the tolerance)."""
    scale = max([1.0] + [float(np.abs(x).max())
                         for x in jax.tree.leaves(want)])
    n = 0
    for path, a, b in _pairs(got, want):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * scale, err_msg=path)
        n += 1
    assert n == len(jax.tree.leaves(want))


def _batch(jarch, shape, seed=0):
    """The inputs of ``tests/test_models_gnn.py::_batch_for``, as numpy."""
    rng = np.random.default_rng(seed)
    d = jarch._dims(shape)
    N, E, G = d["N"], d["E"], d["G"]
    out = {}
    for k, sd in jarch.abstract_inputs(shape).items():
        if sd.dtype == jnp.int32:
            hi = {"edges_src": N, "edges_dst": N, "graph_ids": G,
                  "labels_i": d.get("n_classes", 2),
                  "tri_kj": E, "tri_ji": E}.get(k, N)
            out[k] = rng.integers(0, hi, sd.shape).astype(np.int32)
        elif sd.dtype == jnp.bool_:
            out[k] = np.ones(sd.shape, bool)
        else:
            out[k] = rng.normal(0, 1, sd.shape).astype(np.float32)
    return out


def _graph(mod, b, E, G):
    pos = b.get("positions")
    conv = (lambda a: torch.from_numpy(np.array(a, copy=True))) \
        if mod is tcommon else jnp.asarray
    zeros = np.zeros if mod is tcommon else jnp.zeros
    return mod.GraphBatch(
        nodes=conv(b["nodes"]), edges_src=conv(b["edges_src"]),
        edges_dst=conv(b["edges_dst"]),
        edge_feat=conv(zeros((E, 1), np.float32)),
        node_mask=conv(b["node_mask"]), edge_mask=conv(b["edge_mask"]),
        graph_ids=conv(b["graph_ids"]), n_graphs=G,
        positions=conv(zeros((b["nodes"].shape[0], 3), np.float32)
                       if pos is None else pos),
        labels=conv(b["labels_f"]) if "labels_f" in b else None)


_REF: dict = {}


def _reference(aid, shape_name):
    """The JAX side of one pair, made once per module: params, batch,
    node_repr, energies, loss, gradients and the stepped params."""
    key = (aid, shape_name)
    if key in _REF:
        return _REF[key]
    jarch, tarch = _archs(aid)
    jshape = JShapeCell(shape_name, "train", TINY[shape_name])
    d = jarch._dims(jshape)
    b = _batch(jarch, jshape)
    jparams = jarch.init_params(jshape, jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    energy_fn = None
    if d["task"] == "energy" and aid != "graphcast":
        from repro.models.gnn import dimenet, egnn, mace
        cfg2 = jarch._shape_cfg(jshape)
        energy_fn = {
            "dimenet": lambda t, g, b: dimenet.forward(
                cfg2, t, g, b["tri_kj"], b["tri_ji"], b["tri_mask"]),
            "egnn": lambda t, g, b: egnn.forward(cfg2, t, g)[0],
            "mace": lambda t, g, b: mace.forward(cfg2, t, g)}[aid]

    @jax.jit
    def run(params, jb):
        # one compile a pair: node_repr, energies, loss and gradients
        g = _graph(jcommon, jb, d["E"], d["G"])
        h = jarch._node_repr_fn(jshape)(params["trunk"], g, jb)
        e = None if energy_fn is None else energy_fn(params["trunk"], g, jb)
        return h, e, jax.value_and_grad(jarch._loss(jshape))(params, jb)

    h, energy, (loss, grads) = run(jparams, jb)
    # the JAX registry's train step is value_and_grad then apply_update:
    # take the jitted gradients' update (an eager step costs ~10 s here)
    stepped = jax.jit(lambda p, g: jopt.apply_update(
        jarch.opt, p, g, jopt.init_opt_state(p))[0])(jparams, grads)
    _REF[key] = dict(
        tarch=tarch, shape=ShapeCell(shape_name, "train", TINY[shape_name]),
        dims=d, batch=b, params=_np_tree(jparams), h=np.asarray(h),
        energy=None if energy is None else np.asarray(energy),
        loss=float(loss), grads=_np_tree(grads), stepped=_np_tree(stepped))
    return _REF[key]


def _port(ref):
    params = gnn_params_from_numpy(ref["params"], ref["tarch"].kind,
                                   device="cpu")
    batch = {k: torch.from_numpy(np.array(v, copy=True))
             for k, v in ref["batch"].items()}
    return params, batch


@pytest.mark.parametrize("aid,shape_name", PAIRS)
def test_forward_and_loss_match(aid, shape_name):
    ref = _reference(aid, shape_name)
    tarch, shape, d = ref["tarch"], ref["shape"], ref["dims"]
    params, batch = _port(ref)
    g = _graph(tcommon, ref["batch"], d["E"], d["G"])
    with torch.no_grad():
        h = tarch._node_repr_fn(shape)(params["trunk"], g, batch)
        loss = tarch._loss(shape)(params, batch)
    assert h.shape == ref["h"].shape and h.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), ref["h"], **OUT_TOL)
    np.testing.assert_allclose(float(loss), ref["loss"], **OUT_TOL)
    if ref["energy"] is not None:
        from repro_torch.models.gnn import dimenet, egnn, mace
        cfg2 = tarch._shape_cfg(shape)
        with torch.no_grad():
            e = {"dimenet": lambda: dimenet.forward(
                     cfg2, params["trunk"], g, batch["tri_kj"],
                     batch["tri_ji"], batch["tri_mask"]),
                 "egnn": lambda: egnn.forward(cfg2, params["trunk"], g)[0],
                 "mace": lambda: mace.forward(cfg2, params["trunk"], g),
                 }[aid]()
        np.testing.assert_allclose(e.numpy(), ref["energy"], **OUT_TOL)


@pytest.mark.parametrize("aid,shape_name", PAIRS)
def test_gradients_match(aid, shape_name):
    """Every param leaf's gradient of the registry's loss, by name."""
    ref = _reference(aid, shape_name)
    params, batch = _port(ref)
    loss, grads = value_and_grad(ref["tarch"]._loss(ref["shape"]), params,
                                 batch)
    np.testing.assert_allclose(float(loss), ref["loss"], **OUT_TOL)
    _assert_grads(grads, ref["grads"])


@pytest.mark.parametrize("aid,shape_name", PAIRS)
def test_registry_adamw_step_matches(aid, shape_name):
    ref = _reference(aid, shape_name)
    params, batch = _port(ref)
    step = ref["tarch"].step_fn(ref["shape"])
    new, opt, metrics = step(params, topt.init_opt_state(params), **batch)
    assert int(opt.step) == 1
    np.testing.assert_allclose(float(metrics["loss"]), ref["loss"],
                               **OUT_TOL)
    for path, a, b in _pairs(new, ref["stepped"]):
        np.testing.assert_allclose(a, b, err_msg=path, **STEP_TOL)
    # positional inputs, in input_specs order, give the same step
    params2, _ = _port(ref)
    keys = list(ref["tarch"].input_specs(ref["shape"]))
    new2, _, _ = step(params2, topt.init_opt_state(params2),
                      *(batch[k] for k in keys))
    for (_, a, _), (_, b, _) in zip(_pairs(new2, ref["stepped"]),
                                    _pairs(new, ref["stepped"])):
        np.testing.assert_array_equal(a, b)


def _bf16_step(arch, shape, params, batch, dtype):
    """The loss and the gradients as float32 numpy trees of ``arch``'s
    registry loss run with ``compute_dtype = dtype``."""
    arch = dataclasses.replace(arch, compute_dtype=dtype)
    if isinstance(params, dict) and isinstance(batch["nodes"], np.ndarray):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        loss, grads = jax.jit(jax.value_and_grad(arch._loss(shape)))(
            params, jb)
        return float(loss), _np_tree(grads)
    loss, grads = value_and_grad(arch._loss(shape), params, batch)
    return float(loss), tree_map(lambda g: g.detach().float(), grads)


@pytest.mark.parametrize("aid", ["egnn", "dimenet"])
def test_bf16_compute_matches(aid):
    """``for_mesh``'s bf16 trunk (``compute_dtype``) against the JAX
    registry's ``_loss`` at ``jnp.bfloat16`` on the same params and
    inputs (the molecule cell, which sums energies and so keeps the
    rounding visible). The tolerance is half the distance bf16 moves the
    reference from its float32 result, on the loss and on the largest
    gradient entry: the port's bf16 run must land within it and its
    float32 run must not, so the test holds the bf16 path and no other.
    (MACE's cubic correlation products amplify bf16 rounding past that
    margin on some seeds, in the reference's own runs as in the port's;
    its promotion to float32 is held exactly below.)"""
    ref = _reference(aid, "molecule")
    jarch, _ = _archs(aid)
    jshape = JShapeCell("molecule", "train", TINY["molecule"])
    jparams = jax.tree.map(jnp.asarray, ref["params"])
    jl16, jg16 = _bf16_step(jarch, jshape, jparams, ref["batch"],
                            jnp.bfloat16)
    jl32, jg32 = ref["loss"], ref["grads"]
    loss_tol = 0.5 * abs(jl16 - jl32)
    grad_tol = 0.5 * max(float(np.abs(a - b).max()) for a, b in
                         zip(jax.tree.leaves(jg16), jax.tree.leaves(jg32)))

    def off(dtype):
        params, batch = _port(ref)
        loss, grads = _bf16_step(ref["tarch"], ref["shape"], params, batch,
                                 dtype)
        gerr = max(float(np.abs(a - b).max())
                   for _, a, b in _pairs(grads, jg16))
        return abs(loss - jl16), gerr

    l16, g16 = off(torch.bfloat16)
    assert l16 <= loss_tol and g16 <= grad_tol, (l16, loss_tol, g16,
                                                 grad_tol)
    l32, g32 = off(None)
    assert l32 > loss_tol and g32 > grad_tol, (l32, loss_tol, g32, grad_tol)


def test_mace_products_promote_as_reference():
    """``pairwise_products`` of bf16 irreps (and their products with the
    float32 results, as the correlation stack forms them) give each
    entry the dtype the reference's gives it: the float32 Levi-Civita
    contractions lift their products to float32."""
    from repro.models.gnn import mace as jmc

    rng = np.random.default_rng(0)
    shapes = {0: (4, 2), 1: (4, 2, 3), 2: (4, 2, 3, 3)}
    x = {l: rng.normal(size=s).astype(np.float32) for l, s in shapes.items()}
    j = {l: jnp.asarray(v, jnp.bfloat16) for l, v in x.items()}
    t = {l: torch.from_numpy(v).to(torch.bfloat16) for l, v in x.items()}
    jp, tp = jmc.pairwise_products(j, j), tmc.pairwise_products(t, t)
    j2 = {l: sum(v[:4]) for l, v in jp.items()}
    t2 = {l: sum(v[:4]) for l, v in tp.items()}
    for jo, to in ((jp, tp), (jmc.pairwise_products(j2, j),
                              tmc.pairwise_products(t2, t))):
        assert sorted(jo) == sorted(to)
        for l in jo:
            assert [str(a.dtype) for a in jo[l]] == \
                [str(a.dtype).replace("torch.", "") for a in to[l]], l
            for a, b in zip(jo[l], to[l]):
                np.testing.assert_allclose(b.float().numpy(),
                                           np.asarray(a, np.float32),
                                           rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("aid", GNN_IDS)
def test_registry_shapes_and_flops(aid):
    """``get_arch`` gives each GNN id; ``input_specs`` names, shapes and
    dtypes equal the reference's ``abstract_inputs``, and ``model_flops``
    its value, for every shape of ``GNN_SHAPES``."""
    tarch, jarch = get_arch(aid), JREGISTRY[aid]
    assert tarch.family == "gnn" and tarch.kind == jarch.kind
    assert list(GNN_SHAPES) == list(J_GNN_SHAPES)
    dt = {jnp.float32: torch.float32, jnp.int32: torch.int32,
          jnp.bool_: torch.bool}
    for name, shape in GNN_SHAPES.items():
        jshape = J_GNN_SHAPES[name]
        assert shape.dims == jshape.dims
        assert tarch.model_flops(shape) == jarch.model_flops(jshape), name
        specs = tarch.input_specs(shape)
        ins = jarch.abstract_inputs(jshape)
        assert list(specs) == list(ins), name
        for k, sd in ins.items():
            assert specs[k].shape == tuple(sd.shape), (name, k)
            assert specs[k].dtype == dt[sd.dtype.type], (name, k)


def test_icosphere_and_topology_identical():
    for r in range(3):
        tv, te = tcommon.icosphere(r)
        jv, je = jcommon.icosphere(r)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(te, je)
        assert len(tv) == 10 * 4 ** r + 2 and len(te) == 30 * 4 ** r
    cfg = tgc.GraphCastConfig(n_layers=2, d_hidden=16, mesh_refinement=2,
                              n_vars=5, grid_lat=7, grid_lon=10)
    jcfg = jgc.GraphCastConfig(**dataclasses.asdict(cfg))
    for seed in (0, 3):
        tt = tgc.build_topology(cfg, seed=seed, device="cpu")
        jt = jgc.build_topology(jcfg, seed=seed)
        for f in tt._fields:
            a, b = getattr(tt, f), np.asarray(getattr(jt, f))
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
            assert a.dtype == torch.int32
    assert len(tt.mesh_src) == cfg.n_mesh_edges == jcfg.n_mesh_edges


def test_graphcast_native_matches_at_weather_config():
    """The native encoder→processor→decoder ``forward`` and ``loss_fn``
    and every gradient leaf (``mesh_pos`` a None leaf in both trees) at
    the weather example's config."""
    cfg = tweather.CFG
    jcfg = jgc.GraphCastConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(7)
    x = rng.normal(size=(cfg.n_grid, cfg.n_vars)).astype(np.float32)
    y = rng.normal(size=(cfg.n_grid, cfg.n_vars)).astype(np.float32)
    jtopo = jgc.build_topology(jcfg, seed=0)
    jparams = jgc.init_params(jcfg, jax.random.PRNGKey(0))

    @jax.jit
    def run(p, x, y):
        return jgc.forward(jcfg, p, x, jtopo), jax.value_and_grad(
            lambda q: jgc.loss_fn(jcfg, q, x, y, jtopo))(p)

    want, (jloss, jgrads) = run(jparams, jnp.asarray(x), jnp.asarray(y))
    ttopo = tgc.build_topology(cfg, seed=0, device="cpu")
    params = gnn_params_from_numpy(_np_tree(jparams), "graphcast",
                                   device="cpu")
    assert params["mesh_pos"] is None
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        got = tgc.forward(cfg, params, tx, ttopo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    loss, grads = value_and_grad(
        lambda p: tgc.loss_fn(cfg, p, tx, ty, ttopo), params)
    np.testing.assert_allclose(float(loss), float(jloss), **OUT_TOL)
    assert grads["mesh_pos"] is None
    _assert_grads(grads, _np_tree(jgrads))


def test_params_carried_by_name():
    """The JAX tree's sorted keys come back in the port's order; a
    missing key raises."""
    jarch, tarch = _archs("egnn")
    shape = ShapeCell("molecule", "train", TINY["molecule"])
    tree = _np_tree(jarch.init_params(JShapeCell(
        "molecule", "train", TINY["molecule"]), jax.random.PRNGKey(0)))
    params = gnn_params_from_numpy(tree, "egnn", device="cpu")
    mine = tarch.init_params(shape, torch.Generator().manual_seed(0))
    assert list(params["trunk"]) == list(mine["trunk"]) == \
        ["embed", "layers", "readout"]
    assert list(params["trunk"]["layers"][0]) == ["phi_e", "phi_x", "phi_h"]
    assert tree_map(lambda a: a.shape, params) == \
        tree_map(lambda a: a.shape, mine)
    del tree["trunk"]["readout"]
    with pytest.raises(KeyError, match="readout"):
        gnn_params_from_numpy(tree, "egnn", device="cpu")


# --- physical properties, in the port alone -------------------------------

def _rand_graph(seed, n=10, e=24, d_feat=6):
    gen = torch.Generator().manual_seed(seed)
    return tcommon.GraphBatch(
        nodes=torch.randn((n, d_feat), generator=gen),
        edges_src=torch.randint(0, n, (e,), generator=gen, dtype=torch.int32),
        edges_dst=torch.randint(0, n, (e,), generator=gen, dtype=torch.int32),
        edge_feat=torch.zeros((e, 1)),
        node_mask=torch.ones(n, dtype=torch.bool),
        edge_mask=torch.ones(e, dtype=torch.bool),
        graph_ids=torch.zeros(n, dtype=torch.int32), n_graphs=1,
        positions=torch.randn((n, 3), generator=gen))


def _rotation(seed):
    M = torch.randn((3, 3), generator=torch.Generator().manual_seed(seed),
                    dtype=torch.float64)
    Q, R = torch.linalg.qr(M)
    return (Q * torch.sign(torch.diagonal(R))[None, :]).float()


@pytest.mark.parametrize("model", ["egnn", "mace"])
def test_energy_e3_invariant(model):
    g = _rand_graph(0)
    R = _rotation(1)
    t = torch.tensor([1.5, -2.0, 0.3])
    g_rot = g._replace(positions=g.positions @ R.T + t)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        if model == "egnn":
            cfg = teg.EGNNConfig(n_layers=2, d_hidden=16, d_in=6)
            params = teg.init_params(cfg, gen)
            e1, e2 = (teg.forward(cfg, params, x)[0] for x in (g, g_rot))
        else:
            cfg = tmc.MACEConfig(n_layers=1, d_hidden=8, l_max=2,
                                 correlation=2, n_rbf=4, d_in=6)
            params = tmc.init_params(cfg, gen)
            e1, e2 = (tmc.forward(cfg, params, x) for x in (g, g_rot))
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=2e-4, atol=2e-4)


def test_egnn_coordinates_equivariant():
    g = _rand_graph(3)
    R = _rotation(4)
    cfg = teg.EGNNConfig(n_layers=2, d_hidden=16, d_in=6)
    params = teg.init_params(cfg, torch.Generator().manual_seed(5))
    with torch.no_grad():
        x1 = teg.forward(cfg, params, g)[2]
        g_rot = g._replace(positions=g.positions @ R.T)
        x2 = teg.forward(cfg, params, g_rot)[2]
    np.testing.assert_allclose((x1 @ R.T).numpy(), x2.numpy(), atol=1e-3)


def test_edge_mask_blocks_messages():
    """Masked edges contribute nothing, in EGNN and in the GraphCast
    processor: zeroing the mask on some edges == removing them."""
    g = _rand_graph(6, n=8, e=16)
    cfg = teg.EGNNConfig(n_layers=1, d_hidden=8, d_in=6)
    params = teg.init_params(cfg, torch.Generator().manual_seed(7))
    mask = g.edge_mask.clone()
    mask[8:] = False
    cut = g._replace(edges_src=g.edges_src[:8], edges_dst=g.edges_dst[:8],
                     edge_feat=g.edge_feat[:8], edge_mask=mask[:8])
    with torch.no_grad():
        e1 = teg.forward(cfg, params, g._replace(edge_mask=mask))[0]
        e2 = teg.forward(cfg, params, cut)[0]
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), atol=1e-4)
    gcfg = tgc.GraphCastConfig(n_layers=2, d_hidden=8)
    p = tgc.init_processor_params(gcfg, torch.Generator().manual_seed(8), 6)
    with torch.no_grad():
        h1 = tgc.processor_node_repr(gcfg, p, g.nodes, g.edges_src,
                                     g.edges_dst, edge_mask=mask)
        h2 = tgc.processor_node_repr(gcfg, p, g.nodes, cut.edges_src,
                                     cut.edges_dst, edge_mask=mask[:8])
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=1e-4)


def test_synthetic_graph_batches():
    """The molecule and node-classification batches: deterministic in
    (seed, step), the reference's structure (edges inside a molecule,
    self loops masked, labels in range)."""
    from repro_torch.data import synthetic
    a = synthetic.molecule_train_batch(2, 4, 8, 16, 5, device="cpu")
    b = synthetic.molecule_train_batch(2, 4, 8, 16, 5, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b)
               if isinstance(x, torch.Tensor))
    assert a.nodes.shape == (32, 5) and a.n_graphs == 4
    mol = torch.arange(64) // 16
    assert torch.equal(a.edges_src.long() // 8, mol)
    assert torch.equal(a.edges_dst.long() // 8, mol)
    assert torch.equal(a.edge_mask, a.edges_src != a.edges_dst)
    c = synthetic.node_classification_batch(0, 50, 200, 7, n_classes=3,
                                            device="cpu")
    assert c.labels.dtype == torch.int32 and int(c.labels.max()) < 3
    assert c.positions is None and int(c.edges_src.max()) < 50


def test_examples_run_on_the_cpu():
    """Both examples at ``--device cpu``: the weather MSE falls over 30
    steps and its rollout runs; ``gnn_multicut`` trains its EGNN for its
    60 steps and its own assert holds (RAMA's agreement with the planted
    clusters at least threshold-plus-CC's less 0.02)."""
    from repro_torch.examples import gnn_multicut
    hist = tweather.main(["--device", "cpu", "--steps", "30"])
    assert hist[-1]["loss"] < hist[0]["loss"]
    out = gnn_multicut.main(["--device", "cpu"])
    assert len(out["losses"]) == gnn_multicut.STEPS
    assert out["losses"][-1] < out["losses"][0]
    assert out["acc_rama"] >= out["acc_thr"] - 0.02
    res = out["result"]
    assert res.labels.device.type == "cpu"
    assert float(res.lower_bound) <= float(res.objective) + 1e-3
