"""The port's wide-deep recommender (``repro_torch.models.recsys``, the
registry's ``wide-deep`` arch, its batch and the recsys branch of
``launch/train.py``) against the JAX package's, on the CPU, on the same
params (the JAX ``init_params`` tree through
``convert.recsys_params_from_numpy``) and the same numpy batch.

Tolerances. ``forward`` and ``loss_fn``: rtol 1e-5 (atol 1e-6). The
gradient of every leaf: rtol 1e-4 with atol 1e-5 x the largest |gradient|
of the tree (the tables' gradients are dense and zero on every row no
bag touched, in both packages). Retrieval: the scores within rtol 1e-5
/ atol 1e-5 (a 64-long dot per candidate of size ~10 that the two
frameworks sum in other orders: ~0.4 % of scores differ by an ulp or
two), the top 128 through the registry's step equal to
``jax.lax.top_k`` of the same scores in values exactly, and in indices
exactly where the values are distinct (``torch.topk`` does not promise
the lower index on a tie).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs  # noqa: E402,F401  (registers the JAX archs)
from repro.configs.base import RECSYS_SHAPES as J_RECSYS_SHAPES  # noqa: E402
from repro.configs.base import REGISTRY as JREGISTRY  # noqa: E402
from repro.models import recsys as jrs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import RECSYS_SHAPES  # noqa: E402
from repro_torch.convert import recsys_params_from_numpy  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import recsys as trs  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.loop import value_and_grad  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs():
    j = dataclasses.replace(JREGISTRY["wide-deep"].cfg, vocab_per_field=100,
                            mlp_dims=(32, 16))
    t = dataclasses.replace(get_arch("wide-deep").cfg, vocab_per_field=100,
                            mlp_dims=(32, 16))
    return j, t


def _batch(cfg, B=8, seed=0, bag=1):
    rng = np.random.default_rng(seed)
    si = rng.integers(0, cfg.vocab_per_field,
                      (B, cfg.n_sparse, bag)).astype(np.int32)
    df = rng.normal(0, 1, (B, cfg.n_dense)).astype(np.float32)
    lab = rng.integers(0, 2, (B,)).astype(np.float32)
    mask = rng.random((B, cfg.n_sparse, bag)) < 0.7
    return si, df, lab, mask


def _t(*arrs):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrs]


@pytest.fixture(scope="module")
def ref():
    """The JAX side, made once: params, forward and loss (with and without
    a multi-hot mask), gradients."""
    jcfg, tcfg = _cfgs()
    jp = jrs.init_params(jcfg, jax.random.PRNGKey(0))
    si, df, lab, _ = _batch(jcfg)
    si3, df3, lab3, m3 = _batch(jcfg, seed=1, bag=3)
    jcfg3 = dataclasses.replace(jcfg, multi_hot=3)
    loss, grads = jax.value_and_grad(
        lambda p: jrs.loss_fn(jcfg, p, si, df, lab))(jp)
    return dict(
        jcfg=jcfg, tcfg=tcfg, params=jax.tree.map(np.asarray, jp),
        batch=(si, df, lab), batch3=(si3, df3, lab3, m3),
        logits=np.asarray(jrs.forward(jcfg, jp, si, df)),
        logits3=np.asarray(jrs.forward(jcfg3, jp, si3, df3, m3)),
        loss3=float(jrs.loss_fn(jcfg3, jp, si3, df3, lab3, m3)),
        loss=float(loss), grads=jax.tree.map(np.asarray, grads))


def _params(ref):
    return recsys_params_from_numpy(ref["params"], device="cpu")


def test_forward_and_loss_match(ref):
    p, cfg = _params(ref), ref["tcfg"]
    si, df, lab = _t(*ref["batch"])
    with torch.no_grad():
        logits = trs.forward(cfg, p, si, df)
        loss = trs.loss_fn(cfg, p, si, df, lab)
    assert logits.shape == (8,) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), ref["logits"], **TOL)
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL)
    # multi-hot bags of 3 with a validity mask
    cfg3 = dataclasses.replace(cfg, multi_hot=3)
    si3, df3, lab3, m3 = _t(*ref["batch3"])
    with torch.no_grad():
        np.testing.assert_allclose(
            trs.forward(cfg3, p, si3, df3, m3).numpy(), ref["logits3"],
            **TOL)
        np.testing.assert_allclose(
            float(trs.loss_fn(cfg3, p, si3, df3, lab3, m3)), ref["loss3"],
            **TOL)


def test_gradients_match(ref):
    p, cfg = _params(ref), ref["tcfg"]
    si, df, lab = _t(*ref["batch"])
    loss, grads = value_and_grad(
        lambda q: trs.loss_fn(cfg, q, si, df, lab), p)
    np.testing.assert_allclose(float(loss), ref["loss"], **TOL)
    want = ref["grads"]
    scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(want))
    got = {k: grads[k] for k in ("tables", "wide_tables", "wide_dense",
                                 "bias")}
    for k, g in got.items():
        assert g.layout == torch.strided and g.shape == want[k].shape, k
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_REL * scale, err_msg=k)
    for k in ("mlp_w", "mlp_b"):
        assert len(grads[k]) == len(want[k]) == 3
        for i, (a, b) in enumerate(zip(grads[k], want[k])):
            np.testing.assert_allclose(a.numpy(), b, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_REL * scale,
                                       err_msg=f"{k}/{i}")
    # the table gradient is dense: zero on rows no bag touched
    touched = np.zeros((cfg.n_sparse, cfg.vocab_per_field), bool)
    si_np = ref["batch"][0]
    touched[np.arange(cfg.n_sparse)[None, :], si_np[:, :, 0]] = True
    assert not grads["tables"].numpy()[~touched].any()


def test_train_steps_lower_the_loss(ref):
    """20 steps of the registry's train step on a fixed batch (AdamW,
    lr 1e-2, no warm-up, no decay) lower the BCE loss."""
    p, cfg = _params(ref), ref["tcfg"]
    arch = dataclasses.replace(get_arch("wide-deep"), cfg=cfg,
                               opt=topt.OptimizerConfig(lr=1e-2,
                                                        warmup_steps=0,
                                                        weight_decay=0.0))
    step = arch.step_fn(RECSYS_SHAPES["train_batch"])
    si, df, lab = _t(*ref["batch"])
    opt = topt.init_opt_state(p)
    losses = []
    for _ in range(20):
        p, opt, m = step(p, opt, si, df, lab)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[0], ref["loss"], **TOL)
    with torch.no_grad():
        after = float(trs.loss_fn(cfg, p, si, df, lab))
    assert after < losses[0] and int(opt.step) == 20


@pytest.mark.parametrize("n", [1000, 4099])
def test_retrieval_top128_matches(n):
    rng = np.random.default_rng(n)
    q = rng.normal(0, 1, (64,)).astype(np.float32)
    cands = rng.normal(0, 1, (n, 64)).astype(np.float32)
    jscores = jrs.retrieval_score(jnp.asarray(q), jnp.asarray(cands))
    jv, ji = jax.lax.top_k(jscores, 128)
    tq, tc = _t(q, cands)
    np.testing.assert_allclose(trs.retrieval_score(tq, tc).numpy(),
                               np.asarray(jscores), **SCORE_TOL)
    step = get_arch("wide-deep").step_fn(RECSYS_SHAPES["retrieval_cand"])
    tv, ti = step(tq, tc)
    assert ti.dtype == torch.int32 and tv.shape == (128,)
    # the port's scores through both top-k: values exactly, indices where
    # the values are distinct
    scores = trs.retrieval_score(tq, tc)
    jv2, ji2 = jax.lax.top_k(jnp.asarray(scores.numpy()), 128)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv2))
    jv2 = np.asarray(jv2)
    distinct = (np.diff(jv2, prepend=np.inf) != 0) \
        & (np.diff(jv2, append=-np.inf) != 0)
    np.testing.assert_array_equal(ti.numpy()[distinct],
                                  np.asarray(ji2)[distinct])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **SCORE_TOL)


def test_retrieval_top_k_ties_keep_values():
    """Exact ties: the values equal ``jax.lax.top_k``'s, and the tied
    indices form the same set."""
    scores = np.repeat(np.arange(100, dtype=np.float32), 3)[::-1].copy()
    vals, idx = torch.topk(torch.from_numpy(scores), 128)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 128)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    for v in np.unique(np.asarray(jv)):
        tsel, jsel = vals.numpy() == v, np.asarray(jv) == v
        if tsel.sum() == 3:          # a whole tie group inside the top 128
            assert set(idx.numpy()[tsel]) == set(np.asarray(ji)[jsel])


def test_wide_path_contributes(ref):
    """Zeroing the deep MLP leaves the wide linear path active."""
    p, cfg = _params(ref), ref["tcfg"]
    p["mlp_w"] = [w * 0 for w in p["mlp_w"]]
    p["mlp_b"] = [b * 0 for b in p["mlp_b"]]
    si, df, _ = _t(*ref["batch"])
    with torch.no_grad():
        logit = trs.forward(cfg, p, si, df)
    assert float(logit.abs().max()) > 0, "wide path dead"


def test_registry_shapes_and_flops():
    """``get_arch("wide-deep")``: ``input_specs`` equal to the reference's
    ``abstract_inputs`` and ``model_flops`` to its value, for every shape
    of ``RECSYS_SHAPES``."""
    tarch, jarch = get_arch("wide-deep"), JREGISTRY["wide-deep"]
    assert tarch.family == "recsys" and tarch.cfg.n_sparse == 40
    assert list(RECSYS_SHAPES) == list(J_RECSYS_SHAPES)
    dt = {jnp.float32: torch.float32, jnp.int32: torch.int32}
    for name, shape in RECSYS_SHAPES.items():
        jshape = J_RECSYS_SHAPES[name]
        assert shape.dims == jshape.dims and shape.kind == jshape.kind
        assert tarch.model_flops(shape) == jarch.model_flops(jshape), name
        specs, ins = tarch.input_specs(shape), jarch.abstract_inputs(jshape)
        assert list(specs) == list(ins), name
        for k, sd in ins.items():
            assert specs[k].shape == tuple(sd.shape), (name, k)
            assert specs[k].dtype == dt[sd.dtype.type], (name, k)
    assert tarch.input_specs(RECSYS_SHAPES["retrieval_cand"])[
        "cands"].shape == (1_000_448, 64)


def test_recsys_batch_is_deterministic():
    a = synthetic.recsys_batch(3, 16, 40, 500, device="cpu")
    b = synthetic.recsys_batch(3, 16, 40, 500, device="cpu")
    c = synthetic.recsys_batch(4, 16, 40, 500, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["sparse_idx"], c["sparse_idx"])
    assert a["sparse_idx"].shape == (16, 40, 1)
    assert a["sparse_idx"].dtype == torch.int32
    assert int(a["sparse_idx"].min()) >= 0 and int(a["sparse_idx"].max()) < 500
    assert set(a["labels"].unique().tolist()) <= {0.0, 1.0}


def test_launch_train_wide_deep(tmp_path):
    """``launch/train.py --arch wide-deep --reduce 8`` on the CPU runs;
    with ``--ckpt-dir`` a rerun resumes from the checkpoint and its steps
    equal a straight run's. At lr 1e-2 and batch 64 (``--reduce 16``) the
    loss falls: the mean of the last three logged losses below the first
    three's (each step draws a new batch, so single steps are noisy)."""
    argv = ["--arch", "wide-deep", "--reduce", "8", "--steps", "6",
            "--batch", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    straight = tlaunch.main(argv)
    assert [h["step"] for h in straight] == list(range(6))
    assert all(np.isfinite(h["loss"]) for h in straight)
    # drop the last checkpoint: the rerun resumes from step 4
    for ext in (".npz", ".json"):
        (tmp_path / f"step_6{ext}").unlink(missing_ok=True)
    again = tlaunch.main(argv)
    assert [h["step"] for h in again] == [4, 5]
    assert [h["loss"] for h in again] == [h["loss"] for h in straight[4:]]
    learn = tlaunch.main(["--arch", "wide-deep", "--reduce", "16",
                          "--steps", "20", "--batch", "64", "--lr", "1e-2",
                          "--device", "cpu"])
    losses = [h["loss"] for h in learn]
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
