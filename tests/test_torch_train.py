"""The port's training path against the JAX package's, on the CPU, on the
same numpy inputs: ``loss_fn`` value and gradients
(``jax.value_and_grad`` against ``torch.autograd``), the trainable flash
op's gradients against JAX ``flash_attention_trainable`` (off the TPU the
chunked attention with ``jax.checkpoint`` chunks), the optimizer, int8
error-feedback compression, checkpoints (a JAX-written one loads in the
port), the registry's train step with gradient accumulation, ``train``'s
bit-exact resume, ``data/synthetic.py::lm_batch`` and
``launch/train.py``.

Tolerances. Loss values: rtol 1e-5. Gradients: rtol 1e-4 with atol 1e-5
x the largest |gradient| of the tree (largest seen 3e-8 absolute on
gradients of size ~0.01-0.07; llama4's router gradient is zero up to
rounding, ~4e-9, in both packages, so the atol is relative to the tree).
Optimizer: float32 rtol 1e-5 (the port's AdamW is the JAX expression op
for op; XLA may fuse into FMAs), moments atol 1e-7 (values ~0.1-1 after
rounding differences compound over five steps); bf16 state (grok-1's
posture): two bf16 ulps (2^-6 relative, and of the leaf's largest value
near zero: XLA may round a fused update once where torch rounds each op;
largest seen two ulps). Compression: int8 codes
exactly equal, float results rtol 1e-6. Attention gradients: f32 rtol
1e-4 / atol 1e-5 (the two frameworks sum the chunked einsums' gradients
in different orders), bf16 rtol 2e-2 / atol 2e-2, about two bf16 ulps
(one ulp is 2^-7 relative; largest seen one ulp, 0.031 at 4.2).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs  # noqa: E402,F401  (registers the JAX archs)
from repro.configs.base import REGISTRY as JREGISTRY  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import LM_SHAPES  # noqa: E402
from repro_torch.convert import transformer_params_from_numpy  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.flash_attention import chunked as tchunked  # noqa: E402,E501
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.loop import (  # noqa: E402
    TrainConfig, train, value_and_grad,
)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SHARED = [f.name for f in dataclasses.fields(ttfm.TransformerConfig)]
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5


def _reduced(aid, **kw):
    cfg = JREGISTRY[aid].cfg
    kw.setdefault("remat", False)
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=16, d_ff=128, vocab=256,
        act_sharding=None, local_window=5,
        n_experts=min(cfg.n_experts, 4) if cfg.moe else 0,
        dtype=jnp.float32, param_dtype=jnp.float32, **kw)


def _port_cfg(jcfg):
    kw = {f: getattr(jcfg, f) for f in SHARED}
    kw["dtype"] = T_DTYPE[jcfg.dtype]
    kw["param_dtype"] = T_DTYPE[jcfg.param_dtype]
    return ttfm.TransformerConfig(**kw)


def _masters(jcfg, jp):
    return transformer_params_from_numpy(
        jax.tree.map(np.asarray, jp), _port_cfg(jcfg), device="cpu",
        masters=True)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _grads_close(tg, jg):
    """Each port gradient leaf within GRAD_RTOL of JAX's, atol relative to
    the largest |gradient| of the tree."""
    top = max(float(np.abs(_np(g)).max()) for g in jax.tree.leaves(jg))
    for k in jg:
        if k == "layers":
            for kk in jg[k]:
                np.testing.assert_allclose(
                    _np(tg[k][kk]), _np(jg[k][kk]), rtol=GRAD_RTOL,
                    atol=GRAD_ATOL_REL * top, err_msg=kk)
        else:
            np.testing.assert_allclose(_np(tg[k]), _np(jg[k]),
                                       rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL_REL * top, err_msg=k)


# (arch, S, chunk): chunked over S (4 chunks, each recomputed), one chunk
# (S <= chunk), and the ragged one-shot fallback (S not a multiple)
LOSS_CASES = {
    "gemma2-chunked": ("gemma2-9b", 32, 8),
    "gemma2-one-chunk": ("gemma2-9b", 12, 16),
    "gemma2-ragged": ("gemma2-9b", 20, 8),
    "grok-chunked": ("grok-1-314b", 24, 8),
    "llama4-ragged": ("llama4-scout-17b-a16e", 20, 8),
}


@pytest.mark.parametrize("case", LOSS_CASES)
@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
def test_loss_value_and_grads_match_jax(case, remat):
    """``loss_fn`` (final softcap, gemma2's window and attention softcap,
    MoE) and its gradients w.r.t. every master weight."""
    aid, S, chunk = LOSS_CASES[case]
    jcfg = _reduced(aid, remat=remat)
    tcfg = _port_cfg(jcfg)
    assert tcfg.use_flash and tcfg.remat == remat
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _masters(jcfg, jp)
    tok, tgt = _tokens(2, S, 256, 1), _tokens(2, S, 256, 2)
    jl, jg = jax.value_and_grad(
        lambda p: jtfm.loss_fn(jcfg, p, tok, tgt, chunk=chunk))(jp)
    tl, tg = value_and_grad(
        lambda p: ttfm.loss_fn(tcfg, p, torch.from_numpy(tok),
                               torch.from_numpy(tgt), chunk=chunk), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _grads_close(tg, jg)
    with torch.no_grad():
        again = ttfm.loss_fn(tcfg, tp, torch.from_numpy(tok),
                             torch.from_numpy(tgt), chunk=chunk)
    assert torch.equal(again, tl)


def test_remat_gives_the_same_bits():
    """``cfg.remat`` recomputes each layer in backward: the loss and every
    gradient equal the run without it bit for bit."""
    jcfg = _reduced("gemma2-9b")
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _masters(jcfg, jp)
    tok, tgt = (torch.from_numpy(_tokens(2, 16, 256, s)) for s in (3, 4))
    runs = [value_and_grad(lambda p: ttfm.loss_fn(
        dataclasses.replace(_port_cfg(jcfg), remat=r), p, tok, tgt,
        chunk=8), tp) for r in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)


# (B, Hq, Hkv, S, D, window, softcap)
ATTN_CASES = {
    "gqa_softcap": (1, 4, 2, 24, 16, None, 5.0),
    "window": (2, 4, 4, 20, 16, 7, None),
    "mqa_ragged_chunks": (1, 6, 1, 37, 32, 11, 20.0),
}


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_trainable_flash_grads_match_jax(case, dtype):
    """``flash_attention_trainable`` (forward on the CPU tensor's route,
    the chunked recompute as backward, query chunks of 8 here so several
    chunks run) against the JAX op's gradients; both backends give the
    same bits."""
    B, Hq, Hkv, S, D, window, softcap = ATTN_CASES[case]
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(S)
    q, k, v, g = (rng.normal(size=(B, h, S, D)).astype(np.float32)
                  for h in (Hq, Hkv, Hkv, Hq))
    kw = dict(causal=True, window=window, softcap=softcap)
    _, vjp = jax.vjp(lambda a, b, c: jops.flash_attention_trainable(
        a, b, c, block_q=8, **kw), *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    got = {}
    for backend in ("cuda", "reference"):
        leaves = [torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v)]
        out = tops.flash_attention_trainable(*leaves, backend=backend,
                                             block_q=8, **kw)
        got[backend] = torch.autograd.grad(
            out, leaves, torch.from_numpy(g).to(tdt))
    for a, b in zip(got["cuda"], got["reference"]):
        assert torch.equal(a, b)
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "f32" else \
        dict(rtol=2e-2, atol=2e-2)
    for t, j in zip(got["cuda"], want):
        np.testing.assert_allclose(_np(t), _np(j), **tol)


def test_trainable_flash_backward_recomputes_one_chunk_at_a_time(
        monkeypatch):
    """The backward runs the chunk function under checkpoint, in query
    chunks of ``block_q``: every chunk once to build the output and once
    more when its gradient is taken, each call on its own rows only, so no
    more than one chunk's score tile is kept alive."""
    calls = []
    orig = tchunked._chunk

    def counted(qc, kf, vf, q0, *a):
        calls.append((q0, qc.shape[3], torch.is_grad_enabled()))
        return orig(qc, kf, vf, q0, *a)

    monkeypatch.setattr(tchunked, "_chunk", counted)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 20, 16)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    out = tops.flash_attention_trainable(q, k, v, block_q=8)
    # the forward is the wrapper's plain version, at its own block of 512
    assert calls == [(0, 20, False)]
    calls.clear()
    out.sum().backward()
    assert sorted(c[:2] for c in calls) == sorted(
        [(0, 8), (8, 8), (16, 4)] * 2)


def test_flash_attention_names_the_trainable_op():
    q = torch.zeros((1, 2, 8, 16), requires_grad=True)
    k = torch.zeros((1, 1, 8, 16))
    with pytest.raises(NotImplementedError,
                       match="flash_attention_trainable"):
        tops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="unknown backend"):
        tops.flash_attention_trainable(q, k, k, backend="pallas")


# ---------------------------------------------------------------------------
# optimizer, compression
# ---------------------------------------------------------------------------

OPT_CASES = {
    "adamw_cosine_clip": dict(kind="adamw", lr=1e-2, warmup_steps=2,
                              total_steps=6, schedule="cosine",
                              grad_clip=0.5),
    "adamw_linear_noclip": dict(kind="adamw", lr=3e-3, warmup_steps=1,
                                total_steps=4, schedule="linear",
                                grad_clip=0.0, weight_decay=0.0),
    "adamw_constant": dict(kind="adamw", lr=1e-3, warmup_steps=0,
                           schedule="constant", grad_clip=10.0),
    "sgd_cosine_clip": dict(kind="sgd", lr=5e-2, warmup_steps=2,
                            total_steps=5, grad_clip=1.0),
}


def _opt_tree(rng):
    return {"w": rng.normal(size=(5, 7)).astype(np.float32),
            "layers": {"a": rng.normal(size=(3,)).astype(np.float32),
                       "b": rng.normal(size=(2, 2, 3)).astype(np.float32)}}


@pytest.mark.parametrize("case", OPT_CASES)
def test_apply_update_matches_jax(case):
    """Five steps of ``apply_update`` on the same params and gradients:
    params, moments, step, lr and grad norm; the schedule alone at every
    step from 0 to past ``total_steps``."""
    jcfg = jopt.OptimizerConfig(**OPT_CASES[case])
    tcfg = topt.OptimizerConfig(**OPT_CASES[case])
    rng = np.random.default_rng(1)
    p = _opt_tree(rng)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()), p)
    js, ts = jopt.init_opt_state(jp), topt.init_opt_state(tp)
    for _ in range(5):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32) * 3.0, p)
        jp, js, jm = jopt.apply_update(jcfg, jp, jax.tree.map(jnp.asarray,
                                                             g), js)
        tp, ts, tm = topt.apply_update(tcfg, tp, jax.tree.map(
            torch.from_numpy, g), ts)
        assert int(ts.step) == int(js.step)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)
        for a, b in zip(tree_leaves(ts.mu) + tree_leaves(ts.nu),
                        jax.tree.leaves(js.mu) + jax.tree.leaves(js.nu)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)
    for s in range(0, 9):
        np.testing.assert_allclose(
            float(topt.schedule_lr(tcfg, torch.tensor(s, dtype=torch.int32))),
            float(jopt.schedule_lr(jcfg, jnp.int32(s))), rtol=1e-6)


def test_adamw_bf16_state_matches_jax():
    """grok-1's posture: bf16 params and bf16 moments, updated in bf16:
    within two bf16 ulps (2^-6 relative) of JAX's, of the leaf's largest
    value where a moment nears zero."""
    cfg = dict(lr=1e-2, warmup_steps=0, schedule="constant", grad_clip=1.0)
    rng = np.random.default_rng(2)
    p = _opt_tree(rng)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p)
    tp = jax.tree.map(lambda x: torch.from_numpy(x.copy()).bfloat16(), p)
    js = jopt.init_opt_state(jp, state_dtype=jnp.bfloat16)
    ts = topt.init_opt_state(tp, state_dtype=torch.bfloat16)
    for _ in range(3):
        g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), p)
        jp, js, _ = jopt.apply_update(
            jopt.OptimizerConfig(**cfg), jp,
            jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g), js)
        tp, ts, _ = topt.apply_update(
            topt.OptimizerConfig(**cfg), tp,
            jax.tree.map(lambda x: torch.from_numpy(x).bfloat16(), g), ts)
    for a, b in zip(tree_leaves(tp) + tree_leaves(ts.mu),
                    jax.tree.leaves(jp) + jax.tree.leaves(js.mu)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(a), _np(b), rtol=2 ** -6,
                                   atol=2 ** -6 * np.abs(_np(b)).max())


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(4)
    g = _opt_tree(rng)
    for max_norm in (0.5, 0.0, 1e6):
        jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                          max_norm)
        tc, tn = topt.clip_by_global_norm(
            jax.tree.map(torch.from_numpy, g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)


def test_fake_quantize_ef_matches_jax():
    """Three error-feedback steps: the int8 codes and scales of every leaf
    exactly equal, the dequantised grads and residuals within 1e-6;
    exact halves (g = k + 0.5 at scale 1) round to even in both."""
    rng = np.random.default_rng(5)
    g = _opt_tree(rng)
    halves = (np.arange(-127, 128, dtype=np.float32) + 0.5)
    halves[-1] = 127.0                       # max |g| = 127 sets scale 1
    g["halves"] = halves
    je = jcomp.init_error_buffers(jax.tree.map(jnp.asarray, g))
    te = tcomp.init_error_buffers(jax.tree.map(torch.from_numpy, g))
    for _ in range(3):
        for a in jax.tree.leaves(g):
            jq, js = jcomp.quantize_leaf(jnp.asarray(a))
            tq, tsc = tcomp.quantize_leaf(torch.from_numpy(a))
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            assert float(tsc) == float(js)
        jg, je = jcomp.fake_quantize_ef(jax.tree.map(jnp.asarray, g), je)
        tg, te = tcomp.fake_quantize_ef(jax.tree.map(torch.from_numpy, g),
                                        te)
        for a, b in zip(tree_leaves(tg) + tree_leaves(te),
                        jax.tree.leaves(jg) + jax.tree.leaves(je)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
        g = jax.tree.map(lambda x: x * 0.7, g)


# ---------------------------------------------------------------------------
# checkpoints, the train step, the loop
# ---------------------------------------------------------------------------

def _train_tree(params):
    return {"params": params, "opt": jopt.init_opt_state(params),
            "err": jax.tree.map(lambda x: jnp.zeros((), x.dtype), params)}


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """A checkpoint the JAX package writes (params, OptState, EF buffers,
    metadata) loads in the port into a template of tensors, bit for bit;
    the port's own write of the same tree loads in JAX bit for bit."""
    jcfg = _reduced("grok-1-314b")
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tree = _train_tree(jp)
    tree["opt"] = tree["opt"]._replace(
        step=jnp.int32(7), mu=jax.tree.map(lambda x: x * 0.5, jp))
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, tree, metadata={"a": 1})
    tp = _masters(jcfg, jp)
    tmpl = {"params": tree_map(torch.zeros_like, tp),
            "opt": topt.init_opt_state(tp),
            "err": tree_map(lambda x: torch.zeros((), dtype=x.dtype), tp)}
    loaded, info = tckpt.load_checkpoint(str(tmp_path / "j"), tmpl)
    assert info == {"step": 7, "metadata": {"a": 1}}
    got = tckpt.restore(loaded, tmpl)
    assert isinstance(got["opt"], topt.OptState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 7
    want = jckpt._flatten(tree)
    mine = tckpt._flatten(got)
    assert set(mine) == set(want)
    for k in want:
        assert mine[k].dtype == want[k].dtype
        np.testing.assert_array_equal(mine[k], want[k])
    tckpt.save_checkpoint(str(tmp_path / "t"), 3, got, keep=1)
    back, jinfo = jckpt.load_checkpoint(str(tmp_path / "t"), tree)
    assert jinfo["step"] == 3
    for k, a in jckpt._flatten(back).items():
        np.testing.assert_array_equal(a, want[k])


def test_async_save_copies_before_returning(tmp_path):
    """``save_checkpoint_async`` holds host copies when it returns: an
    in-place update right after it does not reach the file; bf16 leaves
    come back exactly; retention keeps the newest ``keep``."""
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "h": torch.linspace(-1, 1, 5).bfloat16()}
    want = tree_map(torch.clone, tree)
    t = tckpt.save_checkpoint_async(str(tmp_path), 1, tree, keep=2)
    tree["w"].add_(100.0)
    tree["h"].mul_(0)
    t.join()
    for s in (2, 3):
        tckpt.save_checkpoint(str(tmp_path), s, want, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_2.npz", "step_3.npz"]
    assert tckpt.latest_step(str(tmp_path)) == 3
    t = tckpt.save_checkpoint_async(str(tmp_path), 4, tree, keep=5)
    t.join()
    got = tckpt.restore(tckpt.load_checkpoint(str(tmp_path), want, 3)[0],
                        tree)
    assert got["h"].dtype == torch.bfloat16
    for k in tree:
        assert torch.equal(got[k], want[k])


def test_registry_train_step_matches_jax():
    """One registry train step of reduced gemma2 (window, softcaps) in
    float32 with ``grad_accum = 2`` over a batch of 4 against JAX's: the
    loss, the updated master weights and moments; a second step keeps
    agreeing."""
    jcfg = _reduced("gemma2-9b")
    jarch = dataclasses.replace(JREGISTRY["gemma2-9b"], cfg=jcfg,
                                grad_accum=2)
    tarch = dataclasses.replace(get_arch("gemma2-9b"), cfg=_port_cfg(jcfg),
                                grad_accum=2)
    shape = LM_SHAPES["train_4k"]
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = _masters(jcfg, jp)
    js = jopt.init_opt_state(jp)
    ts = topt.init_opt_state(tp)
    jstep = jarch.step_fn(JREGISTRY["gemma2-9b"].shapes["train_4k"])
    tstep = tarch.step_fn(shape)
    for s in range(2):
        tok, tgt = _tokens(4, 16, 256, 10 + s), _tokens(4, 16, 256, 20 + s)
        jp, js, jm = jstep(jp, js, jnp.asarray(tok), jnp.asarray(tgt))
        tp, ts, tm = tstep(tp, ts, torch.from_numpy(tok),
                           torch.from_numpy(tgt))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        for a, b in zip(tree_leaves(tp["layers"]) + [tp["embed"]],
                        [jp["layers"][k] for k in tp["layers"]]
                        + [jp["embed"]]):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(_np(ts.mu["lm_head"]),
                                   _np(js.mu["lm_head"]), rtol=1e-4,
                                   atol=1e-9)


def test_registry_train_step_accumulates_like_one_batch():
    """``grad_accum = 2`` in float32 equals one step on the whole batch up
    to summation order (dense gemma2; MoE routing depends on the batch
    through its capacity, so an MoE step is not batch-invariant)."""
    jcfg = _reduced("gemma2-9b")
    base = dataclasses.replace(get_arch("gemma2-9b"), cfg=_port_cfg(jcfg))
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(1))
    tok = torch.from_numpy(_tokens(2, 8, 256, 5))
    tgt = torch.from_numpy(_tokens(2, 8, 256, 6))
    out = []
    for ga in (1, 2):
        arch = dataclasses.replace(base, grad_accum=ga)
        tp = _masters(jcfg, jp)
        st = topt.init_opt_state(tp)
        tp, st, m = arch.step_fn(LM_SHAPES["train_4k"])(tp, st, tok, tgt)
        out.append((tp, m))
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-7)


def test_registry_train_step_grok_posture():
    """grok-1's own posture, reduced: bf16 masters, bf16 Adam moments,
    bf16 gradient accumulation over 2 microbatches. The step runs, keeps
    every dtype, moves every leaf and gives a finite loss."""
    arch = get_arch("grok-1-314b")
    cfg = dataclasses.replace(
        _port_cfg(_reduced("grok-1-314b")), dtype=torch.bfloat16,
        param_dtype=torch.bfloat16)
    arch = dataclasses.replace(arch, cfg=cfg, grad_accum=2,
                               opt=topt.OptimizerConfig(lr=1e-2,
                                                        warmup_steps=0))
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(2), "cpu",
                              masters=True)
    before = tree_map(torch.clone, params)
    st = topt.init_opt_state(params, state_dtype=arch.opt_state_dtype)
    tok = torch.from_numpy(_tokens(4, 8, 256, 7))
    params, st, m = arch.step_fn(LM_SHAPES["train_4k"])(params, st, tok,
                                                        tok)
    assert np.isfinite(float(m["loss"])) and int(st.step) == 1
    for a, b, mu in zip(tree_leaves(params), tree_leaves(before),
                        tree_leaves(st.mu)):
        assert a.dtype == mu.dtype == torch.bfloat16
        assert not torch.equal(a, b)


def _lm_loss_and_batches(cfg):
    def loss_fn(p, batch):
        return ttfm.loss_fn(cfg, p, batch["tokens"], batch["targets"],
                            chunk=8)

    def batch_fn(step):
        return synthetic.lm_batch(step, 2, 17, cfg.vocab, device="cpu")
    return loss_fn, batch_fn


def test_train_resumes_bit_for_bit(tmp_path):
    """``train`` to step 6 with a checkpoint every 3 steps, then again to
    10 from the same directory (restored from step 6): params and the
    last losses equal a straight run to 10 bit for bit. Gradient
    accumulation and compression on."""
    cfg = dataclasses.replace(_port_cfg(_reduced("gemma2-9b")), remat=True)
    params = ttfm.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                              masters=True)
    loss_fn, batch_fn = _lm_loss_and_batches(cfg)
    opt = topt.OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10)

    def run(d, n):
        return train(loss_fn, params, batch_fn, TrainConfig(
            opt=opt, grad_accum=2, compress_grads=True, ckpt_dir=str(d),
            ckpt_every=3, log_every=1), num_steps=n)
    run(tmp_path / "a", 6)
    resumed, _, hist_r = run(tmp_path / "a", 10)
    straight, _, hist_s = run(tmp_path / "b", 10)
    assert [h["step"] for h in hist_r] == [6, 7, 8, 9]
    assert hist_r == hist_s[6:]
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert torch.equal(a, b)
    assert hist_s[-1]["loss"] < hist_s[0]["loss"]


def test_lm_batch_is_deterministic_and_structured():
    a = synthetic.lm_batch(3, 2, 65, 1000, seed=1, device="cpu")
    b = synthetic.lm_batch(3, 2, 65, 1000, seed=1, device="cpu")
    c = synthetic.lm_batch(4, 2, 65, 1000, seed=1, device="cpu")
    assert a["tokens"].shape == (2, 64) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 1000
    same = (a["tokens"][:, 1:] == a["tokens"][:, :-1]).float().mean()
    assert 0.5 < float(same) < 0.8          # repeats of 4, 10 % noise


def test_launch_train_runs_on_the_cpu(tmp_path):
    """``launch/train.py --device cpu`` trains a reduced MoE arch with
    checkpoints; a second run resumes from them; a GNN arch exits as the
    JAX driver does (the recsys branch: tests/test_torch_recsys.py)."""
    argv = ["--arch", "llama4-scout-17b-a16e", "--reduce", "16", "--steps",
            "4", "--batch", "2", "--seq", "17", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--grad-accum", "2",
            "--device", "cpu"]
    hist = tlaunch.main(argv)
    assert [h["step"] for h in hist] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    again = tlaunch.main(argv[:5] + ["6"] + argv[6:])
    assert [h["step"] for h in again] == [4, 5]
    with pytest.raises(SystemExit, match="use examples/ for gnn training"):
        tlaunch.main(["--arch", "egnn", "--device", "cpu"])


def test_launch_train_as_a_script():
    """``python -m repro_torch.launch.train`` from its flags, jax not
    imported."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['train', '--arch', 'phi3-mini-3.8b',"
         " '--reduce', '16', '--steps', '2', '--batch', '2', '--seq', '9',"
         " '--device', 'cpu']; runpy.run_module('repro_torch.launch.train',"
         " run_name='__main__'); assert 'jax' not in sys.modules"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin",
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 2 steps" in out.stdout
