"""The port's MoE transformer (llama4-scout-17b-a16e: 16 experts top-1;
grok-1-314b: 8 experts top-2) against the JAX package's, on the CPU, on
the same weights: the JAX ``init_params`` tree goes to the port through
``convert.transformer_params_from_numpy``.

Configs are cut as ``tests/test_models_lm.py`` cuts them (2 layers, d 64,
4 heads of 16, d_ff 128, vocab 256, at most 4 experts). Routing (each
choice's expert, its position in the expert and whether it is kept) is
compared with the JAX function's own routing expressions
(``models/transformer.py::moe_block.dispatch``, evaluated here by
``_jax_routing``) and must be exactly equal, with capacity drops forced
(``capacity_factor`` 0.05) and with an exact router tie (two identical
router columns: equal gates go to the lower expert, as ``jax.lax.top_k``
breaks ties).

Tolerances. float32: rtol 1e-5 with atol 1e-5 (matmul summation orders
differ; largest seen 2.0e-6 on logits of size up to 4). bfloat16 logits:
atol 0.1 on logits of size ~1-4, as ``tests/test_torch_lm.py`` (torch
rounds to bf16 after every op, XLA on the CPU may keep f32 between fused
ops; a bf16 ulp or two of the activations per op, compounded over the
layers).
"""
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs  # noqa: E402,F401  (registers the JAX archs)
from repro.configs.base import REGISTRY as JREGISTRY  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import transformer_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402

MOE_IDS = ["llama4-scout-17b-a16e", "grok-1-314b"]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 0.1
T_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SHARED = [f.name for f in dataclasses.fields(ttfm.TransformerConfig)]


def _reduced(cfg, dtype=jnp.float32, **kw):
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=16, d_ff=128, vocab=256,
        act_sharding=None, remat=False, n_experts=min(cfg.n_experts, 4),
        dtype=dtype, param_dtype=dtype, **kw)


def _port_cfg(jcfg):
    kw = {f: getattr(jcfg, f) for f in SHARED}
    kw["dtype"] = T_DTYPE[jcfg.dtype]
    kw["param_dtype"] = T_DTYPE[jcfg.param_dtype]
    return ttfm.TransformerConfig(**kw)


def _pair(aid, dtype=jnp.float32, **kw):
    """(JAX cfg, port cfg, JAX params, port params)."""
    jcfg = _reduced(JREGISTRY[aid].cfg, dtype, **kw)
    tcfg = _port_cfg(jcfg)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=MOE_IDS)
def model(request):
    return (request.param,) + _pair(request.param)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(t, j, **tol):
    np.testing.assert_allclose(_np(t), _np(j), **(tol or F32_TOL))


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def _jax_routing(jcfg, router, x):
    """The JAX ``moe_block``'s routing of x (N, d) for one group, written
    with the same jax calls as its ``dispatch``: (top_e, pos_in_e, keep,
    top_w, C)."""
    N = x.shape[0]
    E, K = jcfg.n_experts, jcfg.top_k
    C = max(int(jcfg.capacity_factor * N * K / E), 1)
    logits = (x @ router.astype(x.dtype)).astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    top_w, top_e = jax.lax.top_k(gates, K)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    flat = jax.nn.one_hot(top_e, E, dtype=jnp.int32).reshape(N * K, E)
    pos = jnp.cumsum(flat, axis=0) - flat
    pos_in_e = jnp.sum(pos * flat, axis=-1).reshape(N, K)
    return (np.asarray(top_e), np.asarray(pos_in_e),
            np.asarray(pos_in_e < C), top_w, C)


def _check_routing(jcfg, tcfg, router_np, x_np):
    """Port routing == JAX routing exactly (integers), gates to 1e-6."""
    jdt = jcfg.dtype
    je, jpos, jkeep, jw, jC = _jax_routing(
        jcfg, jnp.asarray(router_np), jnp.asarray(x_np, jdt))
    r = ttfm.moe_route(tcfg, torch.tensor(router_np).to(tcfg.dtype),
                       torch.from_numpy(x_np).to(tcfg.dtype))
    assert r.capacity == jC
    np.testing.assert_array_equal(r.top_e.numpy(), je)
    np.testing.assert_array_equal(r.pos.numpy(), jpos)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    _close(r.top_w, jw, rtol=1e-6, atol=1e-6)
    return r


def test_configs_match_jax():
    """Every field the port keeps, the parameter counts and the model
    FLOPs of each LM shape equal the JAX registry's, for both MoE archs;
    the arch's optimizer posture and microbatching too."""
    for aid in MOE_IDS:
        j, t = JREGISTRY[aid], get_arch(aid)
        for f in SHARED:
            want = getattr(j.cfg, f)
            want = T_DTYPE.get(want, want) if f.endswith("dtype") else want
            assert getattr(t.cfg, f) == want, (aid, f)
        assert t.cfg.params_count == j.cfg.params_count
        assert t.cfg.active_params_count == j.cfg.active_params_count
        assert t.grad_accum == j.grad_accum
        assert t.opt_state_dtype == T_DTYPE.get(j.opt_state_dtype)
        assert dataclasses.asdict(t.opt) == dataclasses.asdict(j.opt)
        for name, shape in j.shapes.items():
            assert t.model_flops(tbase.LM_SHAPES[name]) == \
                j.model_flops(shape)
    assert get_arch("grok-1-314b").cfg.param_dtype == torch.bfloat16
    assert get_arch("llama4-scout-17b-a16e").cfg.active_params_count < \
        get_arch("llama4-scout-17b-a16e").cfg.params_count


def test_params_carried_across(model):
    """The router (L, d, E) and expert (L, E, d, ff) leaves, bit for bit;
    the port's own init draws the same shapes and the tree size is
    params_count."""
    aid, jcfg, tcfg, jp, tp = model
    assert set(tp["layers"]) == set(jp["layers"]) >= {"router", "w_gate"}
    for k, a in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == a.shape
        _close(tp["layers"][k], a, rtol=0, atol=0)
    mine = ttfm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in mine["layers"].items()} == \
        {k: a.shape for k, a in jp["layers"].items()}
    assert sum(v.numel() for v in mine["layers"].values()) + sum(
        v.numel() for k, v in mine.items() if k != "layers") == \
        tcfg.params_count


@pytest.mark.parametrize("cf", [1.25, 0.05], ids=["cf1.25", "cf0.05"])
def test_routing_and_moe_block_match_jax(model, cf):
    """Routing integers exactly and moe_block within F32_TOL, at the
    config's capacity and with most choices dropped (cf 0.05: C = 1)."""
    aid, jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    rng = np.random.default_rng(5)
    B, S, d = 2, 24, jcfg.d_model
    h = rng.normal(size=(B, S, d)).astype(np.float32)
    for i in range(jcfg.n_layers):
        jl = jax.tree.map(lambda a: a[i], jp["layers"])
        tl = ttfm.layer_params(tp, i)
        r = _check_routing(jcfg, tcfg, np.asarray(jl["router"]),
                           h.reshape(B * S, d))
        if cf < 1:
            assert r.capacity == 1 and not bool(r.keep.all())
        _close(ttfm.moe_block(tcfg, tl, torch.from_numpy(h)),
               jtfm.moe_block(jcfg, jl, jnp.asarray(h)))
        _close(ttfm.ffn_block(tcfg, tl, torch.from_numpy(h)),
               jtfm.ffn_block(jcfg, jl, jnp.asarray(h)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_router_tie_goes_to_the_lower_expert(dtype):
    """Router columns 1 and 2 identical (and, for grok's top-2, column 3
    equal to column 0): every token's gates tie exactly, in float32 and
    in bfloat16, and both packages route to the lower expert first; the
    block's outputs agree."""
    for aid in MOE_IDS:
        jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
        jcfg, tcfg, jp, tp = _pair(aid, jdt)
        rng = np.random.default_rng(7)
        d = jcfg.d_model
        router = rng.normal(size=(d, 4)).astype(np.float32) / 8.0
        router[:, 2] = router[:, 1]
        router[:, 3] = router[:, 0]
        # make experts 1/2 (and 0/3) the two favourites of every token
        router[:, 1] += 0.5
        router[:, 2] += 0.5
        h = rng.normal(size=(2 * 16, d)).astype(np.float32)
        h[:, :] = np.abs(h)
        r = _check_routing(jcfg, tcfg, router, h)
        want = [1] if jcfg.top_k == 1 else [1, 2]
        assert (r.top_e.numpy() == want).all(), r.top_e
        jl = dict(jax.tree.map(lambda a: a[0], jp["layers"]))
        jl["router"] = jnp.asarray(router, jdt)
        tl = dict(ttfm.layer_params(tp, 0))
        tl["router"] = torch.from_numpy(router).to(tcfg.dtype)
        x = h.reshape(2, 16, d)
        got = ttfm.moe_block(tcfg, tl, torch.from_numpy(x).to(tcfg.dtype))
        want_out = jtfm.moe_block(jcfg, jl, jnp.asarray(x, jdt))
        tol = F32_TOL if dtype == "f32" else dict(rtol=0, atol=BF16_ATOL)
        _close(got, want_out, **tol)


def test_dispatch_writes_each_kept_token_once():
    """The (E, C, d) buffer the port's dispatch fills equals the JAX
    scatter-add's (kept tokens at (expert, position), zeros elsewhere,
    dropped tokens nowhere), read through an identity expert: with
    w_gate = w_up = I and w_down = I, silu(x) x passes each row back, and
    every kept token's output is its gate-weighted silu(h) h."""
    jcfg, tcfg, jp, tp = _pair("grok-1-314b", capacity_factor=0.5)
    d, E = jcfg.d_model, jcfg.n_experts
    eye = np.broadcast_to(np.eye(d, dtype=np.float32), (E, d, d)).copy()
    rng = np.random.default_rng(3)
    h = rng.normal(size=(1, 20, d)).astype(np.float32)
    jl = dict(jax.tree.map(lambda a: a[0], jp["layers"]))
    tl = dict(ttfm.layer_params(tp, 0))
    for w in ("w_gate", "w_up", "w_down"):
        jl[w], tl[w] = jnp.asarray(eye), torch.from_numpy(eye)
    got = ttfm.moe_block(tcfg, tl, torch.from_numpy(h))
    _close(got, jtfm.moe_block(jcfg, jl, jnp.asarray(h)))
    r = ttfm.moe_route(tcfg, tl["router"], torch.from_numpy(h[0]))
    x = torch.from_numpy(h[0])
    w = (r.top_w * r.keep).sum(1, keepdim=True)
    torch.testing.assert_close(got[0], torch.nn.functional.silu(x) * x * w,
                               rtol=1e-5, atol=1e-6)
    assert 0 < int(r.keep.sum()) < r.keep.numel()


def test_forward_matches_jax(model):
    """Prefill logits through the arch's prefill step, both backends (the
    plain version on CPU tensors), f32."""
    aid, jcfg, tcfg, jp, tp = model
    tok = _tokens(2, 13, jcfg.vocab, 2)
    want = jtfm.forward(jcfg, jp, jnp.asarray(tok))
    arch = dataclasses.replace(get_arch(aid), cfg=tcfg)
    shape = tbase.LM_SHAPES["prefill_32k"]
    got = arch.step_fn(shape)(tp, torch.from_numpy(tok))
    assert got.shape == (2, 13, jcfg.vocab) and got.dtype == torch.float32
    _close(got, want)
    ref = arch.step_fn(shape, backend="reference")(tp, torch.from_numpy(tok))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("cf", [1.25, 0.05], ids=["cf1.25", "cf0.05"])
def test_decode_sequence_matches_jax(model, cf):
    """Eight decode steps into a 12-slot cache: logits and cache at every
    step (each step routes its B tokens with C = max(int(cf B K / E), 1):
    drops happen at cf 0.05 when two tokens pick one expert)."""
    aid, jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    B, S, L = 3, 8, 12
    tok = _tokens(B, S, jcfg.vocab, 3)
    jstep = jax.jit(lambda p, t, c, n: jtfm.decode_step(jcfg, p, t, c, n))
    jc = jtfm.init_kv_cache(jcfg, B, L)
    tc = ttfm.init_kv_cache(tcfg, B, L, device="cpu")
    for t in range(S):
        jl, jc = jstep(jp, jnp.asarray(tok[:, t]), jc, jnp.int32(t))
        tl, tc = ttfm.decode_step(tcfg, tp, torch.from_numpy(tok[:, t]), tc,
                                  t)
        _close(tl, jl)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


@pytest.mark.parametrize("aid", MOE_IDS)
def test_bf16_forward_matches_jax(aid):
    """Each MoE arch in its own dtypes (bf16 compute; grok's bf16
    params): logits within BF16_ATOL, drops forced (cf 0.05)."""
    cfg = JREGISTRY[aid].cfg
    jcfg = dataclasses.replace(
        _reduced(cfg, jnp.bfloat16, capacity_factor=0.05),
        param_dtype=cfg.param_dtype)
    tcfg = _port_cfg(jcfg)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    assert tp["layers"]["router"].dtype == torch.bfloat16
    tok = _tokens(1, 16, jcfg.vocab, 4)
    want = jtfm.forward(jcfg, jp, jnp.asarray(tok))
    got = ttfm.forward(tcfg, tp, torch.from_numpy(tok))
    _close(got, want, rtol=0, atol=BF16_ATOL)


def test_reduced_lm_caps_experts_as_jax():
    """``launch/serve.py``'s reduction keeps at most 4 experts, as the
    JAX ``launch/train.py::_reduced_lm`` does."""
    for aid in MOE_IDS:
        j = jtrain._reduced_lm(JREGISTRY[aid].cfg, 16)
        t = tserve._reduced_lm(get_arch(aid).cfg, 16)
        assert t.n_experts == j.n_experts == 4
        assert _port_cfg(j) == t


def test_serve_loop_matches_jax(monkeypatch):
    """Both serving loops on reduced grok-1 (``--reduce 16``, 4 experts
    top-2) in float32, on the same weights and prompts: the same requests
    finish in the same slots with the same greedy tokens."""
    orig = jserve._reduced_lm
    monkeypatch.setattr(jserve, "_reduced_lm", lambda cfg, f: dataclasses
                        .replace(orig(cfg, f), dtype=jnp.float32,
                                 param_dtype=jnp.float32))
    argv = ["--arch", "grok-1-314b", "--reduce", "16", "--batch", "2",
            "--prompt-len", "5", "--gen", "3", "--requests", "3"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.main(argv)
    want = [(int(s), [int(x) for x in toks.split(",")]) for s, toks in
            re.findall(r"slot (\d+)\): \[([\d, ]+)\]", buf.getvalue())]
    jcfg = jserve._reduced_lm(JREGISTRY["grok-1-314b"].cfg, 16)
    tcfg = _port_cfg(jcfg)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    got = tserve.serve(tcfg, tp, batch=2, prompt_len=5, gen=3, requests=3,
                       log=lambda *_: None)
    assert got["served"] == 3 and len(want) == 3
    assert [(s, toks[:8]) for s, toks in got["done"]] == want


def test_serve_main_runs_the_moe_archs():
    """``launch/serve.py`` serves both MoE archs from its flags on the
    CPU."""
    for aid in MOE_IDS:
        out = tserve.main(["--arch", aid, "--reduce", "16", "--batch", "2",
                           "--prompt-len", "3", "--gen", "2", "--requests",
                           "2", "--device", "cpu"])
        vocab = tserve._reduced_lm(get_arch(aid).cfg, 16).vocab
        assert out["served"] == 2 and all(
            len(toks) == 3 and all(0 <= x < vocab for x in toks)
            for _, toks in out["done"])
