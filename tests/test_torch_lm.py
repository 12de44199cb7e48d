"""The port's dense transformer, configs and serving loop against the JAX
package's, on the CPU, on the same weights: the JAX ``init_params`` tree
goes to the port through ``convert.transformer_params_from_numpy``.

Configs: gemma2-9b, phi3-mini-3.8b and granite-34b, cut to the
``_reduced`` shape of ``tests/test_models_lm.py`` (2 layers, d 64, 4
heads, head_dim 16, d_ff 128, vocab 256), with gemma2's local window cut
to 5 so that it masks at these sequence lengths. With ``use_flash=True``
the JAX transformer runs ``chunked_attention`` off the TPU, as the port
does on CPU tensors.

Tolerances. float32: rtol 1e-5 with atol 1e-5 for values near zero
(matmul and einsum summation orders differ; largest seen 2.1e-6 on
logits of size up to 4).
Greedy serve tokens in float32: equal. bfloat16 (gemma2, forward only):
atol 0.1 on logits of size ~1-4 — torch rounds to bf16 after every op,
XLA on the CPU may keep f32 between fused elementwise ops
(``xla_allow_excess_precision``), and the differences, a bf16 ulp or two
of the activations per op, compound over the layers (largest seen
0.031).
"""
import ast
import contextlib
import dataclasses
import io
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # xdist workers share the cores: one each
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.configs  # noqa: E402,F401  (registers the JAX archs)
from repro.configs.base import REGISTRY as JREGISTRY  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import transformer_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    kernel_arithmetic, kernel_block_k,
)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

LM_IDS = ["gemma2-9b", "phi3-mini-3.8b", "granite-34b"]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_ATOL = 0.1
T_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
SHARED = [f.name for f in dataclasses.fields(ttfm.TransformerConfig)]
ROOT = Path(__file__).resolve().parents[1]


def _reduced(cfg, dtype=jnp.float32):
    return dataclasses.replace(
        cfg, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=16, d_ff=128, vocab=256,
        act_sharding=None, remat=False, local_window=5, dtype=dtype)


def _port_cfg(jcfg):
    """The port's config with the JAX config's values."""
    kw = {f: getattr(jcfg, f) for f in SHARED}
    kw["dtype"] = T_DTYPE[jcfg.dtype]
    kw["param_dtype"] = T_DTYPE[jcfg.param_dtype]
    return ttfm.TransformerConfig(**kw)


@pytest.fixture(scope="module", params=LM_IDS)
def model(request):
    """(id, JAX cfg, port cfg, JAX params, port params), float32."""
    jcfg = _reduced(JREGISTRY[request.param].cfg)
    tcfg = _port_cfg(jcfg)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    return request.param, jcfg, tcfg, jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(t, j, **tol):
    np.testing.assert_allclose(_np(t), _np(j), **(tol or F32_TOL))


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def test_configs_match_jax():
    """Every field the port keeps, the parameter counts and the model
    FLOPs of each LM shape equal the JAX registry's."""
    for aid in LM_IDS:
        j, t = JREGISTRY[aid], get_arch(aid)
        for f in SHARED:
            want = getattr(j.cfg, f)
            want = T_DTYPE.get(want, want) if f.endswith("dtype") else want
            assert getattr(t.cfg, f) == want, (aid, f)
        assert t.cfg.params_count == j.cfg.params_count
        assert t.cfg.active_params_count == j.cfg.active_params_count
        for name, shape in j.shapes.items():
            assert tbase.LM_SHAPES[name].dims == shape.dims
            assert t.model_flops(tbase.LM_SHAPES[name]) == \
                j.model_flops(shape)
    # every arch of the JAX registry is registered in the port
    assert set(tbase.REGISTRY) == set(JREGISTRY) == set(LM_IDS) | {
        "rama-multicut", "llama4-scout-17b-a16e", "grok-1-314b", "dimenet",
        "egnn", "mace", "graphcast", "wide-deep"}
    assert get_arch("gemma2-9b").cfg.params_count == 10_158_908_928
    # the train step is ported: one step of reduced gemma2 on the CPU
    arch = get_arch("gemma2-9b")
    arch = dataclasses.replace(arch, cfg=_port_cfg(_reduced(
        JREGISTRY["gemma2-9b"].cfg)))
    params = ttfm.init_params(arch.cfg, torch.Generator().manual_seed(0),
                              "cpu", masters=True)
    tok = torch.from_numpy(_tokens(1, 8, 256, 0))
    _, opt, m = arch.step_fn(tbase.LM_SHAPES["train_4k"])(
        params, topt.init_opt_state(params), tok, tok)
    assert int(opt.step) == 1 and bool(torch.isfinite(m["loss"]))


def test_params_carried_across(model):
    aid, jcfg, tcfg, jp, tp = model
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for k, a in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == a.shape
        _close(tp["layers"][k], a, rtol=0, atol=0)
    assert tp["layers"]["wq"].dtype == torch.float32
    assert tp["final_norm"].dtype == torch.float32


def test_building_blocks_match_jax(model):
    """rms_norm, rope, swiglu, attention_block (each layer's window) and
    ffn_block on one layer's weights."""
    aid, jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(1)
    B, S, d = 2, 11, jcfg.d_model
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32) + 3, (B, S))
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos.copy())
    w = rng.normal(size=(d,)).astype(np.float32)
    _close(ttfm.rms_norm(xt, torch.from_numpy(w), 1e-6),
           jtfm.rms_norm(x, w, 1e-6))
    heads = rng.normal(size=(B, 3, S, 16)).astype(np.float32)
    _close(ttfm.rope(torch.from_numpy(heads), pt, 10000.0),
           jtfm.rope(heads, pos, 10000.0))
    for i in range(jcfg.n_layers):
        jl = jax.tree.map(lambda a: a[i], jp["layers"])
        tl = ttfm.layer_params(tp, i)
        win = ttfm.layer_window(tcfg, i)
        _close(ttfm.attention_block(tcfg, tl, xt, pt, win),
               jtfm.attention_block(jcfg, jl, x, pos, win))
        _close(ttfm.ffn_block(tcfg, tl, xt), jtfm.ffn_block(jcfg, jl, x))
        _close(ttfm.swiglu(xt, tl["w_gate"], tl["w_up"], tl["w_down"]),
               jtfm.swiglu(x, jl["w_gate"], jl["w_up"], jl["w_down"]))


def test_forward_matches_jax(model):
    """Prefill logits, through the arch's prefill step (both backends are
    the plain version on CPU tensors)."""
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


def test_decode_sequence_matches_jax(model):
    """Eight decode steps into a 12-slot cache: logits and cache at every
    step; the last step's logits also match the port's own forward on
    the whole prompt (KV-cache correctness, as tests/test_models_lm.py)."""
    aid, jcfg, tcfg, jp, tp = model
    B, S, L = 2, 8, 12
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
    full = ttfm.forward(tcfg, tp, torch.from_numpy(tok))
    _close(tl, full[:, -1], rtol=0, atol=2e-3)


def test_bf16_forward_matches_jax():
    """gemma2 in its own dtype (bf16): logits within BF16_ATOL."""
    jcfg = _reduced(JREGISTRY["gemma2-9b"].cfg, dtype=jnp.bfloat16)
    tcfg = _port_cfg(jcfg)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    tok = _tokens(1, 16, jcfg.vocab, 4)
    want = jtfm.forward(jcfg, jp, jnp.asarray(tok))
    got = ttfm.forward(tcfg, tp, torch.from_numpy(tok))
    _close(got, want, rtol=0, atol=BF16_ATOL)


def test_serve_loop_matches_jax(monkeypatch):
    """Both serving loops on reduced gemma2 (``--reduce 16``) in float32,
    on the same weights and prompts: the same requests finish in the same
    slots with the same greedy tokens."""
    orig = jserve._reduced_lm
    monkeypatch.setattr(jserve, "_reduced_lm", lambda cfg, f: dataclasses
                        .replace(orig(cfg, f), dtype=jnp.float32))
    argv = ["--arch", "gemma2-9b", "--reduce", "16", "--batch", "2",
            "--prompt-len", "6", "--gen", "3", "--requests", "3"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.main(argv)
    want = [(int(s), [int(x) for x in toks.split(",")]) for s, toks in
            re.findall(r"slot (\d+)\): \[([\d, ]+)\]", buf.getvalue())]
    jcfg = jserve._reduced_lm(JREGISTRY["gemma2-9b"].cfg, 16)
    tcfg = tserve._reduced_lm(get_arch("gemma2-9b").cfg, 16)
    assert _port_cfg(jcfg) == dataclasses.replace(tcfg, dtype=torch.float32)
    tcfg = _port_cfg(jcfg)
    jp = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                       device="cpu")
    got = tserve.serve(tcfg, tp, batch=2, prompt_len=6, gen=3, requests=3,
                       log=lambda *_: None)
    assert got["served"] == 3 and len(want) == 3
    assert [(s, toks[:8]) for s, toks in got["done"]] == want
    assert all(len(toks) == 4 for _, toks in got["done"])


def test_serve_main_and_unported_parts():
    """The port's serving loop runs end to end from its flags on the CPU;
    MoE (once unported) builds and runs forward; a missing card raises."""
    out = tserve.main(["--arch", "phi3-mini-3.8b", "--reduce", "16",
                       "--batch", "2", "--prompt-len", "3", "--gen", "2",
                       "--requests", "3", "--device", "cpu"])
    assert out["served"] == 3 and out["n_decoded"] == 2 * out["steps"]
    moe = ttfm.TransformerConfig(moe=True, n_experts=4, top_k=2,
                                 n_layers=2, d_model=32, d_ff=64, vocab=64,
                                 dtype=torch.float32)
    params = ttfm.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    assert params["layers"]["router"].shape == (2, 32, 4)
    assert params["layers"]["w_gate"].shape == (2, 4, 32, 64)
    logits = ttfm.forward(moe, params, torch.zeros((1, 2), dtype=torch.int32))
    assert logits.shape == (1, 2, 64) and bool(torch.isfinite(logits).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttfm.init_kv_cache(moe, 1, 4)


def _smoke_constant(name):
    """A module-level constant of chip_smoke.py, read without importing it."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == name:
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_kernel_rounding_within_smoke_gates(monkeypatch):
    """The flash kernel's numerical differences from its plain version:
    its exp2 softmax and softcap formula over key tiles, and P rounded to
    bf16 for the P V product (``ref.kernel_arithmetic``, at gemma2-9b's
    key tile of 80). Emulated at gemma2-9b's depth (42 layers, local/global
    pairing, softcaps) and a width the CPU holds (d 512, 4/2 heads of 64,
    d_ff 1024, vocab 16384, window 128) on a 512-token prompt, they keep
    the prefill logits within half of chip_smoke.py's LOGITS_REL_TOL and
    the greedy tokens above its GREEDY_AGREE_MIN, so those phase-5 gates
    leave room for a right kernel. ``pytest -s`` prints the reading."""
    cfg = dataclasses.replace(
        get_arch("gemma2-9b").cfg, d_model=512, n_heads=4, n_kv_heads=2,
        head_dim=64, d_ff=1024, vocab=16384, local_window=128)
    gen = torch.Generator().manual_seed(0)
    params = ttfm.init_params(cfg, gen, "cpu")
    tok = torch.randint(0, cfg.vocab, (1, 512), generator=gen)
    ref = ttfm.forward(cfg, params, tok, backend="reference")
    calls = []

    def bf16_p(q, k, v, *, causal, window, softcap, backend):
        """The kernel's arithmetic in place of the kernel."""
        assert causal and backend == "cuda"
        calls.append(window)
        return kernel_arithmetic(q, k, v, causal=causal, window=window,
                                 softcap=softcap,
                                 block_k=kernel_block_k(256))

    monkeypatch.setattr(ttfm, "flash_attention", bf16_p)
    got = ttfm.forward(cfg, params, tok)
    assert calls == [ttfm.layer_window(cfg, i) for i in range(42)]
    rel = float((got - ref).abs().max() / ref.abs().max())
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"kernel arithmetic against plain: max |diff| / max |ref| "
          f"{rel:.4f}, "
          f"greedy agreement {agree:.4f}")
    assert 0 < rel < _smoke_constant("LOGITS_REL_TOL") / 2
    assert agree > _smoke_constant("GREEDY_AGREE_MIN")
