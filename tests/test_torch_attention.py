"""The port's attention functions against the JAX package's, on the CPU,
on the same numpy inputs: the oracles ``attention_ref`` and
``decode_attention_ref``, ``chunked_attention`` (the flash kernel's plain
version), the transformer's ``_decode_attn_dyn_window``, and the port's
``flash_attention`` op (on CPU tensors it runs ``chunked_attention``)
against the JAX ``flash_attention_trainable``, which off the TPU is what
the JAX transformer runs. The Pallas kernel itself does not run in
interpret mode on the installed jax (ROADMAP Queue 3), so it is no oracle.

Tolerances. float32: rtol 1e-5, atol 1e-6 (the two frameworks sum the
einsums in different orders; largest seen 9.5e-7). bfloat16: atol 2e-2,
rtol 2e-2, about two bf16 ulps (one ulp is 2^-7 relative). The torch
functions round to bf16 after every op; XLA on the CPU may skip those
roundings between fused elementwise ops (``xla_allow_excess_precision``),
so bf16 results need not be bitwise. Largest seen: 0.0039 (one ulp) for
``chunked_attention``; the eager JAX ``attention_ref`` came out bitwise
equal.
"""
import ast
import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import chunked as jchunked  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.kernels.flash_attention import ref as jref  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref, chunked_attention, decode_attention_ref, flash_attention,
)
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    kernel_arithmetic,
)
from repro_torch.models import transformer as ttfm  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}

# (B, Hq, Hkv, S, D, causal, window, softcap)
CASES = {
    "mha": (2, 4, 4, 24, 16, True, None, None),
    "gqa": (1, 8, 2, 33, 32, True, None, None),
    "mqa": (1, 6, 1, 20, 16, True, None, None),
    "window": (1, 4, 2, 40, 16, True, 7, None),
    "softcap": (1, 4, 2, 24, 16, True, None, 5.0),
    "window_softcap_d96": (1, 2, 1, 30, 96, True, 9, 20.0),
    "noncausal": (2, 4, 2, 19, 16, False, None, None),
    "noncausal_window": (1, 4, 4, 26, 16, False, 5, 3.0),
    "ragged37": (1, 4, 2, 37, 16, True, 11, None),
    "s1": (1, 4, 2, 1, 16, True, None, None),
}


def _inputs(case, dtype, seed=0):
    B, Hq, Hkv, S, D = case[:5]
    rng = np.random.default_rng(seed + S * 31 + D)
    j_dt, t_dt, tol = DTYPES[dtype]
    arrs = [rng.normal(size=(B, h, S, D)).astype(np.float32) * sc
            for h, sc in ((Hq, 2.0), (Hkv, 1.0), (Hkv, 1.0))]
    j = [jnp.asarray(a).astype(j_dt) for a in arrs]
    t = [torch.from_numpy(a).to(t_dt) for a in arrs]
    return j, t, tol


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)), **tol)


# bf16 on two cases (D = 96, where the bf16 scale is not the f32 one;
# S = 1): the JAX oracle runs eagerly (op by op, so it rounds
# to bf16 where the torch one does; under jit XLA keeps the bf16 logits in
# f32), and eager bf16 costs ~2 s a case on the CPU
REF_RUNS = [(n, "f32") for n in sorted(CASES)] + [
    (n, "bf16") for n in ("window_softcap_d96", "s1")]


@pytest.mark.parametrize("name,dtype", REF_RUNS)
def test_attention_ref_matches_jax(name, dtype):
    causal, window, softcap = CASES[name][5:]
    j, t, tol = _inputs(CASES[name], dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    fn = functools.partial(jref.attention_ref, **kw)
    want = (jax.jit(fn) if dtype == "f32" else fn)(*j)
    _close(attention_ref(*t, **kw), want, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_attention_matches_jax(name, dtype):
    """Several query chunks (block_q 8), the last one ragged."""
    causal, window, softcap = CASES[name][5:]
    j, t, tol = _inputs(CASES[name], dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, block_q=8)
    _close(chunked_attention(*t, **kw), jchunked.chunked_attention(*j, **kw),
           tol)


@pytest.mark.parametrize("name", ["gqa", "window_softcap_d96", "ragged37",
                                  "s1", "noncausal"])
def test_flash_op_on_cpu_matches_jax_trainable_path(name):
    """Off the TPU the JAX transformer's flash path is
    ``flash_attention_trainable`` (chunked, block_q 512); the port's op on
    CPU tensors runs its plain version, and ``backend="reference"`` is
    the same function."""
    causal, window, softcap = CASES[name][5:]
    j, t, tol = _inputs(CASES[name], "f32")
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = jops.flash_attention_trainable(*j, **kw)
    n0 = tops.launches
    got = flash_attention(*t, **kw)
    assert tops.launches == n0
    _close(got, want, tol)
    assert torch.equal(got, flash_attention(*t, backend="reference", **kw))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("softcap", [None, 4.0])
def test_decode_attention_matches_jax(dtype, window, softcap):
    """q (B, Hq, 1, D) against a partly filled GQA cache (the oracle has no
    window in the port); the port's gemma2 dynamic-window form against the
    JAX one at a local and a global window."""
    B, Hq, Hkv, S, D = 2, 8, 2, 24, 32
    rng = np.random.default_rng(7)
    j_dt, t_dt, tol = DTYPES[dtype]
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32) * 2
    kc = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    vc = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    j = [jnp.asarray(a).astype(j_dt) for a in (q, kc, vc)]
    t = [torch.from_numpy(a).to(t_dt) for a in (q, kc, vc)]
    for cache_len in (1, 13, S):
        _close(decode_attention_ref(*t, cache_len, softcap=softcap),
               jref.decode_attention_ref(*j, cache_len, softcap=softcap),
               tol)
    jcfg = jtfm.TransformerConfig(attn_softcap=softcap)
    tcfg = ttfm.TransformerConfig(attn_softcap=softcap)
    for win in (window or 2 ** 30, 2 ** 30):
        _close(ttfm._decode_attn_dyn_window(tcfg, *t, 13, win),
               jtfm._decode_attn_dyn_window(jcfg, *j, jnp.int32(13),
                                            jnp.int32(win)), tol)


# The flash kernel's arithmetic (log2-domain softmax with exp2, the
# softcap's tanh from exp2 and a reciprocal, the online recurrence over its
# key tiles, P rounded to bf16) against its plain version, at
# chip_smoke.py's phase-2 shapes cut to S = 256 (gemma2's local window cut
# in the same proportion, 4096 of 8192 -> 128 of 256). The inputs are bf16
# values held in float32, so both outputs are compared before the final
# bf16 rounding: the arithmetic must stay within half of the smoke's
# FLASH_TOL, which leaves the other half to that rounding (half a bf16 ulp,
# 2^-9 relative, on each side).
KERNEL_CASES = {
    "gemma2_global": (1, 16, 8, 256, 256, None, 50.0),
    "gemma2_local": (1, 16, 8, 256, 256, 128, 50.0),
    "phi3_mini": (1, 32, 32, 256, 96, None, None),
    "granite_34b": (1, 48, 1, 256, 128, None, None),
}


def _smoke_flash_tol() -> dict:
    """chip_smoke.py's FLASH_TOL, read without importing the script."""
    root = Path(__file__).resolve().parents[1]
    for node in ast.parse((root / "chip_smoke.py").read_text()).body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "FLASH_TOL":
            return {kw.arg: ast.literal_eval(kw.value)
                    for kw in node.value.keywords}
    raise KeyError("FLASH_TOL")


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
def test_kernel_arithmetic_within_half_the_smoke_gate(name):
    B, Hq, Hkv, S, D, window, softcap = KERNEL_CASES[name]
    rng = np.random.default_rng(S + D + Hq)
    q, k, v = (torch.from_numpy(
        rng.normal(size=(B, h, S, D)).astype(np.float32) * sc)
        .bfloat16().float() for h, sc in ((Hq, 2.0), (Hkv, 1.0), (Hkv, 1.0)))
    kw = dict(causal=True, window=window, softcap=softcap)
    got = kernel_arithmetic(q, k, v, **kw)
    want = chunked_attention(q, k, v, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    tol = _smoke_flash_tol()
    diff = (got - want).abs()
    share = float((diff / (tol["atol"] + tol["rtol"] * want.abs())).max())
    print(f"{name}: max |diff| {float(diff.max()):.2e}, largest share of "
          f"the smoke's tolerance {share:.3f}")
    assert 0 < share <= 0.5
