"""The port's quantized storage (``repro_torch.quant``) and the int8-pool
plain version of the paged kernel, against the JAX package on the CPU.

The same numpy arrays go through ``repro.quant`` and the port's copy.
int8 payloads come out equal bit for bit: both divide in f32 (one
IEEE-rounded division per element), round half to even and clip, so no
|Δq| <= 1 allowance is needed; fp8 payloads are equal too (both round
f32 to nearest-even e4m3fn).  Scales are held to rtol 1e-6.

The int8 paged plain version (what the dispatch runs for CPU tensors)
is held against the JAX Pallas kernel in interpret mode and both
oracles on the ``tests/test_quant.py`` matrix, plus a Q = 3 verify case
and a bf16 query, at that file's tolerances: fp32 atol 2e-5 / rtol 1e-3
on the same int8 pools, 0.05 / 0.05 against the unquantized pools.  The
bf16 query case is held at one bf16 step (atol / rtol 1e-2): the output
is rounded to bf16 on both sides, and the f32 sums before it differ in
order.  The CUDA kernel is held against the plain version on a card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jquant
from repro.core.profiler import ACT_BYTES as J_ACT_BYTES
from repro.core.profiler import TPU_V5E
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.init import init_params as jax_init_params
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro_torch import quant as tquant
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ref as tref
from repro_torch.models.init import params_from_numpy

ATOL, RTOL = 2e-5, 1e-3          # tests/test_quant.py, same int8 pools
QATOL, QRTOL = 0.05, 0.05        # tests/test_quant.py, vs unquantized
SCALE_RTOL = 1e-6

# (name, stage-stacked shape, contraction axis): one case per _STAGE_RULES
# axis family, plus embed (per vocab row) and head (per vocab column)
WEIGHT_CASES = [
    ("attn_wq", (2, 64, 4, 16), 1),
    ("attn_wo", (2, 64, 64), 1),
    ("mlp_w1", (2, 64, 128), 1),
    ("moe_w1", (2, 4, 64, 32), 2),
    ("embed", (256, 64), 1),
    ("head", (64, 256), 0),
]
SRC_DTYPES = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    """A torch tensor as numpy, fp8 / bf16 widened to f32 exactly."""
    if t.dtype in (torch.float8_e4m3fn, torch.bfloat16):
        t = t.float()
    return t.numpy()


def _weight(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(w, src):
    jd, td = SRC_DTYPES[src]
    return jnp.asarray(w).astype(jd), torch.from_numpy(w).to(td)


# --------------------------------------------------------------------------
# Leaf codecs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("src", list(SRC_DTYPES))
@pytest.mark.parametrize("name,shape,axis", WEIGHT_CASES)
def test_quantize_matches_jax(fmt, src, name, shape, axis):
    w = _weight(shape, seed=len(name) + axis)
    jw, tw = _both(w, src)
    jq = jquant.quantize(jw, fmt, axis)
    tq = tquant.quantize(tw, fmt, axis)
    assert tq["scale"].dtype == torch.float32
    assert tuple(tq["scale"].shape) == tuple(jq["scale"].shape)
    assert tq["q"].dtype == (torch.int8 if fmt == "int8"
                             else torch.float8_e4m3fn)
    np.testing.assert_array_equal(_np(tq["q"]),
                                  np.asarray(jq["q"]).astype(np.float32)
                                  if fmt == "fp8" else np.asarray(jq["q"]))
    np.testing.assert_allclose(tq["scale"].numpy(), np.asarray(jq["scale"]),
                               rtol=SCALE_RTOL, atol=0)
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            _np(tquant.dequantize(tq, dt_t)),
            np.asarray(jquant.dequantize(jq, dt_j)).astype(np.float32))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_zero_channel_dequantizes_to_exact_zero(fmt):
    w = _weight((2, 64, 32), seed=1)
    w[:, :, 3] = 0.0                      # one output channel all zero
    tq = tquant.quantize(torch.from_numpy(w), fmt, 1)
    fmax = np.float32(127.0 if fmt == "int8" else 448.0)
    assert float(tq["scale"][0, 0, 3]) == np.float32(1.0) / fmax
    deq = tquant.dequantize(tq)
    assert (deq[:, :, 3] == 0).all()
    zero = tquant.quantize(torch.zeros(8, 4), fmt, 0)
    assert (tquant.dequantize(zero) == 0).all()


def test_maybe_dequant_passthrough_and_dtype():
    w = torch.randn(4, 4)
    assert tquant.maybe_dequant(w) is w
    assert tquant.maybe_dequant(w, torch.float32) is w
    assert tquant.maybe_dequant(w, torch.bfloat16).dtype == torch.bfloat16
    q = tquant.quantize(w, "int8", 1)
    assert tquant.is_quantized(q) and not tquant.is_quantized(w)
    assert tquant.maybe_dequant(q, torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown quantized weight dtype"):
        tquant.quantize(w, "int4", 0)


@pytest.mark.parametrize("src", list(SRC_DTYPES))
def test_kv_page_batched_matches_jax_and_zero_pages(src):
    pages = np.random.default_rng(2).standard_normal(
        (5, 16, 2, 8)).astype(np.float32)
    pages[1] = 0.0                        # an all-zero page
    pages[3, :, 1] = 0.0                  # one zero KV head of a page
    jp, tp = _both(pages, src)
    jq, js = jquant.quantize_kv_page_batched(jp)
    tq, ts = tquant.quantize_kv_page_batched(tp)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (5, 2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL,
                               atol=0)
    deq = tquant.dequantize_kv_pages(tq, ts)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jquant.dequantize_kv_pages(jq, js)))
    assert (deq[1] == 0).all() and (deq[3, :, 1] == 0).all()
    bound = 0.5 * ts[:, None, :, None] + 1e-6
    assert ((tp.float() - deq).abs() <= bound).all()


# --------------------------------------------------------------------------
# Whole-tree transform
# --------------------------------------------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict) and not jquant.is_quantized(tree) \
            and not tquant.is_quantized(tree):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["qwen3-14b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_params_matches_jax_tree(arch, fmt):
    """Same tree structure, the same leaves quantized (attention, dense
    and expert matmuls, embed, head; MoE at axis 2) and the same ones
    untouched (norms, router, Mamba), with equal payloads and scales."""
    jspec = jconfigs.get(arch).smoke_spec()
    params, _ = jax_init_params(jspec, JPlan(pp=2, tp=1), jax.random.key(3),
                                jnp.float32)
    host = jax.tree.map(np.asarray, params)
    jq, _ = jquant.quantize_params(params, None, fmt)
    tq = tquant.quantize_params(params_from_numpy(host, "cpu",
                                                  torch.float32), fmt)
    jp, tp = _paths(jq), _paths(tq)
    assert set(jp) == set(tp)
    n_quant = 0
    for path, jleaf in jp.items():
        tleaf = tp[path]
        if path[0] in ("layer_windows", "layer_thetas"):
            continue
        assert jquant.is_quantized(jleaf) == tquant.is_quantized(tleaf), path
        if tquant.is_quantized(tleaf):
            n_quant += 1
            np.testing.assert_array_equal(
                _np(tleaf["q"]), np.asarray(jleaf["q"]).astype(
                    np.float32 if fmt == "fp8" else np.int8))
            np.testing.assert_allclose(tleaf["scale"].numpy(),
                                       np.asarray(jleaf["scale"]),
                                       rtol=SCALE_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(_np(tleaf), np.asarray(jleaf))
    moe = [p for p in tp if "moe" in p and tquant.is_quantized(tp[p])]
    assert (len(moe) > 0) == (arch == "jamba-v0.1-52b")
    for p in moe:
        assert tp[p]["scale"].shape[2] == 1        # contraction axis 2
    assert not any(tquant.is_quantized(tp[p]) for p in tp
                   if "mamba" in p or "router" in p or "norm" in p[-1]
                   or any("norm" in k for k in p))
    assert n_quant > 0


def test_quantize_params_identity_and_rejects_unknown():
    tree = {"stages": {"layer_0": {"attn": {"wq": torch.randn(2, 8, 2, 4)}}},
            "embed": torch.randn(16, 8)}
    for name in ("fp32", "bf16", None):
        assert tquant.quantize_params(tree, name) is tree
        assert not tquant.is_quantized(tree["embed"])
    with pytest.raises(ValueError, match="unknown weight dtype"):
        tquant.quantize_params(tree, "int4")
    out = tquant.quantize_params(tree, "int8")
    assert out is tree and tquant.is_quantized(tree["embed"])
    assert tree["stages"]["layer_0"]["attn"]["wq"]["scale"].shape == \
        (2, 1, 2, 4)


def test_byte_costs_match_jax():
    jspec = jconfigs.get("qwen3-14b").full_spec()
    assert tquant.ACT_BYTES == J_ACT_BYTES
    for name in (None, "auto", "fp32", "bf16", "fp8", "int8"):
        assert tquant.weight_byte_cost(name, jspec, TPU_V5E) == \
            jquant.weight_byte_cost(name, jspec, TPU_V5E)
    for name in (None, "auto", "fp32", "bf16", "int8"):
        for page in (0, 16, 64):
            assert tquant.kv_byte_cost(name, jspec, page) == \
                jquant.kv_byte_cost(name, jspec, page)
    assert tquant.WEIGHT_DTYPES == jquant.WEIGHT_DTYPES
    assert tquant.KV_DTYPES == jquant.KV_DTYPES
    assert tquant._STAGE_RULES == jquant._STAGE_RULES


# --------------------------------------------------------------------------
# int8 paged attention: the plain version against the Pallas kernel
# --------------------------------------------------------------------------

def _paged_case(b, h, kv, dh, page, n_pages, seed, q_len=1):
    """f32 pools quantized per (page, KV head); tables of ragged lengths
    (>= q_len); spare pages hold random int8 payloads and NaN / inf
    scales (garbage that must not reach the output)."""
    rng = np.random.default_rng(seed)
    n_pool = b * n_pages + 3
    shape = (b, q_len, h, dh) if q_len > 1 else (b, h, dh)
    q = rng.standard_normal(shape).astype(np.float32)
    kp = rng.standard_normal((n_pool, page, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((n_pool, page, kv, dh)).astype(np.float32)
    lengths = rng.integers(q_len, n_pages * page + 1, b).astype(np.int32)
    perm = rng.permutation(n_pool)
    tables = np.full((b, n_pages), -1, np.int32)
    used = 0
    for r in range(b):
        need = -(-int(lengths[r]) // page)
        tables[r, :need] = perm[used:used + need]
        used += need
    kq, ks = (np.array(a) for a in jquant.quantize_kv_page_batched(
        jnp.asarray(kp)))
    vq, vs = (np.array(a) for a in jquant.quantize_kv_page_batched(
        jnp.asarray(vp)))
    spare = np.setdiff1d(np.arange(n_pool), tables[tables >= 0])
    return dict(q=q, kp=kp, vp=vp, kq=kq, ks=ks, vq=vq, vs=vs,
                tables=tables, lengths=lengths, spare=spare)


def _garbage(c, seed=9):
    """The case with its spare pages' payloads and scales overwritten."""
    rng = np.random.default_rng(seed)
    c = dict(c)
    for key in ("kq", "vq"):
        a = c[key].copy()
        a[c["spare"]] = rng.integers(-127, 128, a[c["spare"]].shape)
        c[key] = a
    for key, bad in (("ks", np.nan), ("vs", np.inf)):
        a = c[key].copy()
        a[c["spare"]] = bad
        c[key] = a
    return c


def _port(c, window, q_dtype=torch.float32, pools=("kq", "vq"),
          scales=("ks", "vs")):
    t = lambda k: torch.from_numpy(np.array(c[k]))
    kw = {}
    if scales:
        kw = dict(k_scale=t(scales[0]), v_scale=t(scales[1]))
    return tops.paged_attention(t("q").to(q_dtype), t(pools[0]),
                                t(pools[1]), t("tables"), t("lengths"),
                                window=window, **kw)


def _jax_kernel(c, window, q_dtype=jnp.float32):
    j = lambda k: jnp.asarray(c[k])
    return np.asarray(jops.paged_attention(
        j("q").astype(q_dtype), j("kq"), j("vq"), j("tables"), j("lengths"),
        window=window, k_scale=j("ks"), v_scale=j("vs"))).astype(np.float32)


INT8_CASES = [
    # b, h, kv, dh, page, n_pages, window, q_len  (tests/test_quant.py matrix)
    (2, 4, 2, 64, 16, 8, -1, 1),
    (2, 8, 2, 64, 64, 4, -1, 1),       # big pages, 4:1 GQA
    (2, 4, 2, 64, 16, 8, 20, 1),       # windowed: dead-page skipping
    (2, 4, 2, 64, 16, 8, -1, 3),       # verify, Q = 3
]


@pytest.mark.parametrize("b,h,kv,dh,page,n_pages,window,q_len", INT8_CASES)
def test_int8_paged_plain_matches_jax_kernel(b, h, kv, dh, page, n_pages,
                                             window, q_len):
    c = _paged_case(b, h, kv, dh, page, n_pages, seed=b + h + page + q_len,
                    q_len=q_len)
    got = _port(c, window).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_kernel(c, window), atol=ATOL,
                               rtol=RTOL)
    mine = tref.paged_attention_ref(*[torch.from_numpy(c[k]) for k in (
        "q", "kq", "vq", "tables", "lengths")], window=window,
        k_scale=torch.from_numpy(c["ks"]),
        v_scale=torch.from_numpy(c["vs"])).numpy()
    np.testing.assert_allclose(got, mine, atol=ATOL, rtol=RTOL)
    if q_len == 1:                 # the JAX oracle is decode-only
        want_r = np.asarray(jref.paged_attention_ref(
            *[jnp.asarray(c[k]) for k in ("q", "kq", "vq", "tables",
                                          "lengths")], window=window,
            k_scale=jnp.asarray(c["ks"]), v_scale=jnp.asarray(c["vs"])))
        np.testing.assert_allclose(got, want_r, atol=ATOL, rtol=RTOL)
    full = _port(c, window, pools=("kp", "vp"), scales=()).numpy()
    np.testing.assert_allclose(got, full, atol=QATOL, rtol=QRTOL)


def test_int8_paged_plain_bf16_query_matches_jax_kernel():
    c = _paged_case(2, 8, 2, 64, 16, 8, seed=21, q_len=2)
    got = _port(c, -1, q_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _jax_kernel(c, -1, q_dtype=jnp.bfloat16),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("window", [-1, 20])
def test_int8_dead_page_garbage_does_not_reach_the_output(window):
    c = _paged_case(3, 4, 2, 32, 16, 6, seed=4)
    dirty = _garbage(c)
    clean = _port(c, window)
    got = _port(dirty, window)
    assert torch.isfinite(got).all()
    assert torch.equal(got, clean)
    np.testing.assert_allclose(got.numpy(), _jax_kernel(c, window),
                               atol=ATOL, rtol=RTOL)


def test_int8_scale_checks():
    """The wrapper's scale checks (the card-only tests reach them through
    a launch; here they are called directly, on CPU tensors)."""
    kp = torch.zeros(5, 16, 2, 8, dtype=torch.int8)
    ok = torch.ones(5, 2)
    dev = kp.device
    assert tpa._check_scales(kp, ok, ok, dev) == (ok, ok)
    assert tpa._check_scales(kp.float(), None, None, dev) == ()
    with pytest.raises(ValueError, match="both"):
        tpa._check_scales(kp, ok, None, dev)
    with pytest.raises(TypeError, match="need k_scale"):
        tpa._check_scales(kp, None, None, dev)
    with pytest.raises(TypeError, match="int8 pools"):
        tpa._check_scales(kp.float(), ok, ok, dev)
    with pytest.raises(ValueError, match=r"\(P, KV\)"):
        tpa._check_scales(kp, torch.ones(5, 3), ok, dev)
    with pytest.raises(ValueError, match=r"\(P, KV\)"):
        tpa._check_scales(kp, ok, ok.double(), dev)
    with pytest.raises(ValueError, match="contiguous"):
        tpa._check_scales(kp, torch.ones(2, 5).t(), ok, dev)
