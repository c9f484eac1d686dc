"""The port's op counts (``repro_torch/launch/op_analysis.py``) and the
kernels' cost formulas (``repro_torch/kernels/cost.py``).

* ``kernels/cost.py`` gives PERF.md's bound column at the kernels
  table's shapes (within 0.5%).
* A kernel region counts its kernel's cost: the plain version's ATen ops
  inside it are not counted, so the CPU counts what the card counts.
* The projection and MLP products of one qwen3 smoke stage forward count
  the FLOPs JAX's ``hlo_analysis`` counts for the same products (JAX's
  attention twin forms all S x S scores, so attention is taken apart).
* Collective bytes on two gloo ranks are the transport's counters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import hlo_analysis as H
from repro.models import init as jinit
from repro.models import stage as jstage
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro_torch import configs as tconfigs
from repro_torch.core.profiler import H100_SXM
from repro_torch.kernels import cost
from repro_torch.kernels import ops
from repro_torch.launch.op_analysis import count, count_call
from repro_torch.models import init as tinit
from repro_torch.models import stage as tstage

BF16, F32 = torch.bfloat16, torch.float32
PAGE = 16


def _meta(shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _paged(heads, lengths, q_len=1, cache=1024, pool_dtype=BF16,
           window=-1):
    h, kv, dh = heads
    b = len(lengths)
    q = _meta((b, q_len, h, dh))
    kp = _meta((4 * b * cache // PAGE, PAGE, kv, dh), pool_dtype)
    tables = torch.zeros((b, cache // PAGE), dtype=torch.int32)
    scale = _meta((1, kv), F32) if pool_dtype == torch.int8 else None
    return cost.paged(q, kp, kp, tables, torch.tensor(lengths),
                      window=window, k_scale=scale)


def _flash(b, s, heads, dtype=BF16, window=-1, bwd=False):
    h, kv, dh = heads
    q, k = _meta((b, s, h, dh), dtype), _meta((b, s, kv, dh), dtype)
    fn = cost.flash_bwd if bwd else cost.flash_fwd
    return fn(q, k, k, causal=True, window=window)


def _wkv(shape, dtype, state):
    b, s, h, dh = shape
    r = _meta(shape, dtype)
    return cost.wkv6(r, r, r, r, _meta((h, dh), dtype),
                     _meta((b, h, dh, dh), F32) if state else None)


def _mamba(shape, bwd=False):
    b, s, ci, n = shape
    u, bc = _meta((b, s, ci), F32), _meta((b, s, n), F32)
    a, d = _meta((ci, n), F32), _meta((ci,), F32)
    if bwd:
        return cost.mamba_scan_bwd(u, u, a, bc, bc, d)
    return cost.mamba_scan(u, u, a, bc, bc, d, _meta((b, ci, n), F32))


G5, G1, G16, DH64, G7 = (40, 8, 128), (16, 16, 128), (32, 2, 128), \
    (16, 16, 64), (56, 8, 128)
DH120, DH256 = (32, 8, 120), (8, 4, 256)
# (PERF.md's kernels table row, its bound in ms as printed there, the
# count at its shape)
BOUNDS = [
    ("paged G5", "0.001304", lambda: _paged(G5, [528, 528])),
    ("paged G1", "0.00259", lambda: _paged(G1, [528, 528])),
    ("paged G16", "0.00033", lambda: _paged(G16, [528, 528])),
    ("paged Dh64", "0.00129", lambda: _paged(DH64, [528, 528])),
    ("paged G7", "0.00131", lambda: _paged(G7, [528, 528])),
    ("paged Dh120 window", "0.004700",
     lambda: _paged(DH120, [6160], cache=8192, window=4096)),
    ("paged Dh256", "0.001296",
     lambda: _paged(DH256, [528, 528], cache=2048)),
    ("verify Dh256", "0.001394",
     lambda: _paged(DH256, [549, 549], q_len=5, cache=2048)),
    ("verify G5", "0.001431", lambda: _paged(G5, [549, 549], q_len=5)),
    ("verify G16", "0.00037", lambda: _paged(G16, [528, 528], q_len=5)),
    ("int8 G5", "0.000659",
     lambda: _paged(G5, [528, 528], pool_dtype=torch.int8)),
    ("int8 Dh120", "0.002358", lambda: _paged(
        DH120, [6160], cache=8192, window=4096, pool_dtype=torch.int8)),
    ("int8 Dh256", "0.000651", lambda: _paged(
        DH256, [528, 528], cache=2048, pool_dtype=torch.int8)),
    ("flash G5", "0.0310", lambda: _flash(8, 528, G5)),
    ("flash G1", "0.02066", lambda: _flash(8, 528, G1)),
    ("flash G16", "0.02195", lambda: _flash(8, 528, G16)),
    ("flash Dh64", "0.01033", lambda: _flash(8, 528, DH64)),
    ("flash G7", "0.04132", lambda: _flash(8, 528, G7)),
    ("flash Dh120 window", "0.2606",
     lambda: _flash(1, 6144, DH120, window=4096)),
    ("flash Dh256", "0.0695", lambda: _flash(1, 4096, DH256)),
    ("flash Dh256 window", "0.0304",
     lambda: _flash(1, 4096, DH256, window=1024)),
    ("flash Dh256 f32", "1.026", lambda: _flash(1, 4096, DH256, F32)),
    ("flash Dh256 f32 window", "0.449",
     lambda: _flash(1, 4096, DH256, F32, window=1024)),
    ("bwd G5", "0.4344", lambda: _flash(1, 4096, G5, bwd=True)),
    ("bwd G1", "0.1738", lambda: _flash(1, 4096, G1, bwd=True)),
    ("bwd G16", "0.3475", lambda: _flash(1, 4096, G16, bwd=True)),
    ("bwd Dh64", "0.08688", lambda: _flash(1, 4096, DH64, bwd=True)),
    ("bwd G7", "0.6081", lambda: _flash(1, 4096, G7, bwd=True)),
    ("bwd Dh120", "0.3258", lambda: _flash(1, 4096, DH120, bwd=True)),
    ("bwd Dh256", "0.1738", lambda: _flash(1, 4096, DH256, bwd=True)),
    ("bwd Dh256 window", "0.0760",
     lambda: _flash(1, 4096, DH256, window=1024, bwd=True)),
    ("bwd Dh256 f32", "2.565",
     lambda: _flash(1, 4096, DH256, F32, bwd=True)),
    ("bwd Dh256 f32 window", "1.122",
     lambda: _flash(1, 4096, DH256, F32, window=1024, bwd=True)),
    ("wkv6 prefill", "0.05259",
     lambda: _wkv((8, 1024, 32, 64), BF16, True)),
    ("wkv6_bwd", "0.0962", lambda: cost.wkv6_bwd(
        *[_meta((1, 4096, 32, 64))] * 4, _meta((32, 64)))),
    ("mamba_scan prefill", "0.06419",
     lambda: _mamba((2, 1024, 8192, 16))),
    ("mamba_scan_bwd", "0.2010",
     lambda: _mamba((1, 4096, 8192, 16), True)),
]


@pytest.mark.parametrize("row,bound_ms,fn", BOUNDS,
                         ids=[b[0] for b in BOUNDS])
def test_cost_gives_perf_md_bound_column(row, bound_ms, fn):
    """Within 0.5%, or half a unit of the table's last printed digit where
    that is wider (0.00033 is printed to two digits)."""
    seconds, _, _ = fn().bound(H100_SXM)
    want = float(bound_ms)
    digit = 10.0 ** -len(bound_ms.split(".")[1])
    assert 1e3 * seconds == pytest.approx(
        want, abs=max(5e-3 * want, digit / 2)), row


def test_bound_names_its_limit():
    assert _paged(G5, [528, 528]).bound()[1:] == ("bytes", "bytes")
    assert _flash(1, 4096, G5, bwd=True).bound()[1:] == ("operations",
                                                         "bf16")
    assert _mamba((2, 1024, 8192, 16)).bound()[1:] == ("operations",
                                                        "sfu_exp")
    assert _flash(1, 4096, DH256, F32).bound()[2] == "fp32"


def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    return n


def _kernel_calls():
    """Each kernel entry point on the CPU, with its cost at its args."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 9, 4, 8, generator=g)
    k = torch.randn(2, 9, 2, 8, generator=g)
    pq = torch.randn(3, 4, 8, generator=g)
    pool = torch.randn(12, 4, 2, 8, generator=g)
    tables = torch.tensor([[0, 1, 2], [3, 4, -1], [5, -1, -1]],
                          dtype=torch.int32)
    lens = torch.tensor([10, 6, 3], dtype=torch.int32)
    r = torch.randn(1, 6, 2, 4, generator=g)
    w = torch.rand(1, 6, 2, 4, generator=g) * 0.5 + 0.4
    u = torch.randn(2, 4, generator=g)
    x = torch.randn(1, 6, 8, generator=g)
    dt = torch.rand(1, 6, 8, generator=g) * 0.1
    A = -torch.rand(8, 4, generator=g)
    Bm = torch.randn(1, 6, 4, generator=g)
    D = torch.randn(8, generator=g)
    return [
        ("flash_attention", lambda: ops.flash_attention(q, k, k, window=5),
         cost.flash_fwd(q, k, k, window=5)),
        ("paged_attention",
         lambda: ops.paged_attention(pq, pool, pool, tables, lens),
         cost.paged(pq, pool, pool, tables, lens)),
        ("wkv6", lambda: ops.wkv6(r, r, r, w, u),
         cost.wkv6(r, r, r, w, u)),
        ("mamba_scan", lambda: ops.mamba_scan(x, dt, A, Bm, Bm, D),
         cost.mamba_scan(x, dt, A, Bm, Bm, D)),
    ]


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention",
                                  "wkv6", "mamba_scan"])
def test_plain_version_counts_its_kernels_cost(name):
    fn, want = {n: (f, c) for n, f, c in _kernel_calls()}[name]
    got = count(fn)
    assert got.kernel_calls == {name: 1}
    assert (got.flops, got.hbm_bytes) == (want.flops, want.bytes)
    assert got.aten_ops == 0          # the plain version's ops: inside


@pytest.mark.parametrize("kernel", ["flash_attention", "wkv6",
                                    "mamba_scan"])
def test_backward_counts_its_kernels_cost(kernel):
    g = torch.Generator().manual_seed(1)
    if kernel == "flash_attention":
        q = torch.randn(1, 7, 4, 8, generator=g, requires_grad=True)
        k = torch.randn(1, 7, 2, 8, generator=g, requires_grad=True)
        args = (q, k, k)

        def run():
            return ops.flash_attention(*args).sum()
        want = cost.flash_fwd(q, k, k).flops + cost.flash_bwd(q, k, k).flops
    elif kernel == "wkv6":
        r = torch.randn(1, 5, 2, 4, generator=g, requires_grad=True)
        w = (torch.rand(1, 5, 2, 4, generator=g) * 0.5 + 0.4)
        u = torch.randn(2, 4, generator=g)

        def run():
            return ops.wkv6(r, r, r, w, u)[0].sum()
        want = cost.wkv6(r, r, r, w, u).flops + cost.wkv6_bwd(
            r, r, r, w, u).flops
    else:
        x = torch.randn(1, 5, 8, generator=g, requires_grad=True)
        dt = torch.rand(1, 5, 8, generator=g) * 0.1
        A, Bm = -torch.rand(8, 4, generator=g), torch.randn(1, 5, 4,
                                                           generator=g)
        D = torch.randn(8, generator=g)

        def run():
            return ops.mamba_scan(x, dt, A, Bm, Bm, D)[0].sum()
        want = cost.mamba_scan(x, dt, A, Bm, Bm, D).flops + \
            cost.mamba_scan_bwd(x, dt, A, Bm, Bm, D).flops

    def step():
        run().backward()
    got = count(step)
    assert got.kernel_calls == {kernel: 1, f"{kernel}_bwd": 1}
    assert got.kernel_flops == want
    assert got.flops == got.kernel_flops      # sum / backward of sum: 0


def test_aten_counts_products_and_operand_bytes():
    a, b = torch.randn(6, 5), torch.randn(5, 3)
    got = count(lambda: (a @ b).relu_().t().contiguous())
    assert got.flops == 2 * 6 * 5 * 3
    assert got.flops_by_op == {"aten.mm": 180}
    # mm: 30 + 15 in, 18 out; relu_: 18 in, 18 out; t: a view, nothing;
    # clone: 18 in, 18 out (f32)
    assert got.bytes_by_op["aten.mm"] == 4 * (30 + 15 + 18)
    assert "aten.t" not in got.bytes_by_op
    assert got.hbm_bytes == 4 * (30 + 15 + 18 + 18 + 18 + 18 + 18)


@pytest.mark.parametrize("arch", ["qwen3-14b", "rwkv6-1.6b"])
def test_meta_counts_equal_cpu_counts(arch):
    """A step on ``meta`` counts what it counts on the CPU (the dry run's
    premise): a smoke cell's train step, through the flash kernel's plain
    version or the wkv6 plain versions' shapes-only path on ``meta``."""
    from repro_torch.launch.cell import build_cell
    n = _one_thread()
    try:
        got = {}
        for dev in ("cpu", "meta"):
            cell = build_cell(arch, "train_4k", smoke=True, seq_len=12,
                              global_batch=4, device=dev)
            got[dev] = count(cell.run)
    finally:
        torch.set_num_threads(n)
    cpu, meta = got["cpu"], got["meta"]
    assert meta.flops == cpu.flops > 0
    assert meta.kernel_calls == cpu.kernel_calls
    # on meta a leaf's optimizer update is one chunk (no allocation to
    # bound); the smoke leaves are one chunk anyway
    assert meta.bytes_by_op == cpu.bytes_by_op


def test_stage_products_match_jax_hlo_dot_flops():
    """The projections and the MLP of one qwen3 smoke stage (2 layers,
    B 2 x S 12) in fp32: the port's ``aten.mm`` / ``bmm`` FLOPs equal
    JAX's ``hlo_analysis`` dot FLOPs less its attention twin's two S x S
    products a layer (the port's attention is the flash kernel's
    region)."""
    jspec = jconfigs.get("qwen3-14b").smoke_spec()
    tspec = tconfigs.get("qwen3-14b").smoke_spec()
    jplan = JPlan(pp=2, tp=1, microbatches=1)
    tplan = tconfigs.get("qwen3-14b").SMOKE_PLAN
    params, _ = jinit.init_params(jspec, jplan, jax.random.key(3),
                                  jnp.float32)
    b, s = 2, 12
    x = np.random.default_rng(0).standard_normal(
        (b, s, jspec.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jst = jstage.make_statics(jspec, jplan, tokens_per_mb=b * s)
    wp = jax.tree.map(lambda a: a[0:1], params["stages"])

    def jf(w, x_):
        return jstage.stage_fwd(w, x_, jst, positions=jnp.asarray(pos),
                                windows=params["layer_windows"][0],
                                thetas=params["layer_thetas"][0],
                                tp_axis=None)[0]

    text = jax.jit(jf).lower(wp, jnp.asarray(x)).compile().as_text()
    jax_dots = H.analyze(text).flops
    layers = jspec.n_layers // jplan.pp
    attn = layers * 2 * 2 * b * jspec.n_heads * s * s * jspec.d_head
    tparams = tinit.params_from_numpy(jax.tree.map(np.asarray, params),
                                      "cpu", torch.float32)
    tst = tstage.make_statics(tspec, tplan, tokens_per_mb=b * s)
    sp = tstage.stage_params(tparams, 0)
    with torch.no_grad():
        _, got = count_call(
            tstage.stage_fwd, sp, torch.from_numpy(x), tst,
            positions=torch.from_numpy(pos.copy()),
            windows=tparams["layer_windows"][0],
            thetas=tparams["layer_thetas"][0])
    products = sum(v for op, v in got.flops_by_op.items()
                   if op in ("aten.mm", "aten.bmm", "aten.addmm"))
    assert products == got.flops - got.kernel_flops
    assert products == jax_dots - attn
    assert got.kernel_calls == {"flash_attention": layers}
