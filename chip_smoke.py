#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build — compile every CUDA kernel of ``src/repro_torch/kernels/csrc``
   from the checkout's sources (one nvcc per source, in parallel);
2. kernels — each kernel against its plain PyTorch version on the card,
   at the main path's shapes, in bf16 and f32, with stated tolerances;
3. serve — qwen3-14b at full width (d 5120, 40 heads, 8 KV heads, Dh 128,
   d_ff 17408, vocab 151936), bf16, random seeded weights, ``serve_1f``
   with pp = 2 on the one card: R = 4 slots × 2 rows, prefill 512,
   cache_len 1024, page size 16, 16 decode steps through the paged
   kernel; then ``full_transformer`` (the flash kernel) over the served
   sequence.  Launch counters are zeroed before and read after each;
4. consistency — fp32 at full width and 2 layers: the paged engine's
   hidden states and pools against the dense-cache engine's, and
   ``full_transformer`` logits against the engine's last-position logits.

Prints one ``kernels`` JSON line (launches, errors, times, bounds), the
card's name and power limit, and last ``{"ok": true, "device": ...}``.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a
# kernel is the larger of bytes / HBM rate and operations / peak rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50 * 2**20          # H100 SXM L2 cache (data sheet)

SEED = 0
N_DECODE = 16
PREFILL = 512
CACHE_LEN = 1024
PAGE = 16
R_SLOTS, ROWS = 4, 2
TOL = {"float32": (2e-5, 1e-3), "bfloat16": (2e-2, 1e-2)}  # (atol, rtol)


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name, got, want, atol, rtol):
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} "
                             f"exceeds atol {atol} + rtol {rtol}")
    return float(err.max().item())


def time_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------
# phase 1: build
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} kernels built in "
        f"{time.perf_counter() - t0:.2f}s: {sorted(paths)}")
    for name in sorted(paths):
        report = (_build.BUILD_DIR / f"{name}.log")
        for line in (report.read_text().splitlines() if report.exists() else []):
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def paged_inputs(dtype, device, q_len, lengths, seed, n_copies=1):
    """Main-path paged call: rows × KV-head tiles over the flattened pool
    (pool_pages · rows pages), tables of one slot's pages per lane.
    Unreferenced pages, and keys past each length, hold NaN."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    H, KV, DH = 40, 8, 128
    b = ROWS
    n_pages = CACHE_LEN // PAGE
    pool = R_SLOTS * n_pages * b
    rng = np.random.default_rng(seed)
    perm = rng.permutation(pool)
    tables = np.full((b, n_pages), -1, np.int32)
    used = 0
    for r in range(b):
        need = -(-int(lengths[r]) // PAGE)
        tables[r, :need] = perm[used:used + need]
        used += need
    sets = []
    for _ in range(n_copies):
        q = torch.randn((b, q_len, H, DH), generator=g, device=device).to(dtype)
        kp = torch.full((pool, PAGE, KV, DH), float("nan"), device=device,
                        dtype=dtype)
        vp = kp.clone()
        for r in range(b):
            for i, pid in enumerate(tables[r][tables[r] >= 0]):
                n = min(PAGE, int(lengths[r]) - i * PAGE)
                kp[pid, :n] = torch.randn((n, KV, DH), generator=g,
                                          device=device).to(dtype)
                vp[pid, :n] = torch.randn((n, KV, DH), generator=g,
                                          device=device).to(dtype)
        sets.append((q, kp, vp))
    tab = torch.from_numpy(tables).to(device)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return sets, tab, lens


def paged_bytes_flops(q, kp, tables, lengths, window):
    """Bytes the call must move (q, live K/V pages, tables, lengths, out)
    and the operations it does on the keys this run's data makes
    visible."""
    b, ql, h, dh = q.shape
    page, kv = kp.shape[1], kp.shape[2]
    esz = q.element_size()
    pages, pairs = 0, 0
    for r in range(b):
        ln = int(lengths[r])
        lo = max(0, ln - ql - window + 1) if window > 0 else 0
        pages += len(range(lo // page, -(-ln // page)))
        for qi in range(ql):
            qpos = ln - ql + qi
            pairs += qpos + 1 - (max(0, qpos - window + 1) if window > 0 else 0)
    kv_bytes = 2 * pages * page * kv * dh * esz
    nbytes = 2 * q.numel() * esz + kv_bytes + tables.numel() * 4 + b * 4
    return nbytes, 4 * pairs * h * dh


def phase_kernels(device):
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    errs = {"paged_attention": 0.0, "flash_attention": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        atol, rtol = TOL[str(dtype).split(".")[-1]]
        for q_len, window, lengths in ((1, -1, [PREFILL + 5, PREFILL + 16]),
                                       (3, -1, [300, PREFILL + 16]),
                                       (1, 100, [PREFILL + 9, 77]),
                                       (3, 40, [PREFILL + 3, 129])):
            sets, tab, lens = paged_inputs(dtype, device, q_len, lengths,
                                           seed=q_len * 7 + len(lengths))
            q, kp, vp = sets[0]
            got = pa.paged_attention(q, kp, vp, tab, lens, window=window)
            want = pa.paged_attention_plain(q, kp, vp, tab, lens,
                                            window=window)
            torch.cuda.synchronize()
            e = check_close(f"paged {dtype} Q={q_len} w={window}", got, want,
                            atol, rtol)
            errs["paged_attention"] = max(errs["paged_attention"], e)
            log(f"[kernels] paged {str(dtype)[6:]} Q={q_len} window={window} "
                f"lengths={lengths}: max|err| {e:.3e} (atol {atol}, rtol {rtol})")
        g = torch.Generator(device=device).manual_seed(1)
        for b, sq, window in ((R_SLOTS * ROWS, PREFILL + N_DECODE, -1),
                              (R_SLOTS * ROWS, PREFILL + N_DECODE, 64),
                              (3, 500, -1), (2, 77, 20)):
            q = torch.randn((b, sq, 40, 128), generator=g, device=device).to(dtype)
            k = torch.randn((b, sq, 8, 128), generator=g, device=device).to(dtype)
            v = torch.randn((b, sq, 8, 128), generator=g, device=device).to(dtype)
            got = fa.flash_attention(q, k, v, causal=True, window=window)
            want = fa.flash_attention_plain(q, k, v, causal=True,
                                            window=window)
            torch.cuda.synchronize()
            e = check_close(f"flash {dtype} B={b} S={sq} w={window}", got,
                            want, atol, rtol)
            errs["flash_attention"] = max(errs["flash_attention"], e)
            log(f"[kernels] flash {str(dtype)[6:]} B={b} S={sq} H=40/KV=8 "
                f"window={window}: max|err| {e:.3e} (atol {atol}, rtol {rtol})")
    log("[kernels] " + json.dumps({"max_abs_err": errs, "tolerance": TOL}))
    return errs


# --------------------------------------------------------------------------
# phase 3: full-width serving
# --------------------------------------------------------------------------

def phase_serve(device, spec, plan):
    """Serve ``spec`` in bf16 through the paged engine; returns the
    session, the prompts and the generated tokens (N_DECODE + 1, B)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import build_serving
    session = build_serving(spec, plan, cache_len=CACHE_LEN,
                            global_batch=R_SLOTS * ROWS,
                            compute_dtype=torch.bfloat16, page_size=PAGE,
                            device=device)
    t0 = time.perf_counter()
    session.start(SEED)
    torch.cuda.synchronize()
    log(f"[serve] {spec.name}: {spec.n_layers} layers, d {spec.d_model}, "
        f"heads {spec.n_heads}/{spec.n_kv}, Dh {spec.d_head}, d_ff "
        f"{spec.d_ff}, vocab {spec.vocab}; pp={plan.pp} R={session.n_slots} "
        f"rows={session.rows}; weights initialized in "
        f"{time.perf_counter() - t0:.2f}s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, spec.vocab, (R_SLOTS, ROWS, PREFILL)
                           ).astype(np.int32)
    pa.paged_attention.launches = 0
    t0 = time.perf_counter()
    nxt = session.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    toks = [nxt]
    step_s = []
    per_step = spec.n_layers * session.n_slots
    for i in range(N_DECODE):
        before = pa.paged_attention.launches
        t0 = time.perf_counter()
        nxt = session.decode(nxt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        grew = pa.paged_attention.launches - before
        if grew != per_step:
            raise AssertionError(f"decode step {i}: paged kernel launched "
                                 f"{grew} times, expected {per_step}")
        toks.append(nxt)
    launches = pa.paged_attention.launches
    if launches != per_step * N_DECODE:
        raise AssertionError(f"paged kernel launched {launches} times")
    toks = torch.stack(toks).cpu().numpy()
    if not ((toks >= 0) & (toks < spec.vocab)).all():
        raise AssertionError("served token ids outside the vocabulary")
    session._alloc.check()
    ms = 1e3 * float(np.mean(step_s))
    log(f"[serve] prefill {PREFILL} tokens x {R_SLOTS * ROWS} rows: "
        f"{t_prefill:.3f}s; decode {N_DECODE} steps: {ms:.2f} ms/step, "
        f"{R_SLOTS * ROWS * 1e3 / ms:.1f} tokens/s; paged kernel launches "
        f"{launches} = {spec.n_layers} layers x R {session.n_slots} x "
        f"{N_DECODE} steps")
    return session, prompts, toks, launches, {
        "prefill_s": t_prefill, "decode_ms_per_step": ms,
        "decode_tokens_per_s": R_SLOTS * ROWS * 1e3 / ms}


def reference_forward(session, prompts, toks):
    """``full_transformer`` over prompt + fed tokens; returns the f32
    last-position logits (B, Vpad)."""
    import torch
    from repro_torch.models import lm_head
    from repro_torch.models.stage import full_transformer
    p, dev = session.params, session.device
    seq = np.concatenate([prompts.reshape(-1, prompts.shape[-1]),
                          toks[:-1].T], axis=1)
    seq_t = torch.from_numpy(seq).to(dev)
    x = lm_head.embed_tokens(p["embed"], seq_t, session.compute_dtype)
    pos = torch.arange(seq.shape[1], device=dev).expand(seq.shape[0], -1)
    h = full_transformer(p, x, session.statics, positions=pos)
    fn = p["final_norm"]
    return lm_head.last_logits(p["head"], fn["scale"], h[:, -1:],
                               norm_kind=session.spec.norm,
                               norm_bias=fn.get("bias"),
                               vocab=session.spec.vocab)


def phase_reference(session, prompts, toks):
    """The flash kernel's main path: full_transformer over the served
    sequence at full width."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    fa.flash_attention.launches = 0
    t0 = time.perf_counter()
    logits = reference_forward(session, prompts, toks)
    torch.cuda.synchronize()
    launches = fa.flash_attention.launches
    if launches != session.spec.n_layers:
        raise AssertionError(f"flash kernel launched {launches} times, "
                             f"expected {session.spec.n_layers}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite reference logits")
    agree = float((logits.argmax(-1).cpu().numpy() == toks[-1]).mean())
    log(f"[reference] full_transformer bf16 over {prompts.shape[-1]} + "
        f"{toks.shape[0] - 1} tokens: {time.perf_counter() - t0:.3f}s, flash "
        f"kernel launches {launches}; last greedy token agrees with the "
        f"served one on {agree:.3f} of rows (bf16, "
        f"{session.spec.n_layers} layers: informative, not asserted)")
    return launches


# --------------------------------------------------------------------------
# phase 4: consistency at full width, reduced depth, fp32
# --------------------------------------------------------------------------

def phase_consistency(device, spec, plan, n_decode=6):
    import torch
    from repro_torch.serving.engine import build_serving
    sessions = {}
    rng = np.random.default_rng(SEED + 1)
    prompts = rng.integers(0, spec.vocab, (R_SLOTS, ROWS, PREFILL)
                           ).astype(np.int32)
    hidden = {}
    toks = {}
    for kind, page in (("paged", PAGE), ("dense", 0)):
        s = build_serving(spec, plan, cache_len=CACHE_LEN,
                          global_batch=R_SLOTS * ROWS,
                          compute_dtype=torch.float32, page_size=page,
                          device=device).start(SEED)
        nxt = s.prefill({"tokens": prompts})
        hs, ts = [s.last_hidden.clone()], [nxt]
        for _ in range(n_decode):
            nxt = s.decode(nxt)
            hs.append(s.last_hidden.clone())
            ts.append(nxt)
        sessions[kind], hidden[kind] = s, hs
        toks[kind] = torch.stack(ts).cpu().numpy()
    atol = rtol = 1e-4
    err_h = max(check_close(f"hidden step {i}", a, b, atol, rtol)
                for i, (a, b) in enumerate(zip(hidden["paged"],
                                               hidden["dense"])))
    paged, dense = sessions["paged"], sessions["dense"]
    n_keys = PREFILL + n_decode
    err_kv = 0.0
    for name, (kp, vp) in paged.pages.items():
        ck, cv = dense.cache[name]["kv"]
        for pool, cache in ((kp, ck), (vp, cv)):
            for m in range(R_SLOTS):
                ids = torch.from_numpy(paged._alloc.tables[m]).long()
                ids = ids[ids >= 0].to(device)
                got = pool[:, ids].transpose(1, 2).reshape(
                    pool.shape[0], ROWS, -1, *pool.shape[-2:])[:, :, :n_keys]
                err_kv = max(err_kv, check_close(
                    f"{name} slot {m} pool", got, cache[:, m, :, :n_keys],
                    atol, rtol))
    if not (paged._pos == dense._pos).all():
        raise AssertionError("paged and dense positions differ")
    logits_ref = reference_forward(paged, prompts, toks["paged"])
    fn = paged.params["final_norm"]
    from repro_torch.models import lm_head
    logits_eng = lm_head.last_logits(paged.params["head"], fn["scale"],
                                     paged.last_hidden, vocab=spec.vocab)
    err_l = check_close("full_transformer vs engine logits", logits_eng,
                        logits_ref, 1e-3, 1e-3)
    same = float((toks["paged"] == toks["dense"]).mean())
    log(f"[consistency] fp32 {spec.n_layers} layers at full width: hidden "
        f"max|err| {err_h:.3e}, pools vs dense caches {err_kv:.3e} "
        f"(atol/rtol {atol}); full_transformer vs engine logits "
        f"{err_l:.3e} (atol/rtol 1e-3); paged/dense tokens agree on "
        f"{same:.3f}")


# --------------------------------------------------------------------------
# the kernels line
# --------------------------------------------------------------------------

def kernel_records(device, errs, launches):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    bf16 = torch.bfloat16
    # paged, one decode call of the main path.  A call reads only its live
    # pages (~4.3 MB of K and V), so enough input sets are cycled that
    # their live pages fill L2 four times over and come from HBM
    lengths = [PREFILL + N_DECODE, PREFILL + N_DECODE]
    live = 2 * sum(-(-n // PAGE) for n in lengths) * PAGE * 8 * 128 * 2
    n_sets = -(-4 * L2_BYTES // live)
    sets, tab, lens = paged_inputs(bf16, device, 1, lengths, seed=5,
                                   n_copies=n_sets)
    it = {"i": 0}

    def run(fn):
        def call():
            q, kp, vp = sets[it["i"] % n_sets]
            it["i"] += 1
            fn(q, kp, vp, tab, lens)
        return call

    p_ms = time_ms(run(pa.paged_attention))
    p_plain = time_ms(run(pa.paged_attention_plain))
    nbytes, flops = paged_bytes_flops(sets[0][0], sets[0][1], tab, lengths, -1)
    p_bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"])
    # flash, the main path's full_transformer call
    g = torch.Generator(device=device).manual_seed(2)
    b, s = R_SLOTS * ROWS, PREFILL + N_DECODE
    q = torch.randn((b, s, 40, 128), generator=g, device=device).to(bf16)
    k = torch.randn((b, s, 8, 128), generator=g, device=device).to(bf16)
    v = torch.randn((b, s, 8, 128), generator=g, device=device).to(bf16)
    f_ms = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    f_plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    f_lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    f_flops = 4 * b * 40 * 128 * s * (s + 1) / 2
    f_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    f_bound = 1e3 * max(f_flops / PEAK_FLOPS["bfloat16"],
                        f_bytes / HBM_BYTES_PER_S)
    return [
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:51",
         "launches": launches["paged_attention"],
         "max_abs_err": errs["paged_attention"], "tolerance": TOL, "ms": p_ms,
         "plain_ms": p_plain, "bound_ms": p_bound,
         "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                      >= flops / PEAK_FLOPS["bfloat16"] else "operations"),
         "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:39",
         "launches": launches["flash_attention"],
         "max_abs_err": errs["flash_attention"], "tolerance": TOL, "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound,
         "bound_by": ("operations" if f_flops / PEAK_FLOPS["bfloat16"]
                      >= f_bytes / HBM_BYTES_PER_S else "bytes"),
         "library_ms": f_lib},
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch import configs
    t_start = time.perf_counter()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build()
    errs = phase_kernels(device)

    cfg = configs.get("qwen3-14b")
    full = cfg.full_spec()
    plan = cfg.PLAN.with_(tp=1, decode_microbatches=R_SLOTS)
    session, prompts, toks, paged_launches, serve = phase_serve(
        device, full, plan)
    flash_launches = phase_reference(session, prompts, toks)
    del session
    torch.cuda.empty_cache()

    short = dataclasses.replace(full, name="qwen3-14b-2l", n_layers=2,
                                blocks=full.blocks[:2])
    phase_consistency(device, short, plan)

    records = kernel_records(device, errs, {
        "paged_attention": paged_launches, "flash_attention": flash_launches})
    log(f"[done] {time.perf_counter() - t_start:.1f}s; serve {serve}")
    print(json.dumps({"kernels": records}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
