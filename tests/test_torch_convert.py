"""Checkpoint ingest in the port (``repro_torch/checkpoint``) against the
JAX package's converter and the ``safetensors`` package, on the CPU.

The port reads and writes safetensors with its own numpy code: its files
equal the package's byte for byte, and it reads the package's.  Its
``convert`` writes the JAX converter's chunk files array for array,
each package loads the other's directories, and every ``ConvertError``
of tests/test_convert.py says what JAX's says.  Both engines serve the
same converted directory alike.  Pinned here: JAX's converter reads
BF16 only because importing jax registers numpy's ``bfloat16`` (the
``safetensors`` package's numpy reader alone cannot); its CLI without
``--smoke`` asks configs for a ``spec()`` they do not have; and its
export writes every transposed tensor in memory order, so the file does
not read back as the checkpoint it exported."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save as st_save_np
from safetensors.torch import save as st_save_torch

import _torch_config_cases as C
from _torch_train_jax import leaves, one_torch_thread  # noqa: F401
from repro import configs as jconfigs
from repro.checkpoint import convert as jcv
from repro.launch.mesh import make_host_mesh
from repro.models import nn as jnn
from repro.models import spec as jspec_lib
from repro.models import stage as jstage
from repro.models import lm_head as jlm
from repro.parallel.mesh import ParallelismPlan as JPlan
from repro.parallel.mesh import split_model_axis
from repro.serving.engine import build_serving as jax_build_serving
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import convert as tcv
from repro_torch.checkpoint import safetensors as tst
from repro_torch.launch import serve as tserve
from repro_torch.models import lm_head as tlm
from repro_torch.models import spec as tspec_lib
from repro_torch.parallel.plan import ParallelismPlan as TPlan

PLANS = [(1, 1), (2, 1), (2, 2)]
LOGIT_TOL = 1e-3


def _same_trees(a, b):
    la, lb = leaves(a), leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


# --------------------------------------------------------------------------
# the format: the port's reader and writer against the safetensors package
# --------------------------------------------------------------------------

def _mixed(rng):
    return {"b.weight": rng.standard_normal((3, 5)).astype(np.float32),
            "a.scale": rng.standard_normal(7).astype(np.float16),
            "c.ids": np.arange(6, dtype=np.int64).reshape(2, 3),
            "B.q": rng.integers(-100, 100, 9).astype(np.int8),
            "e.empty": np.zeros((0, 4), np.float32),
            "f.mask": np.array([True, False, True]),
            "g.f64": rng.standard_normal((2, 2))}


@pytest.mark.parametrize("metadata", [None, {"format": "np"}])
def test_writer_equals_the_safetensors_package_byte_for_byte(tmp_path,
                                                             metadata):
    """C-contiguous tensors of every dtype, with and without metadata
    (one key: the package keeps metadata in a hash map, so the order of
    several keys varies from call to call)."""
    tensors = _mixed(np.random.default_rng(0))
    tst.save_file(tensors, str(tmp_path / "x.safetensors"), metadata)
    assert (tmp_path / "x.safetensors").read_bytes() == \
        st_save_np(tensors, metadata=metadata)


def test_reader_reads_the_packages_files(tmp_path):
    tensors = _mixed(np.random.default_rng(1))
    path = tmp_path / "x.safetensors"
    path.write_bytes(st_save_np(tensors, metadata={"format": "np"}))
    got = list(tst.iter_tensors(str(path)))
    with safe_open(str(path), framework="numpy") as f:
        assert [k for k, _ in got] == list(f.keys())
        for key, arr in got:
            want = f.get_tensor(key)
            assert arr.dtype == want.dtype and arr.shape == want.shape
            np.testing.assert_array_equal(arr, want)
    _, meta = tst.read_header(str(path))
    assert meta == {"format": "np"}


def test_bf16_written_and_read_as_the_package_and_torch_do(tmp_path):
    """``dtype="BF16"`` rounds to nearest even as torch does (the file
    equals the package's torch writer's), and the reader widens BF16 to
    float32 exactly (torch's ``bfloat16 -> float``)."""
    rng = np.random.default_rng(2)
    f32 = {"w": rng.standard_normal((33, 17)).astype(np.float32) * 3,
           "ids": np.arange(5, dtype=np.int32)}
    f32["w"][0, :4] = [np.inf, -np.inf, 0.0, -0.0]
    path = tmp_path / "b.safetensors"
    tst.save_file(f32, str(path), dtype="BF16")
    want = {"w": torch.from_numpy(f32["w"]).bfloat16(),
            "ids": torch.from_numpy(f32["ids"])}
    assert path.read_bytes() == st_save_torch(want)
    got = tst.load_file(str(path))
    assert got["w"].dtype == np.float32 and got["ids"].dtype == np.int32
    np.testing.assert_array_equal(got["w"], want["w"].float().numpy())
    np.testing.assert_array_equal(got["ids"], f32["ids"])


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b"])
def test_sharded_fixture_equals_jax_file_for_file(tmp_path, arch):
    """The port's ``make_synthetic_checkpoint`` (3 shards and an index)
    draws JAX's tensors and writes JAX's files byte for byte."""
    jspec, tspec = C.specs(arch)
    jt = jcv.make_synthetic_checkpoint(str(tmp_path / "j"), jspec, seed=3,
                                       shards=3)
    tt = tcv.make_synthetic_checkpoint(str(tmp_path / "t"), tspec, seed=3,
                                       shards=3)
    _same_trees(tt, jt)
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 4
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == \
            (tmp_path / "t" / n).read_bytes(), n
    assert tcv.resolve_shards(str(tmp_path / "t")) == \
        [str(tmp_path / "t" / n) for n in names if n.startswith("model-")]


# --------------------------------------------------------------------------
# convert / load across the two packages
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """JAX's fixture of each smoke spec (one F32 file), and both
    packages' conversions of it at every plan."""
    root = tmp_path_factory.mktemp("convert")
    out = {}
    for arch in ("qwen3-14b", "olmoe-1b-7b"):
        jspec, tspec = C.specs(arch)
        fix = str(root / f"{arch}.safetensors")
        tensors = jcv.make_synthetic_checkpoint(fix, jspec, seed=1)
        for pp, v in PLANS:
            dirs = {}
            for pkg, cv, spec in (("jax", jcv, jspec), ("port", tcv, tspec)):
                d = str(root / f"{arch}-{pp}-{v}-{pkg}")
                mf = cv.convert(fix, d, spec, pp=pp, virtual_stages=v)
                dirs[pkg] = (d, mf)
            out[arch, pp, v] = dirs
        out[arch] = (fix, tensors)
    return out


CASES = [(a, pp, v) for a in ("qwen3-14b", "olmoe-1b-7b") for pp, v in PLANS]


@pytest.mark.parametrize("arch,pp,v", CASES)
def test_convert_writes_the_jax_chunk_files(fixtures, arch, pp, v):
    (jd, jmf), (td, tmf) = fixtures[arch, pp, v]["jax"], \
        fixtures[arch, pp, v]["port"]
    assert tmf == jmf
    with open(os.path.join(td, tcv.MANIFEST_NAME)) as f:
        assert json.load(f) == jmf
    names = sorted(os.listdir(jd))
    assert names == sorted(os.listdir(td))
    assert len([n for n in names if n.startswith("chunk_")]) == pp * v
    for n in names:
        if not n.endswith(".npz"):
            continue
        with np.load(os.path.join(jd, n)) as a, \
                np.load(os.path.join(td, n)) as b:
            assert sorted(a.files) == sorted(b.files), n
            for k in a.files:
                assert a[k].dtype == b[k].dtype == np.float32
                np.testing.assert_array_equal(b[k], a[k], err_msg=(n, k))


@pytest.mark.parametrize("arch,pp,v", CASES)
def test_each_package_loads_the_others_directory(fixtures, arch, pp, v):
    jspec, tspec = C.specs(arch)
    jd, td = (fixtures[arch, pp, v][k][0] for k in ("jax", "port"))
    tp_from_j, _ = tcv.load_converted(jd, tspec)
    jp_from_t, _ = jcv.load_converted(td, jspec)
    jp_from_j, _ = jcv.load_converted(jd, jspec)
    _same_trees(tp_from_j, jp_from_j)
    _same_trees(jp_from_t, jp_from_j)
    fix, tensors = fixtures[arch]
    _same_trees(tcv.hf_to_params(tensors, tspec, pp=pp, virtual_stages=v),
                tp_from_j)
    assert tp_from_j["layer_windows"].dtype == np.int32
    assert tp_from_j["layer_thetas"].dtype == np.float32


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b"])
def test_export_round_trips(fixtures, tmp_path, arch):
    """The port's export of its (2, 2) directory gives the fixture back,
    and so does the file, read by the ``safetensors`` package.  JAX's
    export returns the same tensors, but its file holds every tensor its
    inverse transposes (projections, experts, router, head) in memory
    order: the package's numpy writer takes each array's raw buffer, and
    a transpose is a view (ROADMAP Queue 3)."""
    jspec, tspec = C.specs(arch)
    fix, tensors = fixtures[arch]
    td = fixtures[arch, 2, 2]["port"][0]
    out = tcv.export_checkpoint(td, str(tmp_path / "t.safetensors"), tspec)
    jout = jcv.export_checkpoint(td, str(tmp_path / "j.safetensors"), jspec)
    assert sorted(out) == sorted(jout) == sorted(tensors)
    wrong = set()
    with safe_open(str(tmp_path / "t.safetensors"), "numpy") as ft, \
            safe_open(str(tmp_path / "j.safetensors"), "numpy") as fj:
        for k in tensors:
            np.testing.assert_array_equal(out[k], tensors[k])
            np.testing.assert_array_equal(jout[k], tensors[k])
            np.testing.assert_array_equal(ft.get_tensor(k), tensors[k])
            if not np.array_equal(fj.get_tensor(k), tensors[k]):
                wrong.add(k)
    strided = {k for k, a in jout.items() if not a.flags["C_CONTIGUOUS"]}
    assert wrong == strided
    assert {"model.layers.0.self_attn.q_proj.weight",
            "model.layers.0.self_attn.k_proj.weight"} <= wrong


# --------------------------------------------------------------------------
# ConvertError: the cases of tests/test_convert.py, both packages
# --------------------------------------------------------------------------

def _conv_spec(lib, n_layers=4, vocab=200):
    """tests/test_convert.py's dense spec in package ``lib``'s classes."""
    blocks = tuple(lib.BlockSpec(mixer="attn", ffn="dense")
                   for _ in range(n_layers))
    return lib.ModelSpec(
        name="conv-test", d_model=64, n_layers=n_layers, n_heads=4,
        n_kv=2, d_head=16, d_ff=128, vocab=vocab, blocks=blocks,
        norm="rmsnorm", act="silu", qk_norm=True)


def _unknown_key(cv, lib, d):
    cv.hf_to_params({"model.layers.0.self_attn.bogus.weight":
                     np.zeros((4, 4), np.float32)}, _conv_spec(lib), pp=2)


def _shape_mismatch(cv, lib, d):
    cv.hf_to_params({"model.layers.0.self_attn.q_proj.weight":
                     np.zeros((7, 7), np.float32)}, _conv_spec(lib), pp=2)


def _tp_indivisible(cv, lib, d):
    cv.hf_to_params({}, _conv_spec(lib), pp=2, tp=3)


def _layers_indivisible(cv, lib, d):
    cv.hf_to_params({}, _conv_spec(lib, n_layers=6), pp=4)


def _layer_out_of_range(cv, lib, d):
    cv.hf_to_params({"model.layers.9.input_layernorm.weight":
                     np.zeros((64,), np.float32)}, _conv_spec(lib), pp=2)


def _incomplete(cv, lib, d):
    spec = _conv_spec(lib)
    tensors = cv.make_synthetic_checkpoint(str(d / "m.safetensors"), spec,
                                           seed=6)
    del tensors["model.layers.3.mlp.down_proj.weight"]
    cv.hf_to_params(tensors, spec, pp=2)


def _missing_path(cv, lib, d):
    cv.resolve_shards(str(d / "nope"))


def _missing_indexed_shard(cv, lib, d):
    (d / "hf").mkdir()
    with open(d / "hf" / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {"a": "model-00001-of-00002.safetensors"}},
                  f)
    cv.resolve_shards(str(d / "hf"))


def _converted(cv, lib, d):
    spec = _conv_spec(lib)
    cv.make_synthetic_checkpoint(str(d / "m.safetensors"), spec, seed=7)
    cv.convert(str(d / "m.safetensors"), str(d / "ck"), spec, pp=2)
    return spec


def _wrong_spec(cv, lib, d):
    spec = _converted(cv, lib, d)
    cv.load_converted(str(d / "ck"),
                      dataclasses.replace(spec, name="other-spec"))


def _missing_chunk(cv, lib, d):
    spec = _converted(cv, lib, d)
    os.remove(d / "ck" / "chunk_0001.npz")
    cv.load_converted(str(d / "ck"), spec)


def _missing_manifest(cv, lib, d):
    cv.load_converted(str(d / "empty"), _conv_spec(lib))


ERRORS = {
    "unknown key": (_unknown_key, "unknown checkpoint key"),
    "shape mismatch": (_shape_mismatch, "does not match expected shape"),
    "tp indivisible": (_tp_indivisible, "does not divide axis"),
    "layers indivisible": (_layers_indivisible, "not divisible"),
    "layer out of range": (_layer_out_of_range, "out of range"),
    "incomplete": (_incomplete, "incomplete checkpoint"),
    "missing path": (_missing_path, "missing safetensors shard"),
    "missing indexed shard": (_missing_indexed_shard,
                              "missing safetensors shard"),
    "wrong spec": (_wrong_spec, "was converted for spec"),
    "missing chunk": (_missing_chunk, "missing chunk file"),
    "missing manifest": (_missing_manifest, "missing manifest"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_convert_errors_say_what_jax_says(tmp_path, case):
    """Each failure is a ConvertError (a ValueError) in both packages,
    with the same message (both run in the same directory)."""
    fn, pattern = ERRORS[case]
    msgs = []
    for cv, lib in ((jcv, jspec_lib), (tcv, tspec_lib)):
        d = tmp_path / "case"
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir()
        with pytest.raises(cv.ConvertError, match=pattern) as e:
            fn(cv, lib, d)
        assert isinstance(e.value, ValueError)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_shared_experts_are_refused_where_jax_drops_them(tmp_path):
    """deepseek's shared experts have no rule in either table.  JAX's
    converter builds a tree without ``moe.shared``; the port names the
    missing table instead."""
    jspec = jconfigs.get("deepseek-moe-16b").smoke_spec()
    tspec = tconfigs.get("deepseek-moe-16b").smoke_spec()
    tensors = jcv.make_synthetic_checkpoint(str(tmp_path / "m.safetensors"),
                                            jspec, seed=0)
    params = jcv.hf_to_params(tensors, jspec, pp=2)
    assert "shared" not in params["stages"]["layer_0"]["moe"]
    with pytest.raises(tcv.ConvertError, match="shared expert.*olmoe"):
        tcv.hf_to_params(tensors, tspec, pp=2)
    with pytest.raises(tcv.ConvertError, match="moe.shared"):
        tcv.make_synthetic_checkpoint(str(tmp_path / "t.safetensors"), tspec)


# --------------------------------------------------------------------------
# serving a converted directory
# --------------------------------------------------------------------------

def _jax_serve(jspec, params):
    mesh = split_model_axis(make_host_mesh(data=1, model=1), 1, 1)
    jplan = JPlan(pp=1, tp=1, microbatches=C.R, decode_microbatches=C.R,
                  schedule="serve_1f")
    js = jax_build_serving(jspec, jplan, mesh, cache_len=C.CACHE,
                           global_batch=C.R * C.ROWS, prefill_len=C.PREFILL,
                           compute_dtype=jnp.float32, page_size=C.PAGE)
    js.start(jax.random.key(0))
    js.load_params(params)
    prompts = C.prompts(jspec.vocab)
    nxt = js.prefill({"tokens": jnp.asarray(prompts)})
    toks = [np.asarray(nxt)]
    for _ in range(C.N_DEC):
        nxt = js.decode(nxt)
        toks.append(np.asarray(nxt))
    toks = np.stack(toks)
    # the JAX engine keeps no hidden state: full_transformer over the
    # served sequence, logits of its last position
    seq = np.concatenate([prompts.reshape(C.R * C.ROWS, C.PREFILL),
                          toks[:-1].T], axis=1)
    st = jstage.make_statics(jspec, jplan, tokens_per_mb=seq.size)
    jp = jax.tree.map(jnp.asarray, params)
    pos = np.broadcast_to(np.arange(seq.shape[1]), seq.shape)
    h, _ = jstage.full_transformer(
        jp, jlm.embed_tokens(jp["embed"], jnp.asarray(seq)), st,
        positions=jnp.asarray(pos))
    hn = jnn.rmsnorm(h[:, -1], jp["final_norm"]["scale"])
    logits = np.asarray(hn @ jp["head"])[:, :jspec.vocab]
    return toks, logits


@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b"])
def test_engines_serve_a_converted_directory_alike(fixtures, arch):
    """The port's engine on the port's (1, 1) directory against the JAX
    engine on JAX's: tokens equal, last logits within 1e-3; the port at
    pp 2 x v 2 (``serve_interleaved``) on that plan's directory serves
    the same tokens."""
    jspec, tspec = C.specs(arch)
    jparams, _ = jcv.load_converted(fixtures[arch, 1, 1]["jax"][0], jspec)
    want, want_logits = _jax_serve(jspec, jparams)
    tparams, _ = tcv.load_converted(fixtures[arch, 1, 1]["port"][0], tspec)
    got, sess = C.port_engine(arch, tparams, C.PAGE)
    np.testing.assert_array_equal(got, want)
    fn = sess.params["final_norm"]
    logits = tlm.last_logits(sess.params["head"], fn["scale"],
                             sess.last_hidden, vocab=tspec.vocab)
    np.testing.assert_allclose(logits[:, :tspec.vocab].numpy(), want_logits,
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    p22, _ = tcv.load_converted(fixtures[arch, 2, 2]["port"][0], tspec)
    got22, _ = C.port_engine(arch, p22, C.PAGE, pp=2, v=2)
    np.testing.assert_array_equal(got22, want)


def _serve_args(ckpt):
    return type("Args", (), {"ckpt": ckpt})()


def test_load_checkpoint_checks_the_plan_and_quantizes(fixtures):
    """``launch/serve.py::load_checkpoint``: a directory converted for
    another plan raises ConvertError naming the flags to reconvert with;
    the right one installs, quantized when the session asks for int8."""
    _, tspec = C.specs("olmoe-1b-7b")
    d11, d22 = (fixtures["olmoe-1b-7b", pp, v]["port"][0]
                for pp, v in ((1, 1), (2, 2)))

    def session(pp, v, weight_dtype=None):
        plan = TPlan(pp=pp, tp=1, decode_microbatches=C.R)
        if v > 1:
            plan = plan.with_(schedule="serve_interleaved", virtual_stages=v)
        from repro_torch.serving.engine import build_serving
        return build_serving(tspec, plan, cache_len=C.CACHE,
                             global_batch=C.R * C.ROWS,
                             compute_dtype=torch.float32, page_size=C.PAGE,
                             prefill_len=C.PREFILL, weight_dtype=weight_dtype,
                             device="cpu").start()

    sess = session(2, 2)
    assert sess.sched.storage_chunk_order().tolist() == [0, 2, 1, 3]
    with pytest.raises(tcv.ConvertError,
                       match="reconvert with --pp 2 --virtual-stages 2"):
        tserve.load_checkpoint(sess, tspec, _serve_args(d11))
    tserve.load_checkpoint(sess, tspec, _serve_args(d22))
    want, _ = tcv.load_converted(d22, tspec)
    np.testing.assert_array_equal(
        sess.params["stages"]["layer_0"]["moe"]["w1"].numpy(),
        want["stages"]["layer_0"]["moe"]["w1"])
    q = session(1, 1, "int8")
    tserve.load_checkpoint(q, tspec, _serve_args(d11))
    assert q.params["stages"]["layer_0"]["moe"]["w1"]["q"].dtype == \
        torch.int8


def test_serve_cli_serves_a_converted_directory(fixtures, capsys):
    d = fixtures["olmoe-1b-7b", 2, 1]["port"][0]
    tserve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                 "--page-size", "16", "--batch", "4", "--prefill", "8",
                 "--tokens", "3", "--cache-len", "32", "--ckpt", d])
    out = capsys.readouterr().out
    assert "loaded checkpoint" in out and "family=olmoe, 2 chunks" in out


# --------------------------------------------------------------------------
# the two reference faults
# --------------------------------------------------------------------------

def test_bf16_fixture_converts_as_jax_converts_it(tmp_path):
    """A BF16 fixture (2 shards and an index, the port's writer): the
    port's conversion equals JAX's of the same files and JAX's of the
    widened values stored as F32, bit for bit."""
    jspec, tspec = C.specs("olmoe-1b-7b")
    tensors = tcv.synthetic_tensors(tspec, seed=4)
    tcv.write_checkpoint(str(tmp_path / "bf16"), tensors, shards=2,
                         dtype="BF16")
    widened = {k: torch.from_numpy(v).bfloat16().float().numpy()
               for k, v in tensors.items()}
    tcv.write_checkpoint(str(tmp_path / "f32.safetensors"), widened)
    jcv.convert(str(tmp_path / "bf16"), str(tmp_path / "j16"), jspec, pp=2)
    jcv.convert(str(tmp_path / "f32.safetensors"), str(tmp_path / "j32"),
                jspec, pp=2)
    tcv.convert(str(tmp_path / "bf16"), str(tmp_path / "t"), tspec, pp=2)
    got = tcv.load_converted(str(tmp_path / "t"), tspec)[0]
    _same_trees(got, jcv.load_converted(str(tmp_path / "j16"), jspec)[0])
    _same_trees(got, jcv.load_converted(str(tmp_path / "j32"), jspec)[0])


def test_safetensors_numpy_reader_needs_jax_for_bf16(tmp_path):
    """The ``safetensors`` package's numpy reader has no bfloat16 of its
    own: in a process that has not imported jax (whose ml_dtypes
    registers one) it raises TypeError on a BF16 tensor, as it would on
    the card, which has neither.  JAX's converter imports jax, so it
    reads BF16; the port reads it without either package."""
    tcv.write_checkpoint(str(tmp_path / "b.safetensors"),
                         {"w": np.ones((2, 3), np.float32)}, dtype="BF16")
    code = ("import sys\n"
            "from safetensors import safe_open\n"
            "with safe_open(sys.argv[1], framework='numpy') as f:\n"
            "    try:\n"
            "        f.get_tensor('w')\n"
            "    except TypeError as e:\n"
            "        print('TypeError:', e)\n"
            "print('jax' in sys.modules, 'ml_dtypes' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "b.safetensors")],
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "TypeError: data type 'bfloat16' not understood" in out.stdout
    assert out.stdout.strip().endswith("False False")
    np.testing.assert_array_equal(
        tst.load_file(str(tmp_path / "b.safetensors"))["w"],
        np.ones((2, 3), np.float32))


def test_jax_cli_without_smoke_asks_for_a_missing_spec():
    """JAX's ``_resolve_spec(..., smoke=False)`` calls ``mod.spec()``,
    which no config defines; the port's returns ``full_spec()``."""
    with pytest.raises(AttributeError, match="spec"):
        jcv._resolve_spec("olmoe_1b_7b", False)
    got = tcv._resolve_spec("olmoe_1b_7b", False)
    assert got == tconfigs.get("olmoe-1b-7b").full_spec()
    assert tcv._resolve_spec("olmoe-1b-7b", True).name == "olmoe-smoke"


def test_convert_cli_round_trips(tmp_path, capsys):
    _, tspec = C.specs("qwen3-14b")
    tensors = tcv.make_synthetic_checkpoint(str(tmp_path / "hf"), tspec,
                                            seed=8, shards=2, dtype="BF16")
    tcv.main(["--src", str(tmp_path / "hf"), "--dest", str(tmp_path / "ck"),
              "--config", "qwen3_14b", "--smoke", "--pp", "2",
              "--virtual-stages", "2"])
    tcv.main(["--src", str(tmp_path / "ck"), "--dest",
              str(tmp_path / "back.safetensors"), "--config", "qwen3_14b",
              "--smoke", "--export"])
    out = capsys.readouterr().out
    assert "(pp=2, tp=1, v=2, 4 chunks)" in out and "exported" in out
    back = tst.load_file(str(tmp_path / "back.safetensors"))
    for k, v in tensors.items():
        np.testing.assert_array_equal(
            back[k], torch.from_numpy(v).bfloat16().float().numpy())
