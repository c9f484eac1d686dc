"""llava-next-34b in the port (576 patch embeddings prepended to the text
with labels of −1; 56 / 8 heads of 128 at full width, a group of 7 query
heads a KV head) against the JAX package on the CPU in fp32 at its smoke
spec: tests/_torch_config_cases.py."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_config_cases as C
from _torch_train_jax import one_torch_thread  # noqa: F401
from repro_torch.core.pipeline import build_pipeline
from repro_torch.optim.optimizers import SGDM

ARCH = "llava-next-34b"
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def test_config_matches_jax():
    C.check_config(ARCH, ("llava-next-34b", "llava_next_34b"))
    j, t = C.jconfigs.get(ARCH), C.tconfigs.get(ARCH)
    assert t.N_PATCHES == j.N_PATCHES == 576
    full = t.full_spec()
    assert (full.n_heads, full.n_kv, full.d_head, full.n_patches) == \
        (56, 8, 128, 576)


@pytest.mark.parametrize("pp", [1, 2])
def test_stage_forward_matches_jax(pp):
    got, want = C.full_transformer_pair(ARCH, pp)
    np.testing.assert_allclose(got, want, **C.FWD_TOL)


@pytest.mark.parametrize("page_size", [0, C.PAGE])
def test_engine_tokens_equal_the_jax_engine(page_size):
    """A prompt of 8 patches and 4 text tokens, then the decodes, against
    JAX's dense-cache engine (its paged one drops keys:
    :func:`test_jax_paged_engine_fault`)."""
    want, pos, _ = C.jax_engine(ARCH, 0)
    got, sess = C.port_engine(ARCH, C.jax_params(ARCH), page_size)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sess._pos, pos)
    assert sess.prefill_specs["patches"].shape == (C.R, C.ROWS, 8, 64)
    assert sess.text_len == C.PREFILL - 8
    if page_size:
        # the slot's pages cover its patches, text and decodes
        assert (sess._alloc.counts == -(-(C.PREFILL + C.N_DEC)
                                        // page_size)).all()


def test_jax_paged_engine_fault():
    """JAX's paged engine counts a VLM prompt's text alone on the host
    (``_slot_lens``: ``tokens.shape[2]``), so its host position and page
    tables lag the device position by the patch prefix: a slot holds the
    pages of 4 + 6 positions while its keys reach position 17, and the
    keys past the first page are dropped (ROADMAP Queue 3).  Its tokens
    then part from its dense engine's, which the port's paged engine
    equals."""
    dense, _, _ = C.jax_engine(ARCH, 0)
    paged, pos, js = C.jax_engine(ARCH, C.PAGE)
    assert (js._pos == C.PREFILL - 8 + C.N_DEC).all()
    assert (pos == C.PREFILL + C.N_DEC).all()
    assert (js._alloc.counts == 1).all()
    assert (paged != dense).any()


def test_tokens_depend_on_the_patches():
    """Other patches, other served tokens: the prefix reaches the text."""
    _, tspec = C.specs(ARCH)
    base, _ = C.port_engine(ARCH, C.jax_params(ARCH), C.PAGE)
    sess = C.build_serving(tspec, C.TPlan(pp=1, tp=1, decode_microbatches=C.R),
                           cache_len=C.CACHE, global_batch=C.R * C.ROWS,
                           compute_dtype=torch.float32, page_size=C.PAGE,
                           prefill_len=C.PREFILL, device="cpu").start()
    sess.load_params(C.jax_params(ARCH))
    batch = C.prompt_batch(tspec)
    batch["patches"] = batch["patches"] * -3.0
    assert (sess.prefill(batch).numpy() != base[0]).any()


def test_batcher_passes_the_frontend_inputs():
    C.check_batcher_passes_inputs(ARCH)


def test_round_tracks_jax():
    C.check_round_tracks_jax(ARCH, 1)


def test_executor_equals_oracle_bit_for_bit():
    C.check_executor_equals_oracle(ARCH, 2, "1f1b", "flush")


def test_rank_draw_equals_the_whole_draws_rows():
    C.check_rank_draw(ARCH, 2, 1)


def test_patch_rows_take_no_loss_and_no_embedding_gradient():
    """The patch rows' labels are −1 and their d(embeddings) is dropped:
    a round over patches alone (every text label −1) leaves the head,
    the final norm and the embedding where they were."""
    _, spec = C.specs(ARCH)
    plan = C.tconfigs.get(ARCH).SMOKE_PLAN.with_(microbatches=2)
    bundle = build_pipeline(spec, plan, seq_len=12, global_batch=4,
                            optimizer=SGDM(lr=0.05),
                            compute_dtype=torch.float32, device="cpu")
    state = bundle.init_state(torch.Generator().manual_seed(0))
    before = {k: state["params"][k].clone() for k in ("embed", "head")}
    batch = {k: torch.from_numpy(v) for k, v in C.prompt_batch(spec).items()}
    batch["tokens"] = batch["tokens"][:, :, :4]
    batch["labels"] = torch.full_like(batch["tokens"], -1)
    state, m = bundle.train_step(state, batch)
    assert float(m["loss"]) == 0.0
    for k, v in before.items():
        assert torch.equal(state["params"][k], v), k


_STUB = """
import types
from repro.data.pipeline import vlm_patch_stub as jax_stub
from repro_torch.data.pipeline import vlm_patch_stub as port_stub
shape = types.SimpleNamespace(shape=(1, 1, 2, 8))
for stub in (jax_stub, port_stub):
    x = stub(8)(0, {"patches": shape})["patches"]
    print(repr(x.ravel()[:3].tolist()))
"""


def _stubs_in_process(hashseed):
    """(JAX's, the port's) first patch values in a process of its own
    with ``PYTHONHASHSEED=hashseed``."""
    env = dict(os.environ, PYTHONPATH=SRC, PYTHONHASHSEED=str(hashseed),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _STUB], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def test_patch_stub_is_deterministic_across_processes():
    """JAX's ``vlm_patch_stub`` seeds with ``hash(key)``, which Python
    salts per process: two processes with other PYTHONHASHSEEDs draw
    other patches (ROADMAP Queue 3).  The port's stub seeds with the
    key's CRC-32 and draws the same patches in both."""
    (j1, t1), (j2, t2) = _stubs_in_process(1), _stubs_in_process(2)
    assert j1 != j2
    assert t1 == t2
