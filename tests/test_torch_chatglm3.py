"""chatglm3-6b in the port (2d half-rotary RoPE, GQA at 32 / 2 heads at
full width: a group of 16 query heads a KV head) against the JAX package
on the CPU in fp32 at its smoke spec: tests/_torch_config_cases.py."""
import numpy as np
import pytest

import _torch_config_cases as C
from _torch_train_jax import one_torch_thread  # noqa: F401
from repro_torch.models.init import attn_static

ARCH = "chatglm3-6b"


def test_config_matches_jax():
    C.check_config(ARCH, ("chatglm3-6b", "chatglm3_6b"))
    full = C.tconfigs.get(ARCH).full_spec()
    assert (full.n_heads, full.n_kv, full.d_head, full.rope_2d) == \
        (32, 2, 128, True)
    # kv 2 < tp 4: the KV weights stay whole, each rank its head group
    st = attn_static(full, 4)
    assert (st.n_heads_local, st.n_kv_local, st.kv_sharded,
            st.kv_groups_per_device) == (8, 1, False, 2)


@pytest.mark.parametrize("pp", [1, 2])
def test_stage_forward_matches_jax(pp):
    got, want = C.full_transformer_pair(ARCH, pp)
    np.testing.assert_allclose(got, want, **C.FWD_TOL)


@pytest.mark.parametrize("page_size", [0, C.PAGE])
def test_engine_tokens_equal_the_jax_engine(page_size):
    C.check_engine(ARCH, page_size)


def test_tokens_depend_on_attention():
    C.check_tokens_depend_on_attention(ARCH)


def test_round_tracks_jax():
    C.check_round_tracks_jax(ARCH, 2)


@pytest.mark.parametrize("pp,schedule,mode,v", [
    (2, "1f1b", "stash", 1), (2, "interleaved", "flush", 2)])
def test_executor_equals_oracle_bit_for_bit(pp, schedule, mode, v):
    C.check_executor_equals_oracle(ARCH, pp, schedule, mode, v)


@pytest.mark.parametrize("pp,v", [(2, 1), (2, 2)])
def test_rank_draw_equals_the_whole_draws_rows(pp, v):
    C.check_rank_draw(ARCH, pp, v)
