"""whisper-medium [audio]: a 24-layer decoder, d_model 1024, 16 heads
(MHA) of 64, d_ff 4096, vocab 51865, layernorm and GELU; an encoder of 24
layers at the same width over 1500 frames.  [arXiv:2212.04356]

The pipelined backbone is the decoder: every layer cross-attends into
the encoder's output.  The encoder runs before the pipeline
(``models/stage.py::encoder_fwd``); the conv / log-mel frontend is a
stub, and a batch carries 1500 precomputed frame embeddings
(``data/pipeline.py::frames_stub``).  The decoder's learned absolute
positions are replaced by RoPE.

Same specs and plans as ``repro/configs/whisper_medium.py`` (pinned by
tests/test_torch_whisper.py).
"""
from repro_torch.models import spec as S
from repro_torch.parallel.plan import ParallelismPlan

OPTIMIZER = ("adam", 1e-3)

SOURCE_LEN = 1500  # 30 s of audio after the (stubbed) 2x conv downsampling

PLAN = ParallelismPlan(pp=8, tp=2, microbatches=16, stash_mode="stash",
                       zero1=True, remat=True)
SMOKE_PLAN = ParallelismPlan(pp=2, tp=1, microbatches=2, stash_mode="stash",
                             zero1=False)


def full_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense", cross_attn=True)
                   for _ in range(24))
    return S.ModelSpec(
        name="whisper-medium", d_model=1024, n_layers=24, n_heads=16,
        n_kv=16, d_head=64, d_ff=4096, vocab=51865, blocks=blocks,
        norm="layernorm", act="gelu",
        encoder=S.EncoderSpec(n_layers=24, d_model=1024, n_heads=16,
                              d_ff=4096, source_len=SOURCE_LEN),
        frontend="audio", family="audio", subquadratic=False)


def smoke_spec() -> S.ModelSpec:
    blocks = tuple(S.BlockSpec(mixer="attn", ffn="dense", cross_attn=True)
                   for _ in range(4))
    return S.ModelSpec(
        name="whisper-smoke", d_model=64, n_layers=4, n_heads=4, n_kv=4,
        d_head=16, d_ff=128, vocab=256, blocks=blocks,
        norm="layernorm", act="gelu",
        encoder=S.EncoderSpec(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                              source_len=16),
        frontend="audio", family="audio", subquadratic=False)
