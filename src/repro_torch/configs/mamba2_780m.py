"""mamba2-780m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L, d_model 1536 (attention-free), vocab 50280, ssm_state 128,
d_inner = 2×1536 = 3072, headdim 64 ⇒ 48 SSD heads.  Sub-quadratic ⇒ runs
the long_500k cell.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    train_accum=4,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    num_layers=2,
    d_model=128,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=16,
)
