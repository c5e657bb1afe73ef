"""qwen1.5-4b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

40L, d_model 2560, 20 heads (kv=20, MHA), d_ff 6912, vocab 151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    fsdp=True,  # 20 heads don't shard over model=16; shard attn over data
    train_accum=4,
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    qkv_bias=True,
    attn_chunk_q=32,
    attn_chunk_k=32,
)
