"""The port's mamba2-780m path against the JAX package, at SMOKE.

mamba2-780m SMOKE (2 layers, d_model 128, 16 SSD heads of 16, state 16,
chunk 16): the JAX package initialises the parameters,
:func:`repro_torch.convert.lm_params_from_jax` carries them into the
port's ``MambaLM``, and both score and serve the same tokens.  The JAX
side runs ``attn_impl="pallas"`` as its tests do on the CPU (its SSD
kernel in interpret mode); the port runs on CPU tensors, where the plain
chunked scan stands in for the CUDA kernel.

Tolerance: float32 losses rtol 1e-5 and logits rtol 1e-4 / atol 1e-5
(tests/_torch_parity.py; measured 0 and 2.0e-6).  bf16: XLA's CPU compiler
keeps excess precision between the fused ops of the JAX package's scanned
layers, while the port rounds op by op (one block matches JAX run op by
op to one ulp, tests/test_torch_ssd.py), so whole-model bf16 numbers drift
in the last bits: logits to the bf16 logits tolerance (atol 5e-2;
measured 3.9e-2 at prefill), the conv cache to two bf16 ulps at its
values (atol 3.2e-2; measured 1.6e-2), the float32 state to atol 2e-2
(measured 6.9e-3 at |state| ~3), and the loss to rtol 1e-3 (measured
3.1e-4).  The serving stream's counts are exact and its float summary
rtol 1e-5; the data pipeline is bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LOGITS_BF16_ATOL, LOGITS_F32, RTOL, as_np
from repro.cluster.orchestrator import OnlineAdmissionController as JCtl
from repro.configs import get_config as jax_get_config
from repro.core import Exponential as JExp
from repro.data.pipeline import DataPipeline as JaxPipeline
from repro.models.base import cross_entropy_chunked as jax_ce
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import BatchedServer as JServer
from repro.serving.engine import SpotServingFrontend as JFrontend
import repro_torch.core as T
from repro_torch import convert
from repro_torch.cluster.orchestrator import OnlineAdmissionController
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import serve
from repro_torch.models.base import cross_entropy_chunked
from repro_torch.models.mamba_lm import MambaLM
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import BatchedServer, SpotServingFrontend

B, S, STEPS, VOCAB = 2, 32, 6, 512
LOSS_BF16_RTOL = 1e-3
CONV_BF16_ATOL = 3.2e-2
STATE_BF16_ATOL = 2e-2


def _pair(**changes):
    """(JAX model, JAX params, port model with the same weights)."""
    jcfg = dataclasses.replace(jax_get_config("mamba2-780m", smoke=True),
                               **changes)
    tcfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                               **changes)
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tmodel = MambaLM(tcfg, device="cpu")
    tmodel.load_state_dict(convert.lm_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _batch(seed=0):
    """The same DataPipeline batch for both packages."""
    jb = JaxPipeline(VOCAB, B, S, seed=seed).next()
    tb = DataPipeline(VOCAB, B, S, seed=seed).next(device="cpu")
    return jb, tb


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_jax(dtype, impl):
    jmodel, params, tmodel = _pair(dtype=dtype, attn_impl=impl)
    jb, tb = _batch()
    want, jparts = jmodel.loss(params, jb)
    got, parts = tmodel.loss(tb)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(parts["aux"]) == 0.0 and parts["ce"] is got
    rtol = RTOL if dtype == "float32" else LOSS_BF16_RTOL
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)
    # the kernel's stand-in and the plain scan give one loss in the port
    other = "chunked" if impl == "pallas" else "pallas"
    tmodel.cfg = dataclasses.replace(tmodel.cfg, attn_impl=other)
    np.testing.assert_allclose(float(tmodel.loss(tb)[0]), float(got),
                               rtol=RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_cache_match_jax(dtype):
    jmodel, params, tmodel = _pair(dtype=dtype, attn_impl="pallas")
    jb, tb = _batch(1)
    want, jcache = jmodel.prefill(params, {"tokens": jb["tokens"]})
    got, cache = tmodel.prefill({"tokens": tb["tokens"]})
    ref = convert.mamba_cache_from_jax(jax.tree.map(np.asarray, jcache))
    assert got.dtype == torch.float32 and got.shape == (B, 1, VOCAB)
    assert cache.index == ref.index == S
    assert cache.conv.dtype == ref.conv.dtype == tmodel.dtype
    assert cache.state.dtype == torch.float32
    assert cache.conv.shape == ref.conv.shape == (2, B, 3, 256 + 32)
    assert cache.state.shape == ref.state.shape == (2, B, 16, 16, 16)
    if dtype == "float32":
        np.testing.assert_allclose(as_np(got), as_np(want), **LOGITS_F32)
        for g, r in ((cache.conv, ref.conv), (cache.state, ref.state)):
            np.testing.assert_allclose(as_np(g), as_np(r), **LOGITS_F32)
    else:
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=0,
                                   atol=LOGITS_BF16_ATOL)
        # the first layer's window is rounded from the same bf16 inputs
        np.testing.assert_array_equal(as_np(cache.conv[0]),
                                      as_np(ref.conv[0]))
        np.testing.assert_allclose(as_np(cache.conv), as_np(ref.conv),
                                   rtol=0, atol=CONV_BF16_ATOL)
        np.testing.assert_allclose(as_np(cache.state), as_np(ref.state),
                                   rtol=0, atol=STATE_BF16_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_teacher_forced_matches_jax(dtype):
    """The port decodes JAX's greedy tokens from its own prefill cache:
    logits at every step within the tolerance; where JAX's top-1/top-2
    margin exceeds twice that tolerance, the same greedy token."""
    jmodel, params, tmodel = _pair(dtype=dtype, attn_impl="pallas")
    jb, tb = _batch(2)
    jlogits, jcache = jmodel.prefill(params, {"tokens": jb["tokens"]})
    tlogits, tcache = tmodel.prefill({"tokens": tb["tokens"]})
    tol = (LOGITS_F32 if dtype == "float32"
           else dict(rtol=0, atol=LOGITS_BF16_ATOL))
    decode = jax.jit(jmodel.decode_step)
    checked = 0
    for step in range(STEPS):
        np.testing.assert_allclose(as_np(tlogits), as_np(jlogits), **tol,
                                   err_msg=f"step {step}")
        jl = as_np(jlogits)[:, -1]
        top2 = np.sort(jl, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * LOGITS_BF16_ATOL
        cur = jl.argmax(-1).astype(np.int32)
        np.testing.assert_array_equal(
            as_np(tlogits)[:, -1].argmax(-1)[sure], cur[sure])
        checked += int(sure.sum())
        jlogits, jcache = decode(params, {"tokens": jnp.asarray(cur)[:, None]},
                                 jcache)
        tlogits, tcache = tmodel.decode_step(
            {"tokens": torch.from_numpy(cur)[:, None]}, tcache)
    assert checked > 0
    assert tcache.index == int(jcache.index) == S + STEPS


def test_serving_greedy_decode_matches_teacher_forcing():
    """Generated token i equals the argmax of the teacher-forced prefill
    logits (the JAX package's test of the same name, on the port)."""
    cfg = get_config("mamba2-780m", smoke=True)
    model = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    server = BatchedServer(model, max_batch=1, max_len=48, device="cpu")
    prompt = np.arange(2, 18, dtype=np.int32)
    outs = server.generate([prompt], max_new=4)[0]
    seq = list(prompt)
    for i in range(4):
        logits, _ = model.prefill({"tokens": torch.tensor([seq])})
        nxt = int(logits[0, -1].argmax())
        assert nxt == outs[i], (i, nxt, outs[i])
        seq.append(nxt)


def test_serving_stream_matches_jax():
    """SpotServingFrontend.run_stream on the SMOKE model, 12 requests, with
    the same seed and controller: counts exact, float summary rtol 1e-5."""
    jmodel, params, tmodel = _pair()
    kw = dict(n_requests=12, prompt_len=16, max_new=3, vocab=VOCAB)
    ctl = dict(delta=5.0, eta=0.1, r0=2.0, window_jobs=4)
    ref = JFrontend(JServer(jmodel, params, max_batch=4, max_len=27),
                    spot_process=JExp(1 / 3.0), controller=JCtl(**ctl),
                    k_cost=10.0, seed=7).run_stream(JExp(1 / 2.0), **kw)
    front = SpotServingFrontend(
        BatchedServer(tmodel, max_batch=4, max_len=27, device="cpu"),
        spot_process=T.Exponential(1 / 3.0),
        controller=OnlineAdmissionController(**ctl), k_cost=10.0, seed=7)
    got = front.run_stream(T.Exponential(1 / 2.0), **kw)
    assert got["completed"] == ref["completed"] == 12
    assert got["spot_fraction"] == ref["spot_fraction"]
    for name in ("avg_cost", "avg_delay", "r_star"):
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL, atol=0,
                                   err_msg=name)
    assert all(len(r.tokens_out) == 3 and all(0 <= t < VOCAB
                                              for t in r.tokens_out)
               for r in front.completed)


@pytest.mark.parametrize("host_count", [1, 2])
def test_data_pipeline_matches_jax_bitwise(host_count):
    """Batches, cursor state and an elastic restore, bitwise."""
    kw = dict(vocab_size=VOCAB, global_batch=4, seq_len=48, seed=3,
              host_index=host_count - 1, host_count=host_count)
    jp, tp = JaxPipeline(**kw), DataPipeline(**kw)
    for _ in range(3):
        want, got = jp.next(), tp.next(device="cpu")
        for name in ("tokens", "targets"):
            assert got[name].dtype == torch.int32
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]))
    assert tp.state() == jp.state()
    jp.restore(jp.state(), host_index=0, host_count=4)
    tp.restore(tp.state(), host_index=0, host_count=4)
    np.testing.assert_array_equal(tp.next(device="cpu")["tokens"].numpy(),
                                  np.asarray(jp.next()["tokens"]))


@pytest.mark.parametrize("S_,chunks", [(32, 16), (30, 16), (7, 4)])
def test_cross_entropy_chunked_matches_jax(S_, chunks):
    """The chunk rule (lowered until it divides S) and the mask."""
    rng = np.random.default_rng(S_)
    x = rng.standard_normal((2, S_, 24)).astype(np.float32)
    head = rng.standard_normal((24, 40)).astype(np.float32)
    tg = rng.integers(0, 40, size=(2, S_)).astype(np.int32)
    mask = (rng.random((2, S_)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = jax_ce(jnp.asarray(x), jnp.asarray(head), jnp.asarray(tg),
                      num_chunks=chunks,
                      mask=None if m is None else jnp.asarray(m))
        got = cross_entropy_chunked(
            torch.from_numpy(x), torch.from_numpy(head), torch.from_numpy(tg),
            num_chunks=chunks, mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_launcher_serves_mamba_on_the_cpu_when_asked():
    out = serve.main(["--arch", "mamba2-780m", "--requests", "4",
                      "--max-new", "2"], device="cpu")
    assert out["completed"] == 4


def test_mamba_config_is_the_published_one(monkeypatch):
    cfg = get_config("mamba2-780m")
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner, cfg.ssm_heads,
            cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk, cfg.vocab_size) == (
        48, 1536, 3072, 48, 64, 128, 256, 50280)
    for smoke in (False, True):
        assert dataclasses.asdict(get_config("mamba2-780m", smoke)) == \
            dataclasses.asdict(jax_get_config("mamba2-780m", smoke))
    assert 0.6e9 < cfg.param_count() < 1.0e9
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("mamba2-780m", smoke=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataPipeline(VOCAB, B, S).next()
