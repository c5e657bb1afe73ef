"""The port's dense LM and serving path against the JAX package, at SMOKE.

qwen1.5-4b SMOKE (2 layers, d_model 128, 4 heads, QKV bias): the JAX
package initialises the parameters (with random biases added, so that the
bias path is exercised), :mod:`repro_torch.convert` carries them into the
port's module, and both run the same tokens.  The JAX side runs
``attn_impl="pallas"`` as its tests do on the CPU (interpret mode); the
port runs on CPU tensors, where the flash kernel's plain version stands
in for the kernel.

Tolerance (tests/_torch_parity.py): float32 prefill logits rtol 1e-4,
atol 1e-5; bf16 logits atol 5e-2, sized from the 2.7e-2 between two
correct JAX paths; the serving stream's counts exact and its float summary
rtol 1e-5.  In bf16 a layer of the port equals the JAX layer run op by op
bitwise, and so does the KV cache of the first layer.  The JAX package
runs its layers inside ``lax.scan``, where XLA's CPU compiler keeps excess
precision between the fused bf16 ops of a layer (it drops the round trips
through bf16 that op-by-op evaluation makes), so from the second layer on
its hidden states differ from op-by-op bf16 in the last bits, and the
cache there is held to the bf16 logits tolerance.  A float32 model
cannot decode in the JAX package (its KV cache bit-casts float32 K/V into
pairs of uint16; ROADMAP.md Queue 3), so the float32 test covers prefill
only.
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
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import BatchedServer as JServer
from repro.serving.engine import SpotServingFrontend as JFrontend
import repro_torch.core as T
from repro_torch import convert
from repro_torch.cluster.orchestrator import OnlineAdmissionController
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models.lm import TransformerLM
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import BatchedServer, SpotServingFrontend

B, S, STEPS = 2, 16, 8


def _configs(**changes):
    """The JAX and port SMOKE configs with the same changes."""
    return (dataclasses.replace(jax_get_config("qwen1.5-4b", smoke=True),
                                **changes),
            dataclasses.replace(get_config("qwen1.5-4b", smoke=True),
                                **changes))


def _jax_params(model, seed=0):
    """JAX init, plus random QKV biases (the init's are zero)."""
    params = model.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    attn = dict(params["layers"]["attn"])
    for name in ("bq", "bk", "bv"):
        noise = rng.standard_normal(attn[name].shape).astype(np.float32)
        attn[name] = (attn[name] + 0.5 * noise).astype(attn[name].dtype)
    params["layers"] = dict(params["layers"], attn=attn)
    return params


def _pair(**changes):
    """(JAX model, JAX params, port model with the same weights)."""
    jcfg, tcfg = _configs(**changes)
    jmodel = jax_build_model(jcfg)
    params = _jax_params(jmodel)
    tmodel = TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(convert.lm_params_from_jax(
        jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(2, 512, size=(B, S)).astype(
        np.int32)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_prefill_logits_float32_match_jax(impl):
    jmodel, params, tmodel = _pair(dtype="float32", attn_impl=impl)
    toks = _tokens(1)
    ref, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)})
    got, _ = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (B, 1, 512)
    np.testing.assert_allclose(as_np(got), as_np(ref), **LOGITS_F32)


@pytest.mark.parametrize("impl", ["pallas", "chunked"])
def test_prefill_logits_bf16_match_jax(impl):
    jmodel, params, tmodel = _pair(attn_impl=impl)
    toks = _tokens(2)
    ref, _ = jmodel.prefill(params, {"tokens": jnp.asarray(toks)})
    got, _ = tmodel.prefill({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(as_np(got), as_np(ref), rtol=0,
                               atol=LOGITS_BF16_ATOL)


def test_decode_bf16_teacher_forced_matches_jax():
    """The port decodes JAX's own greedy tokens: logits at every step
    within the bf16 tolerance; its greedy token equals JAX's wherever
    JAX's top-1/top-2 margin exceeds twice that tolerance."""
    jmodel, params, tmodel = _pair(attn_impl="pallas")
    toks = _tokens(3)
    cap = S + STEPS
    jlogits, jcache = jmodel.prefill(params, {"tokens": jnp.asarray(toks)},
                                     max_len=cap)
    tlogits, tcache = tmodel.prefill({"tokens": torch.from_numpy(toks)},
                                     max_len=cap)
    want = convert.kv_cache_from_jax(jax.tree.map(np.asarray, jcache))
    assert tcache.index == want.index == S
    for got, ref in ((tcache.k, want.k), (tcache.v, want.v)):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        np.testing.assert_array_equal(as_np(got[0]), as_np(ref[0]))
        np.testing.assert_allclose(as_np(got), as_np(ref), rtol=0,
                                   atol=LOGITS_BF16_ATOL)

    decode = jax.jit(jmodel.decode_step)
    checked = 0
    for step in range(STEPS):
        np.testing.assert_allclose(as_np(tlogits), as_np(jlogits), rtol=0,
                                   atol=LOGITS_BF16_ATOL,
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
    assert tcache.index == int(jcache.index) == cap


def test_bf16_layer_equals_jax_op_by_op_bitwise():
    """One bf16 block (norms, biased projections, RoPE, flash attention,
    residuals, SwiGLU), JAX's run eagerly op by op: the output and the
    block's K/V bitwise."""
    jmodel, params, tmodel = _pair(attn_impl="pallas")
    toks = _tokens(4)
    p0 = jax.tree.map(lambda a: a[0], params["layers"])
    x = params["embed"][jnp.asarray(toks)]
    ref, _, (rk, rv) = jmodel._block_seq(
        p0, x, jnp.broadcast_to(jnp.arange(S)[None], (B, S)))
    got, (gk, gv) = tmodel._block_seq(
        tmodel.layers[0], tmodel.embed[torch.from_numpy(toks).long()],
        torch.arange(S).expand(B, S))
    for r, g in ((ref, got), (rk, gk), (rv, gv)):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(as_np(g), as_np(r))


def test_serving_stream_matches_jax():
    """SpotServingFrontend.run_stream, 20 requests, with the same seed and
    controller: counts exact, float summary rtol 1e-5."""
    jcfg, tcfg = _configs()
    jmodel = jax_build_model(jcfg)
    params = jmodel.init(jax.random.key(0))
    tmodel = TransformerLM(tcfg, device="cpu")
    tmodel.load_state_dict(convert.lm_params_from_jax(
        jax.tree.map(np.asarray, params)))
    kw = dict(n_requests=20, prompt_len=16, max_new=4, vocab=tcfg.vocab_size)
    ctl = dict(delta=5.0, eta=0.1, r0=2.0, window_jobs=4)
    ref = JFrontend(JServer(jmodel, params, max_batch=4, max_len=28),
                    spot_process=JExp(1 / 3.0), controller=JCtl(**ctl),
                    k_cost=10.0, seed=7).run_stream(JExp(1 / 2.0), **kw)
    front = SpotServingFrontend(
        BatchedServer(tmodel, max_batch=4, max_len=28, device="cpu"),
        spot_process=T.Exponential(1 / 3.0),
        controller=OnlineAdmissionController(**ctl), k_cost=10.0, seed=7)
    got = front.run_stream(T.Exponential(1 / 2.0), **kw)
    assert got["completed"] == ref["completed"] == 20
    assert got["spot_fraction"] == ref["spot_fraction"]
    assert 0.0 < got["spot_fraction"] < 1.0
    for name in ("avg_cost", "avg_delay", "r_star"):
        np.testing.assert_allclose(got[name], ref[name], rtol=RTOL, atol=0,
                                   err_msg=name)
    assert all(len(r.tokens_out) == 4 for r in front.completed)
    assert sum(t["batch"] for t in front.server.timings) == 20


def test_launcher_serves_on_the_cpu_when_asked():
    out = serve.main(["--requests", "4", "--max-new", "2"], device="cpu")
    assert out["completed"] == 4


def test_entry_points_need_a_gpu_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen1.5-4b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedServer(model, max_batch=4, max_len=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])


def test_unported_architectures_and_families_raise():
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        get_config("zamba2-1.2b")
    moe = dataclasses.replace(get_config("qwen1.5-4b", smoke=True),
                              family="moe")
    with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
        build_model(moe, device="cpu")
    assert get_config("qwen1.5-4b").num_layers == 40
