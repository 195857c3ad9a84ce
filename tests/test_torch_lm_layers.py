"""The LM zoo's layers, MoE and recurrent blocks of the port against the
reference's, function by function, on the reference's own params converted
(d_model 64, 4 heads / 2 KV heads, B = 2, S <= 12, fp32).

Tolerances: 1e-5 absolute on outputs and states unless a case says
otherwise (the largest difference measured on this CPU is written beside
each)."""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models.config import MLAConfig, ModelConfig, MoEConfig  # noqa: E402
from repro_torch.models import layers, moe, recurrent  # noqa: E402
from repro_torch.utils.tree import from_jax_params  # noqa: E402

from _torch_ref import np_tree, torch_model_config  # noqa: E402

CPU = torch.device("cpu")
B, S = 2, 12
TOL = dict(atol=1e-5, rtol=0)
BASE = ModelConfig(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
                   num_kv_heads=2, d_ff=128, vocab_size=128, sliding_window=8,
                   local_window=4)
MLA = BASE.replace(block_pattern=("mla",), mla=MLAConfig(64, 32, 16, 8, 16))
RNN = BASE.replace(rnn_width=64, d_ff=0)


def _x(seed, shape=(B, S, 64), scale=1.0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape)) * scale


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _params(init, cfg, seed=0):
    jp = init(jax.random.PRNGKey(seed), cfg)
    return jp, from_jax_params(np_tree(jp), CPU)


def _j(fn, **static):
    """The reference's ``fn`` jitted with ``static`` bound: one compile
    instead of an eager dispatch per op (a decode loop runs it S times)."""
    return jax.jit(functools.partial(fn, **static))


def _close(t, j, **tol):
    torch.testing.assert_close(t, _t(j), **(tol or TOL))


def _tree_close(t, j, **tol):
    assert set(t) == set(j)
    for k in t:
        _close(t[k], j[k], **tol)


# ---------------------------------------------------------------------------
# norms, RoPE, MLP, softcap
# ---------------------------------------------------------------------------


def test_rmsnorm_rope_mlp_and_softcap_match():
    x = _x(1)
    scale = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (64,)))
    _close(layers.rmsnorm_apply({"scale": _t(scale)}, _t(x), 1e-6),
           jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))
    q = _x(3, (B, S, 4, 16))
    pos = np.arange(S)[None, :]
    _close(layers.apply_rope(_t(q), torch.arange(S)[None, :], 10000.0),
           jlayers.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10000.0))   # 4.8e-7
    jp, tp = _params(jlayers.mlp_init, BASE)
    _close(layers.mlp_apply(tp, _t(x)), jax.jit(jlayers.mlp_apply)(jp, jnp.asarray(x)))
    _close(layers.softcap(_t(x) * 40, 30.0), jlayers.softcap(jnp.asarray(x) * 40, 30.0))
    assert layers.softcap(_t(x), 0.0) is not None


# ---------------------------------------------------------------------------
# GQA attention: full, sliding window, local
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block_type", ["attn", "swa", "local"])
def test_attention_apply_matches(block_type):
    cfg = BASE.replace(qkv_bias=block_type == "attn")
    jp, tp = _params(jlayers.attention_init, cfg)
    x = _x(4)
    _close(layers.attention_apply(tp, _t(x), torch_model_config(cfg), block_type),
           _j(jlayers.attention_apply, cfg=cfg, block_type=block_type)(jp, jnp.asarray(x)))


@pytest.mark.parametrize("block_type", ["attn", "swa", "local"])
def test_attention_decode_ring_buffer_matches(block_type):
    """Step by step past the window (S = 12 > 8 and 4): the ring slot
    ``pos % C`` and the valid mask ``min(pos, C - 1)``, outputs and caches
    against the reference's decode."""
    cfg = BASE
    tcfg = torch_model_config(cfg)
    jp, tp = _params(jlayers.attention_init, cfg)
    x = _x(5)
    jc = jlayers.attention_init_cache(cfg, block_type, B, S)
    tc = layers.attention_init_cache(tcfg, block_type, B, S, CPU)
    assert tc["k"].shape == jc["k"].shape
    jdecode = _j(jlayers.attention_decode, cfg=cfg, block_type=block_type)
    for t in range(S):
        jo, jc = jdecode(jp, jnp.asarray(x[:, t:t + 1]), jc, t)
        before = tc["k"].clone()
        to, tc = layers.attention_decode(tp, _t(x[:, t:t + 1]), tc, t, tcfg, block_type)
        _close(to, jo)
        _tree_close(tc, jc)
    assert not torch.equal(before, tc["k"])


def test_cross_attention_matches():
    jp, tp = _params(jlayers.attention_init, BASE)
    x, mem = _x(6), _x(7, (B, 5, 64))
    _close(layers.cross_attention_apply(tp, _t(x), _t(mem), torch_model_config(BASE)),
           jlayers.cross_attention_apply(jp, jnp.asarray(x), jnp.asarray(mem), BASE))


# ---------------------------------------------------------------------------
# MLA: apply, decode, absorbed decode
# ---------------------------------------------------------------------------


def test_mla_apply_matches():
    jp, tp = _params(jlayers.mla_init, MLA)
    x = _x(8)
    _close(layers.mla_apply(tp, _t(x), torch_model_config(MLA)),
           _j(jlayers.mla_apply, cfg=MLA)(jp, jnp.asarray(x)))


@pytest.mark.parametrize("absorbed", [False, True])
def test_mla_decode_matches(absorbed):
    tcfg = torch_model_config(MLA)
    jp, tp = _params(jlayers.mla_init, MLA)
    x = _x(9)
    jfn = _j(jlayers.mla_decode_absorbed if absorbed else jlayers.mla_decode, cfg=MLA)
    tfn = layers.mla_decode_absorbed if absorbed else layers.mla_decode
    jc, tc = jlayers.mla_init_cache(MLA, B, S), layers.mla_init_cache(tcfg, B, S, CPU)
    plain = layers.mla_init_cache(tcfg, B, S, CPU)
    for t in range(S):
        jo, jc = jfn(jp, jnp.asarray(x[:, t:t + 1]), jc, t)
        to, tc = tfn(tp, _t(x[:, t:t + 1]), tc, t, tcfg)
        _close(to, jo)
        _tree_close(tc, jc)
        # absorbed against plain in the port itself
        po, plain = layers.mla_decode(tp, _t(x[:, t:t + 1]), plain, t, tcfg)
        torch.testing.assert_close(to, po, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# MoE: sort and einsum dispatch, routing
# ---------------------------------------------------------------------------

MOE = BASE.replace(family="moe", moe=MoEConfig(num_experts=8, num_experts_per_tok=2,
                                              num_shared_experts=1, d_ff_expert=32))


def _routing(cfg, jp, x):
    """Both packages' gates and top-k ids on ``x`` (the router's input)."""
    xt = x.reshape(-1, 64)
    jg = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    _, ji = jmoe._topk(jg, cfg.moe.num_experts_per_tok)
    tg, _, ti = moe._route({"router": _t(np.asarray(jp["router"]))}, _t(xt),
                           torch_model_config(cfg))
    return np.asarray(jg), np.asarray(ji), tg, ti


@pytest.mark.parametrize("dispatch", ["sort", "einsum", "ep"])
@pytest.mark.parametrize("shape", [(2, 12), (4, 8)])
def test_moe_apply_matches_with_equal_routing(dispatch, shape):
    """Same top-k ids in both packages, the k-th gate above the (k+1)-th by
    more than 1e-5 at this seed (so no ulp can flip a route), then outputs
    and the auxiliary loss."""
    cfg = MOE.replace(moe=dataclasses.replace(MOE.moe, dispatch=dispatch))
    jp, tp = _params(jmoe.moe_init, cfg)
    x = _x(10, shape + (64,))
    jg, ji, tg, ti = _routing(cfg, jp, x)
    np.testing.assert_array_equal(ti.numpy(), ji)
    srt = np.sort(jg, axis=-1)[:, ::-1]
    assert (srt[:, 1] - srt[:, 2]).min() > 1e-5
    ty, ta = moe.moe_apply(tp, _t(x), torch_model_config(cfg))
    jcfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="sort")) \
        if dispatch == "ep" else cfg
    jy, ja = _j(jmoe.moe_apply, cfg=jcfg)(jp, jnp.asarray(x))
    _close(ty, jy)                                                          # 1.9e-6
    assert abs(float(ta) - float(ja)) <= 1e-7


@pytest.mark.parametrize("shape", [(4, 32), (2, 64)])
def test_moe_sort_matches_einsum_in_the_port(shape):
    """The reference's own oracle rule, on the port: the sort dispatch
    equals the one-hot einsum, under capacity drops."""
    cfg = MOE.replace(moe=dataclasses.replace(MOE.moe, dispatch="sort"))
    tcfg = torch_model_config(cfg)
    _, tp = _params(jmoe.moe_init, cfg)
    x = _t(_x(11, shape + (64,)))
    ys, a_s = moe.moe_apply(tp, x, tcfg)
    ye, a_e = moe.moe_apply(tp, x, dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, dispatch="einsum")))
    torch.testing.assert_close(ys, ye, atol=1e-5, rtol=0)
    assert abs(float(a_s) - float(a_e)) <= 1e-6
    # capacity drops happen at these shapes: some expert is over-subscribed
    _, ti = moe._topk(moe._route(tp, x.reshape(-1, 64), tcfg)[0], 2)
    assert torch.bincount(ti.reshape(-1), minlength=8).max() > moe.capacity_of(
        x.shape[0] * x.shape[1], tcfg)


def test_moe_aux_loss_increases_with_imbalance():
    cfg = BASE.replace(family="moe", moe=MoEConfig(num_experts=4, num_experts_per_tok=1,
                                                  num_shared_experts=0, d_ff_expert=32))
    tcfg = torch_model_config(cfg)
    _, tp = _params(jmoe.moe_init, cfg)
    x = _t(_x(12, (2, 32, 64)))
    _, balanced = moe.moe_apply(tp, x, tcfg)
    skew = dict(tp, router=tp["router"].clone())
    skew["router"][:, 0] += 100.0
    _, skewed = moe.moe_apply(skew, x, tcfg)
    assert float(skewed) > float(balanced)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def test_linear_scan_equals_the_sequential_recurrence():
    g = torch.Generator().manual_seed(0)
    a = torch.rand((2, 13, 5), generator=g)
    b = torch.randn((2, 13, 5), generator=g)
    h, seq = torch.zeros((2, 5)), []
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    torch.testing.assert_close(recurrent.linear_scan(a, b), torch.stack(seq, 1),
                               atol=1e-6, rtol=0)


def test_rglru_apply_and_decode_match():
    tcfg = torch_model_config(RNN)
    jp, tp = _params(jrec.rglru_init, RNN)
    x = _x(13)
    _close(recurrent.rglru_apply(tp, _t(x), tcfg),
           _j(jrec.rglru_apply, cfg=RNN)(jp, jnp.asarray(x)))              # 9.5e-7
    js, ts = jrec.rglru_init_state(RNN, B), recurrent.rglru_init_state(tcfg, B, CPU)
    jdecode = _j(jrec.rglru_decode, cfg=RNN)
    for t in range(S):
        jo, js = jdecode(jp, jnp.asarray(x[:, t:t + 1]), js)
        to, ts = recurrent.rglru_decode(tp, _t(x[:, t:t + 1]), ts, tcfg)
        _close(to, jo)
        _tree_close(ts, js)


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 4])
def test_mlstm_apply_matches(chunk):
    """The forward does not move with the chunk size (the reference's
    chunked remat is a backward memory trade)."""
    cfg = RNN.replace(mlstm_chunk=chunk)
    tcfg = torch_model_config(cfg)
    jp, tp = _params(jrec.mlstm_init, cfg)
    x = _x(14)
    ty = recurrent.mlstm_apply(tp, _t(x), tcfg)
    _close(ty, _j(jrec.mlstm_apply, cfg=RNN)(jp, jnp.asarray(x)))
    # with a gradient wanted, the chunked loop recomputes in the backward
    leaf = _t(x).requires_grad_(True)
    yg = recurrent.mlstm_apply(tp, leaf, tcfg)
    torch.testing.assert_close(yg.detach(), ty, atol=0, rtol=0)
    yg.sum().backward()
    assert torch.isfinite(leaf.grad).all()


def test_mlstm_decode_matches():
    tcfg = torch_model_config(RNN)
    jp, tp = _params(jrec.mlstm_init, RNN)
    x = _x(15)
    js, ts = jrec.mlstm_init_state(RNN, B), recurrent.mlstm_init_state(tcfg, B, CPU)
    jdecode = _j(jrec.mlstm_decode, cfg=RNN)
    for t in range(S):
        jo, js = jdecode(jp, jnp.asarray(x[:, t:t + 1]), js)
        to, ts = recurrent.mlstm_decode(tp, _t(x[:, t:t + 1]), ts, tcfg)
        _close(to, jo)
        _tree_close(ts, js, atol=1e-5, rtol=1e-5)   # C and n grow with t: 3.8e-6


def test_slstm_apply_and_decode_match():
    tcfg = torch_model_config(RNN)
    jp, tp = _params(jrec.slstm_init, RNN)
    x = _x(16)
    _close(recurrent.slstm_apply(tp, _t(x), tcfg),
           _j(jrec.slstm_apply, cfg=RNN)(jp, jnp.asarray(x)))
    js, ts = jrec.slstm_init_state(RNN, B), recurrent.slstm_init_state(tcfg, B, CPU)
    jdecode = _j(jrec.slstm_decode, cfg=RNN)
    for t in range(S):
        jo, js = jdecode(jp, jnp.asarray(x[:, t:t + 1]), js)
        to, ts = recurrent.slstm_decode(tp, _t(x[:, t:t + 1]), ts, tcfg)
        _close(to, jo)
        _tree_close(ts, js)


def test_init_trees_have_the_reference_layout():
    """Every init of the port builds the reference's tree: the same keys,
    shapes and dtypes (the values are the port's own draws)."""
    g = torch.Generator().manual_seed(0)
    cases = [(jlayers.attention_init, layers.attention_init, BASE.replace(qkv_bias=True)),
             (jlayers.mla_init, layers.mla_init, MLA),
             (jlayers.mlp_init, layers.mlp_init, BASE),
             (jmoe.moe_init, moe.moe_init, MOE),
             (jrec.rglru_init, recurrent.rglru_init, RNN),
             (jrec.mlstm_init, recurrent.mlstm_init, RNN),
             (jrec.slstm_init, recurrent.slstm_init, RNN)]
    for jinit, tinit, cfg in cases:
        jt = np_tree(jinit(jax.random.PRNGKey(0), cfg))
        tt = tinit(g, torch_model_config(cfg), device=CPU)
        flat_j = jax.tree_util.tree_flatten_with_path(jt)[0]
        flat_t = {jax.tree_util.keystr(p): v for p, v in
                  jax.tree_util.tree_flatten_with_path(tt)[0]}
        assert len(flat_j) == len(flat_t)
        for path, leaf in flat_j:
            got = flat_t[jax.tree_util.keystr(path)]
            assert tuple(got.shape) == leaf.shape and str(got.dtype) == f"torch.{leaf.dtype}"
