"""The mixer variants of the reference's ``tests/test_models.py`` computed
split over ``model`` on 8 gloo ranks of this CPU, against the reference on
8 fake host devices; the LM loss vocab-parallel; and, in one process, the
split math with the ``model`` sums done by hand.

The variants (``BASE``: vocab 128, 4 heads, 2 kv heads, on (4, 2)):

* tied + MTP, without fsdp (the embedding's vocab rows on ``model``) and
  with it (on ``("data", "model")``: a rank's rows after the ``data``
  gather are strided vocab ranges);
* encoder-decoder (2 encoder layers, frames given): the encoder's
  bidirectional attention and the decoder's cross-attention head-parallel;
* ``mla``: head-parallel (``wuq``, ``wuk``, ``wuv`` the rank's heads);
* ``rg_hybrid``: the RG-LRU channel-parallel.

For each, one ``cfl`` step from the same seeded weights on a seeded
8 x 16 batch (plain data parallel under fsdp, which federates over ``pod``
alone): the loss within ``LOSS_ATOL``; the params put together and each
rank's blocks against the reference's shards by the rule of
``tests/test_torch_mesh_sharded.py``, of the reference's shard shapes;
each rank's held bytes (params, ``mu``, ``nu``) the closed form (Adam's
blocks of an encoder's per-layer 1-D leaves split over ``model``, as the
reference places them, where the params' are whole).  The gradient of ``lm_loss`` on the rank's blocks, gathered whole,
against the port's own one-device gradient (the rule of
``tests/test_torch_lm_train.py``; also for the encoder-decoder on (2, 4),
where ``model`` divides ``head_dim`` but not the kv heads, so the encoder
and cross-attention split ``head_dim``).  The encoder-decoder and
``rg_hybrid`` also decode: a prompt of 8 prefilled by sequential decode
and 4 more tokens, the logits at every step within ``LOGITS_ATOL``, the
cache blocks against the reference's shards, the held param and cache
bytes the closed form, and the RG-LRU's states used as held (no decode
state gathered).  ``debug-dense``'s ``cfl`` step on (4, 2) records no
all-gather of its whole logits.

The reference's partitioner ran every case here (none is held against the
port's own one-device step)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import _torch_mesh_ranks as ranks  # noqa: E402
from test_torch_mesh_decode import CACHE_ATOL, LOGITS_ATOL, PROMPT, GEN  # noqa: E402
from test_torch_mesh_sharded import LOSS_ATOL, LR, _assert_close, _leaves  # noqa: E402

BASE = dict(name="t", family="dense", num_layers=3, d_model=64, num_heads=4, num_kv_heads=2,
            d_ff=128, vocab_size=128)
MLA = dict(q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16)
FIELDS = {
    "tied_mtp": dict(BASE, tie_embeddings=True, mtp_depth=1),
    "encdec": dict(BASE, encoder_layers=2),
    "mla": dict(BASE, block_pattern=("mla",), mla=MLA),
    "rg_hybrid": dict(BASE, num_layers=5, block_pattern=("rglru", "rglru", "local"),
                      local_window=8, rnn_width=64),
}
B, S = 8, 16


def _case(params, fsdp=False, **kw):
    return dict(fields=FIELDS[params], params=params, shape=(4, 2), fsdp=fsdp, kind="cfl", **kw)


TRAIN = {"tied_mtp": _case("tied_mtp"), "tied_mtp-fsdp": _case("tied_mtp", fsdp=True),
         "encdec": _case("encdec"), "mla": _case("mla"), "rg_hybrid": _case("rg_hybrid")}
DECODE = {name: dict(fields=FIELDS[name], params=name, shape=(4, 2), batch=B,
                     max_len=PROMPT + GEN) for name in ("encdec", "rg_hybrid")}
GRADS = {name: dict(case, batch=name) for name, case in TRAIN.items()}
GRADS["encdec-(2,4)"] = dict(_case("encdec"), shape=(2, 4), batch="encdec")
# debug-dense on (4, 2), for the logits' collectives
DENSE = "debug-dense-cfl"
GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-6

# per-rank bytes of the param blocks on (4, 2) (every split even): without
# fsdp every leaf of two axes or more (past a stacked layer axis) halved on
# ``model``, the 1-D leaves whole (whole, of which 1-D: tied + MTP 657,920
# and 2,560; encoder-decoder 954,112 and 3,840; mla 615,296 and 2,944;
# rg_hybrid 942,848 and 4,864); with fsdp cut 8 ways
PARAM_BYTES = {"tied_mtp": (657_920 - 2_560) // 2 + 2_560,
               "tied_mtp-fsdp": (657_920 - 2_560) // 8 + 2_560,
               "encdec": (954_112 - 3_840) // 2 + 3_840,
               "mla": (615_296 - 2_944) // 2 + 2_944,
               "rg_hybrid": (942_848 - 4_864) // 2 + 4_864}
# ... and of the Adam blocks (``mu`` and ``nu`` each): the reference's
# rules split an encoder's per-layer 1-D leaves (norm1 and norm2 scales,
# (2, 64) fp32) over ``model`` under an optimizer state's path, so each of
# the two holds 256 of its 512 bytes there
ADAM_BYTES = dict(PARAM_BYTES, encdec=PARAM_BYTES["encdec"] - 2 * 256)
# per-rank bytes of the cache blocks: the encoder-decoder's 3 layers x (k,
# v) of 2 rows x 12 slots x 2 kv heads x 8 of head_dim; rg_hybrid's as in
# tests/test_torch_mesh_decode.py
CACHE_BYTES = {"encdec": 3 * 2 * (2 * 12 * 2 * 8) * 4,
               "rg_hybrid": 4 * (2 * 32 + 2 * 3 * 32) * 4 + 2 * (2 * 8 * 2 * 8) * 4}

_REFERENCE = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.topology import AggregationStrategy
from repro.launch.inputs import batch_input_shardings, cache_shardings
from repro.launch.mesh import client_axes_for
from repro.launch.steps import (fed_param_shardings, make_federated_train_step,
                                make_serve_step, num_clients, stack_for_clients)
from repro.models import Transformer
from repro.models.config import MLAConfig, ModelConfig
from repro.sharding import param_specs, use_mesh

tr = pickle.load(open(sys.argv[1], "rb"))
out = {"decode": {}, "train": {}}


def mesh_of(case):
    mesh = Mesh(np.array(jax.devices()).reshape(case["shape"]), ("data", "model"))
    assert [d.id for d in mesh.devices.reshape(-1)] == list(range(8))
    return mesh


def config_of(case):
    f = dict(case["fields"])
    if "mla" in f:
        f["mla"] = MLAConfig(**f["mla"])
    return ModelConfig(**f).replace(fsdp=case.get("fsdp", False))


def shards(tree):
    return jax.tree_util.tree_map(
        lambda a: [np.asarray(s.data) for s in sorted(a.addressable_shards,
                                                      key=lambda s: s.device.id)], tree,
        is_leaf=lambda x: isinstance(x, jax.Array))


def as_batch(b):
    return {k: jnp.asarray(v, jnp.int32 if np.issubdtype(v.dtype, np.integer) else v.dtype)
            for k, v in b.items()}


for name, case in tr["train"].items():
    mesh, cfg = mesh_of(case), config_of(case)
    model = Transformer(cfg)
    caxes = client_axes_for(cfg, mesh)
    C = num_clients(mesh, caxes)
    params = jax.tree_util.tree_map(jnp.asarray, tr["params"][case["params"]])
    batch = as_batch(tr["batches"][name])
    strat = AggregationStrategy(kind=case["kind"], client_axes=caxes, neighborhood_size=2)
    mask = jnp.ones((max(C, 1),), jnp.float32)
    with use_mesh(mesh):
        step, opt = make_federated_train_step(model, mesh, strat, lr=tr["lr"])
        if not caxes:
            p, o = params, opt.init(params)
            psh = param_specs(p, mesh, fsdp=cfg.fsdp)
            osh = param_specs(o, mesh, fsdp=cfg.fsdp)
            bsh = batch_input_shardings(batch, mesh)
        else:
            p, o = stack_for_clients(params, C), stack_for_clients(opt.init(params), C)
            psh = fed_param_shardings(jax.eval_shape(lambda: p), mesh, caxes, cfg.fsdp)
            osh = fed_param_shardings(jax.eval_shape(lambda: o), mesh, caxes, cfg.fsdp)
            bsh = batch_input_shardings(batch, mesh, client_stacked=True, client_axes=caxes)
        p2, o2, loss = jax.jit(step, in_shardings=(psh, osh, bsh, None),
                               out_shardings=(psh, osh, None))(p, o, batch, mask)
    out["train"][name] = dict(
        loss=float(loss), params=jax.tree_util.tree_map(np.asarray, p2), blocks=shards(p2),
        shard_shapes=jax.tree_util.tree_map(lambda a, sh: sh.shard_shape(a.shape),
                                            (p, o.mu, o.nu), (psh, osh.mu, osh.nu)))

for name, case in tr["decode"].items():
    mesh, cfg = mesh_of(case), config_of(case)
    model = Transformer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tr["params"][case["params"]])
    toks = jnp.asarray(tr["tokens"][name], jnp.int32)
    memory = tr["memory"].get(name)
    with use_mesh(mesh):
        cache = model.init_cache(toks.shape[0], case["max_len"])
        psh = param_specs(params, mesh, fsdp=cfg.fsdp)
        csh = cache_shardings(cache, mesh)
        tsh = batch_input_shardings({"tokens": toks[:, :1]}, mesh)["tokens"]
        shardings = (psh, csh, tsh, None) + ((None,) if memory is not None else ())
        step = jax.jit(make_serve_step(model), in_shardings=shardings,
                       out_shardings=(None, csh))
        cache = jax.device_put(cache, csh)
        extra = (jnp.asarray(memory),) if memory is not None else ()
        logits = []
        for t in range(toks.shape[1]):
            lg, cache = step(params, cache, toks[:, t:t + 1], t, *extra)
            logits.append(np.asarray(lg))
    out["decode"][name] = dict(
        logits=logits, cache=shards(cache),
        shard_shapes=jax.tree_util.tree_map(lambda a, sh: sh.shard_shape(a.shape), cache, csh))
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs():
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Transformer
    from repro_torch.utils.tree import to_numpy

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # the port's seeded weights (the reference's tree, leaf for leaf)
        configs = {name: ranks.case_config(dict(fields=f)) for name, f in FIELDS.items()}
        configs["debug-dense"] = get_config("debug-dense")
        params = {name: to_numpy(Transformer(cfg, device="cpu").init(
            torch.Generator().manual_seed(0))) for name, cfg in configs.items()}
        rng = np.random.default_rng(30)
        batches = {}
        for name, case in TRAIN.items():
            toks = rng.integers(0, case["fields"]["vocab_size"], (B, S + 1))
            batches[name] = {"tokens": toks[:, :-1].astype(np.int64),
                             "labels": toks[:, 1:].astype(np.int64)}
            if case["fields"].get("encoder_layers"):
                batches[name]["frames"] = rng.standard_normal(
                    (B, S, BASE["d_model"])).astype(np.float32)
        toks = rng.integers(0, 512, (B, S + 1))
        batches[DENSE] = {"tokens": toks[:, :-1].astype(np.int64),
                          "labels": toks[:, 1:].astype(np.int64)}
        tokens = {name: rng.integers(0, BASE["vocab_size"], (B, PROMPT + GEN)).astype(np.int64)
                  for name in DECODE}
        memory = {"encdec": rng.standard_normal((B, S, BASE["d_model"])).astype(np.float32)}
        data = dict(params=params, lr=LR, train=TRAIN, batches=batches, decode=DECODE,
                    tokens=tokens, memory=memory, grads=GRADS)
        ref_data = dict(data, batches={k: v for k, v in batches.items() if k in TRAIN})
        port_data = dict(data, train=dict(TRAIN, **{DENSE: dict(
            arch="debug-dense", params="debug-dense", shape=(4, 2), fsdp=False, kind="cfl")}))
        ref, port = ranks.run_with_reference(_REFERENCE, ref_data, ranks.variant_cases,
                                             port_data)
    finally:
        torch.set_num_threads(prev)
    return dict(ref=ref, port=port)


def _mesh(shape):
    from repro_torch.sharding.specs import AbstractMesh

    return AbstractMesh(("data", "model"), shape)


@pytest.mark.parametrize("name", TRAIN)
def test_variant_step_loss_and_params_match_the_reference(runs, name):
    """Every rank's loss; the params put together from the ranks' blocks."""
    import torch

    from repro_torch.sharding.specs import P, leaf_from_blocks

    want = runs["ref"]["train"][name]
    for per_rank in runs["port"]:
        got = per_rank["train"][name]["loss"]
        assert abs(got - want["loss"]) <= LOSS_ATOL, (name, got, want["loss"])
    specs = runs["port"][0]["train"][name]["specs"]
    per_rank = [_leaves(r["train"][name]["blocks"]) for r in runs["port"]]
    got = {k: leaf_from_blocks([torch.from_numpy(b[k]) for b in per_rank], P(*specs[k]),
                               _mesh(TRAIN[name]["shape"])).numpy() for k in per_rank[0]}
    _assert_close(got, _leaves(want["params"]), name)


@pytest.mark.parametrize("name", TRAIN)
def test_variant_rank_blocks_match_the_reference_shards(runs, name):
    """Each rank's param blocks: the reference's shard on the device of its
    index, of the shard shapes, as its Adam blocks."""
    want = runs["ref"]["train"][name]
    ref_blocks = _leaves(want["blocks"])
    p_shapes, mu_shapes, nu_shapes = (_leaves(t) for t in want["shard_shapes"])
    for rank, per_rank in enumerate(runs["port"]):
        got = per_rank["train"][name]
        blocks = _leaves(got["blocks"])
        assert set(blocks) == set(ref_blocks) == set(got["adam"]["mu"])
        for k, b in blocks.items():
            assert b.shape == tuple(p_shapes[k]), (k, b.shape, p_shapes[k])
            assert tuple(got["adam"]["mu"][k]) == tuple(mu_shapes[k]), k
            assert tuple(got["adam"]["nu"][k]) == tuple(nu_shapes[k]), k
        _assert_close(blocks, {k: v[rank] for k, v in ref_blocks.items()}, f"{name} rank {rank}")


@pytest.mark.parametrize("name", TRAIN)
def test_variant_held_bytes_match_the_closed_form(runs, name):
    """Params, ``mu`` and ``nu``: the per-rank parameter bytes and twice the
    Adam bytes."""
    want = PARAM_BYTES[name] + 2 * ADAM_BYTES[name]
    assert [r["train"][name]["held"] for r in runs["port"]] == [want] * 8


@pytest.mark.parametrize("name", GRADS)
def test_variant_gradient_equals_the_one_device_gradient(runs, name):
    """The gradient of ``lm_loss`` on the rank's blocks (the vocab-parallel
    loss, under fsdp on strided vocab rows; the split mixers' leaves used
    in part summed over ``model``: MLA's downs and norms, the RG-LRU's
    ``lam``, ``conv_b`` and ``wo``), gathered whole, against the port's
    gradient on one device: an Adam step alone would hide a gradient off
    by a constant factor."""
    want = _leaves(runs["port"][0]["grads"][name]["one_device"])
    for rank, per_rank in enumerate(runs["port"]):
        got = _leaves(per_rank["grads"][name]["sharded"])
        assert set(got) == set(want)
        for k, w in want.items():
            gap = float(np.abs(got[k] - w).max())
            assert gap <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL, (name, rank, k, gap)


@pytest.mark.parametrize("name", DECODE)
def test_variant_decode_matches_the_reference(runs, name):
    """The logits, whole, at every step on every rank; each rank's cache
    blocks against the reference's shards; the held bytes; no RG-LRU
    state gathered at use."""
    want = runs["ref"]["decode"][name]
    ref_blocks, shapes = _leaves(want["cache"]), _leaves(want["shard_shapes"])
    for rank, per_rank in enumerate(runs["port"]):
        got = per_rank["decode"][name]
        assert len(got["logits"]) == len(want["logits"]) == PROMPT + GEN
        for t, (g, w) in enumerate(zip(got["logits"], want["logits"])):
            assert g.shape == w.shape
            gap = float(np.abs(g - w).max())
            assert gap <= LOGITS_ATOL, (name, rank, t, gap)
        blocks = _leaves(got["cache"])
        assert set(blocks) == set(ref_blocks)
        for k, b in blocks.items():
            assert b.shape == tuple(shapes[k]), (name, k, b.shape, shapes[k])
            gap = float(np.abs(b - ref_blocks[k][rank]).max())
            assert gap <= CACHE_ATOL, (name, rank, k, gap)
        assert got["gathered"] == [], got["gathered"]
    assert [r["decode"][name]["held"] for r in runs["port"]] == \
        [PARAM_BYTES[name] + CACHE_BYTES[name]] * 8


def test_dense_step_keeps_the_logits_in_vocab_blocks(runs):
    """``debug-dense``'s ``cfl`` step on (4, 2): a rank's 2 rows x 16
    positions of logits are a block of 256 of the 512 vocab columns, and no
    all-gather puts them together (the whole logits would be 65,536 B); the
    loss's maxima are gathered instead (2 ranks x 32 rows fp32, forward
    and the MTP-free loss once)."""
    whole = 2 * S * 512 * 4
    for per_rank in runs["port"]:
        events = per_rank["train"][DENSE]["collectives"]
        gathers = [n for kind, n in events if kind == "all-gather"]
        assert whole not in gathers, gathers
        assert gathers.count(2 * 2 * S * 4) == 1, gathers


# ---------------------------------------------------------------------------
# one process: the split math with the ``model`` sums done by hand
# ---------------------------------------------------------------------------


def _vocab(axes, n, index, vocab):
    from repro_torch.models.transformer import VocabSplit

    sizes = {"data": 2, "model": n}
    return VocabSplit(_mesh((sizes["data"], n)), axes, index, vocab)


@pytest.mark.parametrize("axes", [("model",), ("data", "model")])
@pytest.mark.parametrize("n", (2, 4))
def test_vocab_blocks_partition_the_vocab_as_the_embedding_blocks(axes, n):
    """The ids of every ``model`` index's block partition the vocab, each
    at the row :meth:`VocabSplit.locate` gives; under ``("data",
    "model")`` a block (strided ranges) is the embedding's rows a rank
    holds once its ``data`` blocks are gathered."""
    import torch

    from repro_torch.sharding.specs import P, leaf_block

    V = 64
    emb = torch.arange(V * 3, dtype=torch.float32).reshape(V, 3)
    seen = []
    for m in range(n):
        vs = _vocab(axes, n, m, V)
        ids = vs.ids()
        owner, row = vs.locate(ids)
        assert bool((owner == m).all()) and torch.equal(row, torch.arange(V // n))
        rows = torch.cat([leaf_block(emb, P(axes if len(axes) > 1 else axes[0], None),
                                     _mesh((2, n)), {"data": d, "model": m})
                          for d in range(2 if "data" in axes else 1)])
        assert torch.equal(rows, emb[ids])
        seen += ids.tolist()
    assert sorted(seen) == list(range(V))
    if axes == ("data", "model"):
        assert _vocab(axes, n, 0, V).ids().tolist() != list(range(V // n))


@pytest.mark.parametrize("axes", [("model",), ("data", "model")])
@pytest.mark.parametrize("n", (2, 4))
def test_vocab_cross_entropy_by_hand_equals_cross_entropy_loss(axes, n):
    """Each block's part (:func:`steps.vocab_terms`) from the maximum over
    every block, the parts summed by hand, ``mean(log(sum) + max - label
    logit)``: the value and its gradient with respect to the whole logits
    equal ``cross_entropy_loss``'s within 1e-6."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import cross_entropy_loss

    g = torch.Generator().manual_seed(n)
    N, V = 24, 64
    whole = (torch.randn((N, V), generator=g) * 3).requires_grad_(True)
    labels = torch.randint(0, V, (N,), generator=g)
    splits = [_vocab(axes, n, m, V) for m in range(n)]
    blocks = [whole[:, vs.ids()] for vs in splits]
    top = torch.stack([b.detach().amax(dim=-1) for b in blocks]).amax(dim=0)
    parts = [steps.vocab_terms(b, labels, top, vs) for b, vs in zip(blocks, splits)]
    s, lab = sum(p[0] for p in parts), sum(p[1] for p in parts)
    got = torch.mean(torch.log(s) + top - lab)
    (g_got,) = torch.autograd.grad(got, whole)
    want = cross_entropy_loss(whole, labels)
    (g_want,) = torch.autograd.grad(want, whole)
    assert abs(float((got - want).detach())) <= 1e-6
    assert float((g_got - g_want).abs().max()) <= 1e-6


def _grads_close(got, want, tol):
    for k, w in want.items():
        gap = float((got[k] - w).abs().max())
        assert gap <= tol * float(w.abs().max()) + tol, (k, gap)


@pytest.mark.parametrize("n", (2, 4))
def test_head_split_mla_by_hand_equals_mla_apply(n):
    """``mla_heads`` on each rank's head columns of ``wuq``, ``wuk`` and
    ``wuv`` (the downs, norms and rope key whole), the heads put side by
    side through ``wo``: the output and every leaf's gradient, the norm
    scales included, equal ``mla_apply``'s."""
    import torch

    from repro_torch.models import layers
    from repro_torch.models.config import MLAConfig, ModelConfig

    cfg = ModelConfig(**dict(FIELDS["mla"], mla=MLAConfig(**MLA)))
    g = torch.Generator().manual_seed(n)
    params = layers.mla_init(g, cfg)
    params["q_norm"]["scale"] = 1 + 0.1 * torch.randn(MLA["q_lora_rank"], generator=g)
    params["kv_norm"]["scale"] = 1 + 0.1 * torch.randn(MLA["kv_lora_rank"], generator=g)
    x = torch.randn((2, 7, cfg.d_model), generator=g)
    r = torch.randn((2, 7, cfg.d_model), generator=g)
    flat = {"wdq": params["wdq"], "q_norm": params["q_norm"]["scale"], "wuq": params["wuq"],
            "wdkv": params["wdkv"], "kv_norm": params["kv_norm"]["scale"],
            "wuk": params["wuk"], "wuv": params["wuv"], "wkr": params["wkr"], "wo": params["wo"]}
    flat = {k: v.clone().requires_grad_(True) for k, v in flat.items()}

    def tree(f, cols=None):
        cut = (lambda w: w) if cols is None else (lambda w: w.reshape(w.shape[0], cfg.num_heads,
                                                                      -1)[:, cols].flatten(1))
        return {"wdq": f["wdq"], "q_norm": {"scale": f["q_norm"]}, "wuq": cut(f["wuq"]),
                "wdkv": f["wdkv"], "kv_norm": {"scale": f["kv_norm"]}, "wuk": cut(f["wuk"]),
                "wuv": cut(f["wuv"]), "wkr": f["wkr"], "wo": f["wo"]}

    want = layers.mla_apply(tree(flat), x, cfg)
    g_want = dict(zip(flat, torch.autograd.grad(torch.sum(want * r), list(flat.values()))))
    pos = torch.arange(7)[None, :]
    h = cfg.num_heads // n
    heads = [layers.mla_heads(tree(flat, slice(m * h, (m + 1) * h)), x, cfg, pos)
             for m in range(n)]
    got = torch.cat(heads, dim=-1) @ flat["wo"]
    g_got = dict(zip(flat, torch.autograd.grad(torch.sum(got * r), list(flat.values()))))
    assert float((got - want).detach().abs().max()) <= 1e-6
    _grads_close(g_got, g_want, 1e-6)


@pytest.mark.parametrize("n", (2, 4))
def test_channel_split_rglru_by_hand_equals_rglru_apply(n):
    """Each rank's channels: ``rglru_input`` on its columns of ``wx``,
    ``wy``, ``conv_w`` and its slice of ``conv_b``; the conv'd inputs put
    together by hand; ``rglru_mix`` with its columns of the gates and its
    slice of ``lam``; the ranks' outputs through their rows of ``wo``,
    summed.  The output and every leaf's gradient, ``lam`` and ``conv_b``
    included, equal ``rglru_apply``'s."""
    import torch

    from repro_torch.models import recurrent
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(**FIELDS["rg_hybrid"])
    g = torch.Generator().manual_seed(n)
    params = recurrent.rglru_init(g, cfg)
    params["conv_b"] = 0.1 * torch.randn(params["conv_b"].shape, generator=g)
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    x = torch.randn((2, 9, cfg.d_model), generator=g)
    r = torch.randn((2, 9, cfg.d_model), generator=g)
    want = recurrent.rglru_apply(params, x, cfg)
    g_want = dict(zip(params, torch.autograd.grad(torch.sum(want * r), list(params.values()))))
    W = recurrent.rglru_width(cfg)
    w = W // n
    blocks = []
    for m in range(n):
        c = slice(m * w, (m + 1) * w)
        blocks.append({k: (v[c] if v.dim() == 1 else v[:, c]) for k, v in params.items()
                       if k != "wo"})
    ins = [recurrent.rglru_input(p, x) for p in blocks]
    u_all = torch.cat([u for _, u in ins], dim=-1)
    got = sum(recurrent.rglru_mix(p, gate, u, u_all) @ params["wo"][m * w:(m + 1) * w]
              for m, (p, (gate, u)) in enumerate(zip(blocks, ins)))
    g_got = dict(zip(params, torch.autograd.grad(torch.sum(got * r), list(params.values()))))
    assert float((got - want).detach().abs().max()) <= 1e-6
    _grads_close(g_got, g_want, 1e-6)
