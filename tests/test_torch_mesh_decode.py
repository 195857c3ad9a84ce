"""The port's serve step executed sharded, on 8 gloo ranks of this CPU,
against the reference's ``jit(serve_step, in_shardings=(param_specs,
cache_shardings, batch_input_shardings, None))`` on 8 fake host devices;
and attention split on ``head_dim`` where ``model`` divides it but not the
heads, in the train and prefill steps.

Each rank holds only its block of every param under ``param_specs`` and
of every cache leaf under ``cache_shardings``, decodes its rows of the
tokens, and returns the logits whole.  From the reference's weights, a
seeded prompt of 8 tokens is prefilled by sequential decode (as
``repro.launch.serve`` does) and 4 more tokens are decoded, each a step:

* ``debug-dense`` and ``debug-moe`` on (4, 2), batch 8: the batch split
  over ``data``, ``head_dim`` over ``model``;
* ``debug-dense`` on (2, 4): a ``model`` of 4 does not divide the 2 kv
  heads, so no rank holds whole heads, but it divides ``head_dim`` (32);
* ``debug-dense`` on (4, 2), batch 1, ``max_len`` 2048: the cache's
  sequence split over ``data`` (each rank holds 512 slots; the softmax
  combined across ``data``); its 4 decoded tokens go to positions
  510-513, so the slots written cross from ``data`` rank 0's to rank 1's
  (the slots between hold zeros, as in the reference's cache);
* the ``rg_hybrid`` variant of ``tests/test_models.py`` (RG-LRU, RG-LRU,
  local attention of window 8) on (4, 2): the recurrent states gathered
  at use and cut back, the ring buffer wrapping at step 8.

For every case: the logits at every step within ``LOGITS_ATOL`` (the
decode limit of ``tests/test_torch_lm_transformer.py``); each rank's cache
blocks of ``NamedSharding.shard_shape`` and equal to the reference's
``addressable_shards`` entry of the device of the rank's index within
``CACHE_ATOL`` (both meshes are ``arange(8).reshape(shape)``); each rank's
held bytes, its param and cache blocks, the closed form.  On (2, 4) also
one prefill step (the last position's logits within ``LOGITS_ATOL``) and
one ``cfl`` train step (the loss within ``LOSS_ATOL``, the params and
each rank's blocks by the rule of ``tests/test_torch_mesh_sharded.py``),
and the gradient of ``lm_loss`` on the rank's blocks, gathered whole,
against the port's own gradient on one device by the rule of
``tests/test_torch_lm_train.py`` (the port's one-device gradient is held
against the reference's there).
The reference's partitioner ran every case here (none is held against the
port's own one-device decode).  One process: the ``head_dim``-split core
with the ``model`` sum done by hand over n blocks equals ``_gqa_core``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import _torch_mesh_ranks as ranks  # noqa: E402
from test_torch_mesh_sharded import (LOSS_ATOL, LR, _assert_close,  # noqa: E402
                                     _leaves)

LOGITS_ATOL = 5e-5
CACHE_ATOL = 1e-5
PROMPT, GEN = 8, 4
# the sequence case's positions: the prompt at 0-7, then 4 tokens decoded
# at 510-513, across the slots of data ranks 0 and 1 (512 each)
SEQ_POSITIONS = tuple(range(PROMPT)) + tuple(range(510, 510 + GEN))

RG_HYBRID = dict(name="t", family="dense", num_layers=5, d_model=64, num_heads=4,
                 num_kv_heads=2, d_ff=128, vocab_size=128,
                 block_pattern=("rglru", "rglru", "local"), local_window=8, rnn_width=64)

DECODE = {
    "dense-(4,2)": dict(arch="debug-dense", params="debug-dense", shape=(4, 2), batch=8,
                        max_len=PROMPT + GEN),
    "moe-(4,2)": dict(arch="debug-moe", params="debug-moe", shape=(4, 2), batch=8,
                      max_len=PROMPT + GEN),
    "dense-(2,4)": dict(arch="debug-dense", params="debug-dense", shape=(2, 4), batch=8,
                        max_len=PROMPT + GEN),
    "dense-(4,2)-seq": dict(arch="debug-dense", params="debug-dense", shape=(4, 2), batch=1,
                            max_len=2048, positions=SEQ_POSITIONS),
    "rg_hybrid-(4,2)": dict(fields=RG_HYBRID, params="rg_hybrid", shape=(4, 2), batch=8,
                            max_len=PROMPT + GEN),
}
PREFILL = {"dense-(2,4)-prefill": dict(arch="debug-dense", params="debug-dense", shape=(2, 4))}
TRAIN = {"dense-(2,4)-cfl": dict(arch="debug-dense", params="debug-dense", shape=(2, 4),
                                 fsdp=False, kind="cfl")}
GRADS = {"dense-(2,4)": dict(arch="debug-dense", params="debug-dense", shape=(2, 4))}
# a gradient leaf's gap to the one-device gradient: the rule of
# tests/test_torch_lm_train.py
GRAD_RTOL, GRAD_ATOL = 1e-5, 5e-6

# per-rank bytes of the param blocks under ``param_specs`` (every split
# even): debug-dense with a model axis of 2, 1,708,544 / 2 (as in
# tests/test_torch_mesh_sharded.py) and of 4, its embedding, attention
# projections, MLP and unembedding cut 4 ways (430,592; norms and biases,
# 5,632 B, whole); debug-moe with a model axis of 2 (1,381,632); the
# rg_hybrid variant on (4, 2), every leaf of two axes or more halved on its
# last (942,848 B whole, of which 4,864 of 1-D leaves stay whole)
PARAM_BYTES = {"dense-(4,2)": 856_576, "moe-(4,2)": 1_381_632, "dense-(2,4)": 430_592,
               "dense-(4,2)-seq": 856_576, "rg_hybrid-(4,2)": (942_848 - 4_864) // 2 + 4_864}
# per-rank bytes of the cache blocks: 2 layers x (k, v) of (B/n_data rows,
# C slots, 2 kv heads, 32/n_model of head_dim) fp32; the sequence case
# 2048/4 slots of its one row; rg_hybrid four RG-LRU layers (h of
# 2 x 32, conv of 2 x 3 x 32) and one local layer (k, v of 2 x 8 x 2 x 8)
CACHE_BYTES = {"dense-(4,2)": 2 * 2 * (2 * 12 * 2 * 16) * 4,
               "moe-(4,2)": 2 * 2 * (2 * 12 * 2 * 16) * 4,
               "dense-(2,4)": 2 * 2 * (4 * 12 * 2 * 8) * 4,
               "dense-(4,2)-seq": 2 * 2 * (1 * 512 * 2 * 16) * 4,
               "rg_hybrid-(4,2)": 4 * (2 * 32 + 2 * 3 * 32) * 4 + 2 * (2 * 8 * 2 * 8) * 4}

_REFERENCE = r"""
import pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.core.topology import AggregationStrategy
from repro.launch.inputs import batch_input_shardings, cache_shardings
from repro.launch.mesh import client_axes_for
from repro.launch.steps import (fed_param_shardings, make_federated_train_step,
                                make_prefill_step, make_serve_step, num_clients,
                                stack_for_clients)
from repro.models import Transformer
from repro.models.config import ModelConfig
from repro.sharding import param_specs, use_mesh

tr = pickle.load(open(sys.argv[1], "rb"))
out = {"decode": {}, "prefill": {}, "train": {}}


def mesh_of(case):
    mesh = Mesh(np.array(jax.devices()).reshape(case["shape"]), ("data", "model"))
    assert [d.id for d in mesh.devices.reshape(-1)] == list(range(8))
    return mesh


def config_of(case):
    return get_config(case["arch"]) if "arch" in case else ModelConfig(**case["fields"])


def shards(tree):
    return jax.tree_util.tree_map(
        lambda a: [np.asarray(s.data) for s in sorted(a.addressable_shards,
                                                      key=lambda s: s.device.id)], tree,
        is_leaf=lambda x: isinstance(x, jax.Array))


for name, case in tr["decode"].items():
    mesh, cfg = mesh_of(case), config_of(case)
    model = Transformer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tr["params"][case["params"]])
    toks = jnp.asarray(tr["tokens"][name], jnp.int32)
    with use_mesh(mesh):
        cache = model.init_cache(toks.shape[0], case["max_len"])
        psh = param_specs(params, mesh, fsdp=cfg.fsdp)
        csh = cache_shardings(cache, mesh)
        tsh = batch_input_shardings({"tokens": toks[:, :1]}, mesh)["tokens"]
        step = jax.jit(make_serve_step(model), in_shardings=(psh, csh, tsh, None),
                       out_shardings=(None, csh))
        cache = jax.device_put(cache, csh)
        logits = []
        for t, pos in enumerate(case.get("positions", range(toks.shape[1]))):
            lg, cache = step(params, cache, toks[:, t:t + 1], pos)
            logits.append(np.asarray(lg))
    out["decode"][name] = dict(
        logits=logits, cache=shards(cache),
        shard_shapes=jax.tree_util.tree_map(lambda a, sh: sh.shard_shape(a.shape), cache, csh))

for name, case in tr["prefill"].items():
    mesh, cfg = mesh_of(case), config_of(case)
    model = Transformer(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, tr["params"][case["params"]])
    batch = {"tokens": jnp.asarray(tr["tokens"][name], jnp.int32)}
    with use_mesh(mesh):
        step = jax.jit(make_prefill_step(model), in_shardings=(
            param_specs(params, mesh, fsdp=cfg.fsdp), batch_input_shardings(batch, mesh)))
        out["prefill"][name] = np.asarray(step(params, batch))

batch = {k: jnp.asarray(v, jnp.int32) for k, v in tr["batch"].items()}
for name, case in tr["train"].items():
    mesh, cfg = mesh_of(case), config_of(case)
    model = Transformer(cfg)
    caxes = client_axes_for(cfg, mesh)
    C = num_clients(mesh, caxes)
    params = jax.tree_util.tree_map(jnp.asarray, tr["params"][case["params"]])
    strat = AggregationStrategy(kind=case["kind"], client_axes=caxes, neighborhood_size=2)
    mask = jnp.ones((max(C, 1),), jnp.float32)
    with use_mesh(mesh):
        step, opt = make_federated_train_step(model, mesh, strat, lr=tr["lr"])
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
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs():
    import torch

    from repro.configs import get_config
    from repro.models.config import ModelConfig
    from repro.models.transformer import Transformer as JTransformer

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        configs = {a: get_config(a) for a in ("debug-dense", "debug-moe")}
        configs["rg_hybrid"] = ModelConfig(**RG_HYBRID)
        params = {k: jax.tree_util.tree_map(np.asarray, JTransformer(c).init(jax.random.PRNGKey(0)))
                  for k, c in configs.items()}
        rng = np.random.default_rng(29)
        tokens = {name: rng.integers(0, configs[c["params"]].vocab_size,
                                     (c["batch"], PROMPT + GEN)).astype(np.int64)
                  for name, c in DECODE.items()}
        tokens.update({name: rng.integers(0, 512, (8, 16)).astype(np.int64) for name in PREFILL})
        toks = rng.integers(0, 512, (8, 17))
        batch = {"tokens": toks[:, :-1].astype(np.int64), "labels": toks[:, 1:].astype(np.int64)}
        data = dict(params=params, tokens=tokens, decode=DECODE, prefill=PREFILL, train=TRAIN,
                    grads=GRADS, lr=LR, batch=batch)
        ref, port = ranks.run_with_reference(_REFERENCE, data, ranks.decode_cases)
    finally:
        torch.set_num_threads(prev)
    return dict(ref=ref, port=port)


@pytest.mark.parametrize("name", DECODE)
def test_sharded_decode_logits_match_the_reference(runs, name):
    """Every rank's logits, whole, at every step (the prompt's 8 and the 4
    decoded)."""
    want = runs["ref"]["decode"][name]["logits"]
    for rank, per_rank in enumerate(runs["port"]):
        got = per_rank["decode"][name]["logits"]
        assert len(got) == len(want) == PROMPT + GEN
        for t, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (name, rank, t, g.shape, w.shape)
            gap = float(np.abs(g - w).max())
            assert gap <= LOGITS_ATOL, (name, rank, t, gap)


@pytest.mark.parametrize("name", DECODE)
def test_rank_cache_blocks_match_the_reference_shards(runs, name):
    """Each rank's cache block after the last step: the shard shape and
    values of the reference's shard on the device of its index."""
    want = runs["ref"]["decode"][name]
    ref_blocks = _leaves(want["cache"])                    # (8, *block) per leaf
    shapes = _leaves(want["shard_shapes"])
    for rank, per_rank in enumerate(runs["port"]):
        blocks = _leaves(per_rank["decode"][name]["cache"])
        assert set(blocks) == set(ref_blocks)
        for k, b in blocks.items():
            assert b.shape == tuple(shapes[k]), (name, k, b.shape, shapes[k])
            gap = float(np.abs(b - ref_blocks[k][rank]).max())
            assert gap <= CACHE_ATOL, (name, rank, k, gap)


@pytest.mark.parametrize("name", DECODE)
def test_held_decode_bytes_match_the_closed_form(runs, name):
    """The param and cache blocks a rank holds going in, on every rank."""
    want = PARAM_BYTES[name] + CACHE_BYTES[name]
    assert [r["decode"][name]["held"] for r in runs["port"]] == [want] * 8


@pytest.mark.parametrize("name", PREFILL)
def test_head_dim_split_prefill_matches_the_reference(runs, name):
    """The prefill step where ``model`` divides ``head_dim`` but not the
    heads: the last position's logits, whole, on every rank."""
    want = runs["ref"]["prefill"][name]
    for per_rank in runs["port"]:
        got = per_rank["prefill"][name]
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= LOGITS_ATOL


@pytest.mark.parametrize("name", TRAIN)
def test_head_dim_split_train_step_matches_the_reference(runs, name):
    """One ``cfl`` step on (2, 4): every rank's loss; the params put
    together from the ranks' blocks; each rank's blocks against the
    reference's shards, of the shard shapes, params and Adam."""
    import torch

    from repro_torch.sharding.specs import AbstractMesh, P, leaf_from_blocks

    want = runs["ref"]["train"][name]
    for per_rank in runs["port"]:
        assert abs(per_rank["train"][name]["loss"] - want["loss"]) <= LOSS_ATOL
    specs = runs["port"][0]["train"][name]["specs"]
    per_rank = [_leaves(r["train"][name]["blocks"]) for r in runs["port"]]
    mesh = AbstractMesh(("data", "model"), TRAIN[name]["shape"])
    got = {k: leaf_from_blocks([torch.from_numpy(b[k]) for b in per_rank], P(*specs[k]),
                               mesh).numpy() for k in per_rank[0]}
    _assert_close(got, _leaves(want["params"]), name)
    ref_blocks = _leaves(want["blocks"])
    p_shapes, mu_shapes, _ = (_leaves(t) for t in want["shard_shapes"])
    for rank, r in enumerate(runs["port"]):
        blocks = _leaves(r["train"][name]["blocks"])
        for k, b in blocks.items():
            assert b.shape == tuple(p_shapes[k]), (k, b.shape, p_shapes[k])
            assert tuple(r["train"][name]["adam"]["mu"][k]) == tuple(mu_shapes[k]), k
        _assert_close(blocks, {k: v[rank] for k, v in ref_blocks.items()}, f"{name} rank {rank}")


@pytest.mark.parametrize("name", GRADS)
def test_head_dim_split_gradient_equals_the_one_device_gradient(runs, name):
    """The gradient of ``lm_loss`` on the rank's blocks, attention split on
    ``head_dim`` (its leaves' gradients summed over ``model``), gathered
    whole on every rank, against the port's gradient on one device: the
    train step's Adam update alone would hide a gradient scaled by a
    constant."""
    want = _leaves(runs["port"][0]["grads"][name]["one_device"])
    for rank, per_rank in enumerate(runs["port"]):
        got = _leaves(per_rank["grads"][name]["sharded"])
        assert set(got) == set(want)
        for k, w in want.items():
            gap = float(np.abs(got[k] - w).max())
            assert gap <= GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL, (rank, k, gap)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("window", (None, 5))
def test_head_dim_split_core_equals_the_one_device_core(n, window):
    """The split core's two halves with the ``model`` sum done by hand over
    ``n`` blocks of ``head_dim``: the partial scores of each block summed,
    then each block's output columns, put side by side, against
    ``_gqa_core`` (after RoPE, as the layers apply it whole)."""
    import torch

    from repro_torch.models import layers
    from repro_torch.sharding.ctx import ModelSplit

    g = torch.Generator().manual_seed(n)
    B, S, H, K, dh = 2, 7, 4, 2, 32
    q, k, v = (torch.randn((B, S, h, dh), generator=g) for h in (H, K, K))
    pos = torch.arange(S)[None, :]
    q, k = layers.apply_rope(q, pos, 10000.0), layers.apply_rope(k, pos, 10000.0)
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    mask = (j <= i) & ((j > i - window) if window else True)
    mask = mask[None, None, None]
    want = layers._gqa_core(q, k, v, mask)
    tps = [ModelSplit(None, n, m) for m in range(n)]
    scores = sum(layers.split_scores(layers.head_dim_block(q, tp), layers.head_dim_block(k, tp))
                 for tp in tps)
    got = torch.cat([layers.split_output(scores, layers.head_dim_block(v, tp), mask, dh)
                     for tp in tps], dim=-1)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-6
