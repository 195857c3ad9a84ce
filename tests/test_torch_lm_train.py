"""The LM zoo's training loss in the port against the reference, on the
reference's own params converted (fp32, B = 2, S = 12): ``lm_loss`` and its
gradient for every configuration of ``tests/test_torch_lm_transformer.py``
(each mixer variant, the special heads, the registered presets), the
per-block remat against none, the token pipeline, the participation mask and
``cross_entropy_loss``.

Tolerances: the loss within 5e-6 (largest measured on this CPU: 1.4e-6,
the MTP head); each gradient leaf within ``1e-5 * max|g_ref| + 5e-6`` (the
largest gap, 0.57 of its limit, is the xLSTM's ``embed``: 6.8e-5 on values
up to 24.0, where the reference's own jit and eager gradients differ by
1.5e-5).  Remat on and off are equal bit for bit on the CPU."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import incentive as jincentive  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import classifiers as jclassifiers  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
from repro_torch.core import incentive  # noqa: E402
from repro_torch.core.topology import AggregationStrategy  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import Transformer, cross_entropy_loss  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.sharding.specs import AbstractMesh  # noqa: E402
from repro_torch.utils.tree import from_jax_params, tree_leaves, value_and_grad  # noqa: E402

from _torch_ref import np_tree, torch_model_config  # noqa: E402
from test_torch_lm_transformer import B, CONFIGS, S, _inputs, _port_batch  # noqa: E402

CPU = torch.device("cpu")
LOSS_ATOL = 5e-6
GRAD_REL, GRAD_ABS = 1e-5, 5e-6


def _labels(cfg):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(4), (B, S), 0, cfg.vocab_size))



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's small ops on one thread: beside the suite's other
    workers, torch's intra-op threads oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graded():
    """Per config: the reference's loss and gradient (jitted once), the
    port's model, converted params and batch."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        cfg = CONFIGS[name]
        jm = JTransformer(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        batch = dict(_inputs(cfg), labels=_labels(cfg))
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jsteps.lm_loss(jm, p, b)))(jp, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
        tm = Transformer(torch_model_config(cfg), device=CPU)
        cache[name] = (float(jloss), np_tree(jgrads), tm, from_jax_params(np_tree(jp), CPU),
                       _port_batch(batch))
        return cache[name]

    return get


def _port_value_and_grad(tm, tp, batch):
    return value_and_grad(lambda p: steps.lm_loss(tm, p, batch), tp)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_lm_loss_and_gradient_match_the_reference(graded, name):
    """``lm_loss`` (the VLM prefix cut, ``aux_loss``, the MTP term) and its
    gradient with respect to every leaf of the params."""
    jloss, jgrads, tm, tp, batch = graded(name)
    loss, grads = _port_value_and_grad(tm, tp, batch)
    assert abs(float(loss) - jloss) <= LOSS_ATOL
    assert sorted(grads) == sorted(jgrads)
    for (path, g), (_, jg) in zip(_leaves_with_paths(grads), _leaves_with_paths(jgrads)):
        jg = torch.from_numpy(np.array(jg))
        assert g.shape == jg.shape and g.dtype == jg.dtype, path
        limit = GRAD_REL * float(jg.abs().max()) + GRAD_ABS
        gap = float((g - jg).abs().max())
        assert gap <= limit, f"{name} {path}: {gap} > {limit}"


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [lp for k in sorted(tree) for lp in _leaves_with_paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("name", list(CONFIGS) + ["debug-moe/sort"])
def test_remat_equals_no_remat_bit_for_bit(graded, name):
    """Each block under ``torch.utils.checkpoint`` recomputes the same
    forward: the loss and every gradient leaf equal those with
    ``remat=False``.  ``debug-moe/sort`` runs the preset's MoE through the
    sort dispatch (a stable argsort and an ``index_add_`` of k = 2 terms)."""
    base, _, dispatch = name.partition("/")
    _, _, tm, tp, batch = graded(base)
    cfg = tm.cfg
    if dispatch:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    assert cfg.remat
    on = _port_value_and_grad(Transformer(cfg, device=CPU), tp, batch)
    off = _port_value_and_grad(Transformer(cfg.replace(remat=False), device=CPU), tp, batch)
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree_leaves(on[1]), tree_leaves(off[1])):
        assert torch.equal(a, b)


def test_remat_wraps_each_block_only_while_autograd_records(graded, monkeypatch):
    """A training forward checkpoints every block of the stack (not the MTP
    head's block); a forward under ``no_grad`` (prefill, serve) calls each
    block directly."""
    from repro_torch.models import transformer

    calls = []
    real = transformer.checkpoint

    def counting(fn, *args, **kw):
        calls.append(args[3])
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counting)
    _, _, tm, tp, batch = graded("mtp")
    value_and_grad(lambda p: steps.lm_loss(tm, p, batch), tp)
    assert calls == list(tm.cfg.layer_types)
    calls.clear()
    with torch.no_grad():
        tm.forward(tp, batch)
    assert calls == []


def test_plain_train_step_is_one_adam_step_on_lm_loss(graded):
    """``make_federated_train_step`` without a mesh: one step of the port's
    Adam on ``lm_loss``'s gradient; given a mesh it builds the data-parallel
    and the client-sharded steps (held against the reference in
    ``tests/test_torch_distributed_train.py``)."""
    _, _, tm, tp, batch = graded("debug-dense")
    step, opt = steps.make_federated_train_step(tm, None, AggregationStrategy(kind="enfed"),
                                                lr=3e-4)
    params, state, loss = step(tp, opt.init(tp), batch, None)
    want_loss, grads = _port_value_and_grad(tm, tp, batch)
    upd, want_state = adam(3e-4).update(grads, adam(3e-4).init(tp), tp)
    assert torch.equal(loss, want_loss) and state.step == want_state.step == 1
    for a, p, u in zip(tree_leaves(params), tree_leaves(tp), tree_leaves(upd)):
        assert torch.equal(a, p + u)
    mesh = AbstractMesh(("data", "model"), (4, 2))
    none_step, _ = steps.make_federated_train_step(tm, mesh, AggregationStrategy(kind="none"))
    assert callable(none_step)
    cfl_step, _ = steps.make_federated_train_step(tm, mesh, AggregationStrategy(kind="cfl"))
    assert callable(cfl_step)


def test_stack_for_clients_matches_the_reference():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.float32(2.5) * np.ones((4,), np.float32)}}
    want = np_tree(jsteps.stack_for_clients(jax.tree_util.tree_map(jnp.asarray, tree), 3))
    got = steps.stack_for_clients(from_jax_params(tree, CPU), 3)
    for g, w in zip(tree_leaves(got), tree_leaves(from_jax_params(want, CPU))):
        assert torch.equal(g, w)
    assert steps.MTP_LOSS_WEIGHT == jsteps.MTP_LOSS_WEIGHT


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 8, 64, 2), (513, 4, 32, 0),
                                                   (5000, 3, 16, 7)])
def test_token_batches_equal_the_reference(vocab, batch, seq, seed):
    """Bit for bit, over several batches; a vocab above 4,096 draws from the
    4,096 most frequent ids, as the reference's."""
    np.testing.assert_array_equal(tokens._zipf_probs(vocab), jtokens._zipf_probs(vocab))
    ours = list(tokens.synthetic_token_batches(vocab, batch, seq, 4, seed=seed))
    theirs = list(jtokens.synthetic_token_batches(vocab, batch, seq, 4, seed=seed))
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


@pytest.mark.parametrize("incentive_offer", [0.3, 0.6, 1.0])
def test_participation_mask_equals_the_reference(incentive_offer):
    for C, seed in ((4, 1), (8, 3)):
        ours = incentive.select_contributors(incentive.make_fleet(C, seed=seed, p_has_model=1.0),
                                             incentive_offer, n_max=C)
        theirs = jincentive.select_contributors(
            jincentive.make_fleet(C, seed=seed, p_has_model=1.0), incentive_offer, n_max=C)
        got = incentive.participation_mask(C, ours)
        want = jincentive.participation_mask(C, theirs)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_cross_entropy_loss_matches_the_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((40, 513)) * 3).astype(np.float32)
    labels = rng.integers(0, 513, size=40).astype(np.int32)
    want = float(jclassifiers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6
