"""The LM zoo's federated training in the port against the reference:
``FederatedTrainer`` rounds for every strategy on the two registered presets
from the reference's params converted, the stacked state and its
checkpoints across the packages, the train driver (the twin of
``tests/test_system.py::test_train_driver_end_to_end``) and its example.

The rounds run C = 4 clients, 2 local Adam steps at lr 3e-4, 2 rows of 32
tokens a client a step.  One reference round (strategy ``none``, jitted
once a preset) gives every client's params; each strategy's round is then
the reference's ``mixing_matrix_jnp`` and ``apply_mixing`` on them, against
a whole port round of that strategy.  Tolerances: losses within 5e-6; the
params to a two-part rule, because Adam's first steps turn a ~1e-6 gradient
gap on a near-zero gradient into up to ``lr`` a step: every element within
``2 * lr * local_steps``, and at most 1e-4 of the elements beyond 1e-5
(measured on this CPU: at most 6 of 1,708,544 elements, ``debug-dense``, and
16 of 2,498,048, ``debug-moe``; the largest gap 1.2e-4, ``debug-moe``'s
round of strategy ``none``).  Mixing matrices are equal."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
from repro.core import incentive as jincentive  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.core.battery import BatteryState as JBatteryState  # noqa: E402
from repro.core.energy import CostModel as JCostModel  # noqa: E402
from repro.core.federated import FederatedTrainer as JFederatedTrainer  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
import repro_torch.checkpoint as tckpt  # noqa: E402
from repro_torch.core import FederatedTrainer  # noqa: E402
from repro_torch.core import federated  # noqa: E402
from repro_torch.core.topology import AggregationStrategy, mixing_matrix_torch  # noqa: E402
from repro_torch.data.tokens import synthetic_token_batches  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import Transformer  # noqa: E402
from repro_torch.optim import AdamState  # noqa: E402
from repro_torch.utils.tree import from_jax_params, tree_leaves, tree_map  # noqa: E402

from _torch_ref import np_tree, torch_model_config  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
C, LOCAL, ROWS, SEQ, LR = 4, 2, 2, 32, 3e-4
LOSS_ATOL = 5e-6
PARAM_ATOL = 2 * LR * LOCAL
FAR, FAR_SHARE = 1e-5, 1e-4
ENFED_MASK = np.array([1.0, 1.0, 0.0, 1.0], np.float32)   # client 2 left out
STRATEGIES = {
    "cfl": (AggregationStrategy(kind="cfl"), None),
    "enfed": (AggregationStrategy(kind="enfed", neighborhood_size=2), ENFED_MASK),
    "dfl_ring": (AggregationStrategy(kind="dfl_ring"), None),
    "dfl_mesh": (AggregationStrategy(kind="dfl_mesh"), None),
    "none": (AggregationStrategy(kind="none"), None),
}
PRESETS = ("debug-dense", "debug-moe")


def _jstrategy(s):
    return jtopology.AggregationStrategy(kind=s.kind, neighborhood_size=s.neighborhood_size)



@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's small ops on one thread: beside the suite's other
    workers, torch's intra-op threads oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rounds():
    """Per preset: the reference's stacked init and its round of strategy
    ``none`` (jitted once), and the port's model, batches and stacked init
    from the same params."""
    cache = {}

    def get(name):
        if name in cache:
            return cache[name]
        cfg = jconfigs.get_config(name)
        jm = JTransformer(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        flat = next(synthetic_token_batches(cfg.vocab_size, C * LOCAL * ROWS, SEQ, 1, seed=5))
        batches = {k: v.reshape(C, LOCAL, ROWS, SEQ) for k, v in flat.items()}
        jtrainer = JFederatedTrainer(lambda p, b: jsteps.lm_loss(jm, p, b), C,
                                     jtopology.AggregationStrategy(kind="none"), lr=LR,
                                     local_steps=LOCAL)
        jstacked, jopt = jtrainer.init(jp)
        jnew, jnew_opt, jlosses = jax.jit(jtrainer.round)(
            jstacked, jopt, {k: jnp.asarray(v) for k, v in batches.items()}, None)
        tm = Transformer(torch_model_config(cfg), device=CPU)
        tbatches = {k: torch.from_numpy(v).long() for k, v in batches.items()}
        cache[name] = dict(
            jstate=(np_tree(jstacked), jopt), jnew=jnew, jnew_opt=jnew_opt,
            jlosses=np.asarray(jlosses), tm=tm, tp=from_jax_params(np_tree(jp), CPU),
            batches=tbatches)
        return cache[name]

    return get


def _port_trainer(tm, strategy):
    return FederatedTrainer(lambda p, b: steps.lm_loss(tm, p, b), C, strategy, lr=LR,
                            local_steps=LOCAL)


def _assert_params_close(got, want, what):
    total, far = 0, 0
    for g, w in zip(tree_leaves(got), tree_leaves(from_jax_params(np_tree(want), CPU))):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        gap = (g - w).abs()
        assert float(gap.max()) <= PARAM_ATOL, f"{what}: {float(gap.max())}"
        total += gap.numel()
        far += int((gap > FAR).sum())
    assert far <= FAR_SHARE * total, f"{what}: {far} of {total} elements beyond {FAR}"


@pytest.mark.parametrize("strategy", list(STRATEGIES))
@pytest.mark.parametrize("name", PRESETS)
def test_round_matches_the_reference(rounds, name, strategy):
    """Losses, the Adam step count, the mixing matrix, and the mixed params
    of one round."""
    r = rounds(name)
    s, mask = STRATEGIES[strategy]
    trainer = _port_trainer(r["tm"], s)
    stacked, opt = trainer.init(r["tp"])
    mixed, new_opt, losses = trainer.round(stacked, opt, r["batches"], mask)
    assert losses.shape == (C,) and losses.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), r["jlosses"], atol=LOSS_ATOL, rtol=0)
    assert new_opt.step.dtype == torch.int32
    np.testing.assert_array_equal(new_opt.step.numpy(), np.asarray(r["jnew_opt"].step))
    jM = np.asarray(jtopology.mixing_matrix_jnp(C, _jstrategy(s), mask))
    np.testing.assert_array_equal(mixing_matrix_torch(C, s, mask).numpy(), jM)
    want = jtopology.apply_mixing(r["jnew"], jnp.asarray(jM))
    _assert_params_close(mixed, want, f"{name} {strategy}")


def test_mask_keeps_a_left_out_client_unmixed(rounds):
    """Under enfed the left-out client keeps its own params, which a round
    of strategy ``none`` gives bit for bit."""
    r = rounds("debug-dense")
    outs = {}
    for kind in ("enfed", "none"):
        s, mask = STRATEGIES[kind]
        trainer = _port_trainer(r["tm"], s)
        outs[kind] = trainer.round(*trainer.init(r["tp"]), r["batches"], mask)[0]
    for a, b in zip(tree_leaves(outs["enfed"]), tree_leaves(outs["none"])):
        assert torch.equal(a[2], b[2])
        assert not torch.equal(a[0], b[0])


def _saved_leaves(path):
    with np.load(path) as data:
        return {k: (data[k].shape, data[k].dtype) for k in data.files}


def test_stacked_state_has_the_reference_layout(rounds, tmp_path):
    """Paths, shapes and dtypes of every saved leaf of ``(params,
    AdamState)`` equal the reference's; the Adam step is (C,) int32."""
    r = rounds("debug-moe")
    stacked, opt = _port_trainer(r["tm"], STRATEGIES["none"][0]).init(r["tp"])
    assert isinstance(opt, AdamState)
    assert opt.step.shape == (C,) and opt.step.dtype == torch.int32
    ours = tckpt.save_checkpoint(str(tmp_path / "port"), 0, (stacked, opt))
    theirs = jckpt.save_checkpoint(str(tmp_path / "ref"), 0, r["jstate"])
    assert _saved_leaves(ours) == _saved_leaves(theirs)
    assert "1/.step" in _saved_leaves(ours)


def test_checkpoints_restore_across_the_packages(rounds, tmp_path):
    """The reference's stacked state after a round restores into the port's
    template, and the port's into the reference's, every leaf equal."""
    r = rounds("debug-dense")
    jstate = (r["jnew"], r["jnew_opt"])
    trainer = _port_trainer(r["tm"], STRATEGIES["none"][0])
    template = trainer.init(r["tp"])
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, jstate)
    restored, step = tckpt.restore_checkpoint(str(tmp_path / "ref"), template)
    assert step == 3
    got = tckpt.checkpointer._flatten_with_paths(restored)
    want = tckpt.checkpointer._flatten_with_paths(np_tree(jstate))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    port_state = trainer.round(*template, r["batches"], None)[:2]
    tckpt.save_checkpoint(str(tmp_path / "port"), 5, port_state)
    back, step = jckpt.restore_checkpoint(str(tmp_path / "port"), jstate)
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    tckpt.checkpointer._flatten_with_paths(port_state).values()):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------------------------------
# the train driver
# ---------------------------------------------------------------------------

DRIVER = ["--arch", "debug-dense", "--preset", "smoke", "--steps", "8", "--clients", "2",
          "--batch", "4", "--seq", "32", "--strategy", "enfed", "--ckpt-every", "4",
          "--log-every", "1"]


def _reference_driver_losses(capsys):
    assert jtrain.main(DRIVER) == 0
    out = capsys.readouterr().out
    return [float(x) for x in re.findall(r"\[train\] step\s+\d+ loss\s+([-\d.]+)", out)]


def _reference_world(n_params, model_bytes):
    """The masks, batches and battery levels of the reference's own numpy
    functions at the driver's arguments."""
    fleet = jincentive.make_fleet(2, seed=1, p_has_model=1.0)
    cost, battery = JCostModel(), JBatteryState()
    masks, levels = [], []
    for _ in range(8):
        mask = jincentive.participation_mask(2, jincentive.select_contributors(fleet, 0.6,
                                                                               n_max=2))
        rep = cost.session(rounds=1, n_contrib=int(mask.sum()), num_params=n_params,
                           model_bytes=model_bytes, num_samples=2 * 32, epochs=1)
        battery = battery.discharge(rep.e_tot, cost.device.p_train)
        masks.append(mask)
        levels.append(battery.level)
    return masks, list(jtokens.synthetic_token_batches(512, 4, 32, 8, seed=2)), levels


def test_train_driver_end_to_end(tmp_path, capsys, monkeypatch):
    """The twin of the reference's driver test on the CPU, from the
    reference's seed-0 weights converted: the loss improves (rc 0), each
    step's loss within 1e-4 of the reference driver's printed 4 digits, the
    masks, token batches and battery levels those of the reference's numpy
    functions, a checkpoint every 4 steps; a second call restores the last
    one bit for bit and continues from its step."""
    want_losses = _reference_driver_losses(capsys)
    cfg = jconfigs.get_config("debug-dense").smoke().replace(dtype="float32")
    params_one = from_jax_params(np_tree(JTransformer(cfg).init(jax.random.PRNGKey(0))), CPU)
    seen = []
    real_round = federated.FederatedTrainer.round

    def recording(self, stacked, opt, batches, mask=None):
        seen.append({k: v.numpy().copy() for k, v in batches.items()})
        return real_round(self, stacked, opt, batches, mask)

    monkeypatch.setattr(federated.FederatedTrainer, "round", recording)
    ckpt = str(tmp_path / "ckpt")
    argv = DRIVER + ["--ckpt-dir", ckpt, "--device", "cpu"]
    run = train.train(argv, params_one=params_one)
    assert run.start == 0 and len(run.losses) == 8
    assert run.losses[-1] < run.losses[0]                    # main's exit code 0
    np.testing.assert_allclose(run.losses, want_losses, atol=1e-4, rtol=0)
    masks, batches, levels = _reference_world(
        sum(int(x.numel()) for x in tree_leaves(params_one)),
        sum(int(x.numel()) * 4 for x in tree_leaves(params_one)))
    for got, want in zip(run.masks, masks):
        np.testing.assert_array_equal(got, want)
    assert run.battery == levels
    for got, want in zip(seen, batches):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k].reshape(2, 1, 2, 32))
    assert tckpt.latest_step(ckpt) == 8
    assert sorted(os.listdir(ckpt)) == ["step_00000004.npz", "step_00000008.npz"]

    saved, _ = tckpt.restore_checkpoint(ckpt, (run.params, run.opt_state))
    for a, b in zip(tckpt.checkpointer._flatten_with_paths((run.params, run.opt_state)).values(),
                    tckpt.checkpointer._flatten_with_paths(saved).values()):
        np.testing.assert_array_equal(a, b)
    seen.clear()
    again = train.train(argv)
    assert again.start == 8 and tckpt.latest_step(ckpt) == 16
    # the resumed run's first round starts from the restored state on the
    # stream's first batch, as the reference's resume does
    np.testing.assert_array_equal(seen[0]["tokens"], batches[0]["tokens"].reshape(2, 1, 2, 32))
    tm = Transformer(torch_model_config(cfg), device=CPU)
    first = seen[0]
    with torch.no_grad():
        want0 = torch.stack([
            steps.lm_loss(tm, tree_map(lambda x: x[c], run.params),
                          {k: torch.from_numpy(v[c, 0]).long() for k, v in first.items()})
            for c in range(2)]).mean()
    assert abs(again.losses[0] - float(want0)) <= 1e-6


def test_driver_without_device_raises_on_a_host_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train(["--steps", "1"])


def test_the_example_runs_as_a_process():
    """``examples/torch_federated_lm.py`` with its defaults (30 steps of
    the smoke preset, 4 clients, enfed) on the CPU: the loss improves."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_federated_lm.py"),
                          "--device", "cpu"], capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "(improved)" in out.stdout and "training tokens/s" in out.stdout
