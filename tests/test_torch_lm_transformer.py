"""The LM zoo's ``Transformer`` and its serving path in the port against the
reference, on the reference's own params converted (fp32, B = 2, S = 12):
``forward`` logits and ``aux_loss`` for every mixer variant of
``tests/test_models.py`` and the registered presets, each special head once
(encoder-decoder, vision prefix, multi-token prediction, tied embeddings,
logit softcap); the port's decode against its forward; the serving driver
and its example.

Tolerances: forward logits 2e-5 absolute (largest measured on this CPU:
1.0e-5, the xLSTM variant; 3.7e-6 the others); decode against forward
2e-3, the reference's own rule (measured: 4.0e-5)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.transformer import Transformer as JTransformer  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.utils.tree import from_jax_params  # noqa: E402

from _torch_ref import np_tree, threefry, torch_model_config  # noqa: E402
from test_models import BASE, VARIANTS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
B, S = 2, 12
FWD_TOL = dict(atol=2e-5, rtol=0)
DECODE_ATOL = 2e-3

SPECIAL = {
    "encoder": BASE.replace(family="audio", encoder_layers=2, frontend="audio"),
    "vision": BASE.replace(family="vlm", frontend="vision", num_prefix_tokens=3),
    "mtp": BASE.replace(mtp_depth=1),
    "tied": BASE.replace(tie_embeddings=True),
    "softcap": BASE.replace(logit_softcap=5.0),
}
CONFIGS = dict(VARIANTS, **SPECIAL, **{n: jconfigs.ARCHS[n] for n in jconfigs.ARCHS})


def _inputs(cfg):
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0, cfg.vocab_size))
    batch = {"tokens": toks}
    if cfg.is_encoder_decoder:
        batch["frames"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (B, 5, 64)))
    if cfg.num_prefix_tokens:
        batch["prefix_embeds"] = np.asarray(
            jax.random.normal(jax.random.PRNGKey(3), (B, cfg.num_prefix_tokens, 64)))
    return batch


def _port_batch(batch):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in batch.items()}


class _Routes:
    """The MoE routes a forward took: (gates, top-k ids) per MoE layer, in
    layer order."""

    def __init__(self):
        self.seen = []


@pytest.fixture(scope="module")
def built():
    """Per config: the reference's params and forward (run once), the
    port's model and converted params, and the reference's MoE routes."""
    cache = {}
    jtopk = jmoe._topk

    def get(name):
        if name in cache:
            return cache[name]
        cfg = CONFIGS[name]
        routes = _Routes()

        def recording_topk(gates, k):
            top_v, top_i = jtopk(gates, k)
            jax.debug.callback(lambda g, i: routes.seen.append((np.asarray(g), np.asarray(i))),
                               gates, top_i, ordered=True)
            return top_v, top_i

        jm = JTransformer(cfg)
        jp = jm.init(jax.random.PRNGKey(0))
        batch = _inputs(cfg)
        jmoe._topk = recording_topk
        try:
            jout = jax.jit(jm.forward)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
            jax.effects_barrier()
        finally:
            jmoe._topk = jtopk
        tm = Transformer(torch_model_config(cfg), device=CPU)
        tp = from_jax_params(np_tree(jp), CPU)
        cache[name] = (cfg, jm, jp, batch, jax.tree_util.tree_map(np.array, jout), tm, tp,
                       routes.seen)
        return cache[name]

    return get


def _port_forward(tm, tp, batch, monkeypatch=None):
    with torch.no_grad():
        return tm.forward(tp, _port_batch(batch))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_the_reference(built, name, monkeypatch):
    """Logits and ``aux_loss`` (and the MTP head's logits); under MoE the
    port routes every token of every layer to the reference's experts, with
    the k-th gate above the (k+1)-th by more than 1e-5 at this seed."""
    cfg, _, _, batch, jout, tm, tp, jroutes = built(name)
    seen = []
    if cfg.moe is not None:
        ttopk = moe._topk

        def recording_topk(gates, k):
            out = ttopk(gates, k)
            seen.append((gates.clone(), out[1].clone()))
            return out

        monkeypatch.setattr(moe, "_topk", recording_topk)
    tout = _port_forward(tm, tp, batch)
    torch.testing.assert_close(tout["logits"], torch.from_numpy(jout["logits"]), **FWD_TOL)
    assert abs(float(tout["aux_loss"]) - float(jout["aux_loss"])) <= 1e-6
    assert ("mtp_logits" in tout) == ("mtp_logits" in jout)
    if "mtp_logits" in tout:
        torch.testing.assert_close(tout["mtp_logits"], torch.from_numpy(jout["mtp_logits"]),
                                   **FWD_TOL)
    assert len(seen) == len(jroutes) == (cfg.num_layers if cfg.moe is not None else 0)
    for (tg, ti), (_, ji) in zip(seen, jroutes):
        np.testing.assert_array_equal(ti.numpy(), ji)
        top = torch.sort(tg, dim=-1, descending=True).values
        k = cfg.moe.num_experts_per_tok
        assert float((top[:, k - 1] - top[:, k]).min()) > 1e-5
    if cfg.moe is not None:
        assert float(tout["aux_loss"]) > 0


def test_presets_and_registry_equal_the_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for name in jconfigs.ARCHS:
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert dataclasses.asdict(t.smoke()) == dataclasses.asdict(j.smoke())
        assert t.layer_types == j.layer_types
        assert t.torch_dtype is torch.float32
        for shape in jconfigs.INPUT_SHAPES:
            assert tconfigs.shape_supported(t, shape) == jconfigs.shape_supported(j, shape)
    assert tconfigs.INPUT_SHAPES == jconfigs.INPUT_SHAPES
    for ours, theirs in ((tconfigs.PAPER_LSTM, jconfigs.PAPER_LSTM),
                         (tconfigs.PAPER_MLP, jconfigs.PAPER_MLP)):
        # the reference's LSTM config also names its cell (ref | pallas); the
        # port's cell is the kernel pair, chosen by the tensor's device
        mine = dataclasses.asdict(ours)
        assert mine == {k: v for k, v in dataclasses.asdict(theirs).items() if k in mine}
    for name, cfg in VARIANTS.items():
        assert (torch_model_config(cfg).supports_long_decode == cfg.supports_long_decode)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("nope")


def _port_decode(tm, tp, toks, absorbed=False):
    cache = tm.init_cache(B, S)
    step = make_serve_step(tm, mla_absorbed=absorbed)
    out = []
    with torch.no_grad():
        for t in range(S):
            lg, cache = step(tp, cache, toks[:, t:t + 1], t)
            out.append(lg[:, 0])
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("name", sorted(VARIANTS) + ["tied", "softcap", "debug-dense"])
def test_port_decode_matches_port_forward(built, name):
    """The cache path (ring buffers, latent caches, recurrent states)
    against the full-sequence forward, every non-MoE variant."""
    cfg, _, _, batch, _, tm, tp, _ = built(name)
    toks = torch.from_numpy(np.array(batch["tokens"], copy=True))
    full = _port_forward(tm, tp, batch)["logits"]
    torch.testing.assert_close(_port_decode(tm, tp, toks), full, atol=DECODE_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["dense", "xlstm", "debug-moe"])
def test_port_decode_matches_the_reference_decode(built, name, monkeypatch):
    """The reference's own decode, for the variants tier-1 holds it on and
    for the MoE preset, whose decode (capacity over the B tokens of a step)
    is not its forward: there the port routes every step's tokens to the
    reference's experts, the k-th gate above the (k+1)-th by more than 1e-5
    (measured on this CPU: 3.4e-6, the smallest margin 3.2e-3)."""
    cfg, jm, jp, batch, _, tm, tp, _ = built(name)
    jseen, tseen = [], []
    jtopk, ttopk = jmoe._topk, moe._topk

    def jrecording(gates, k):
        top_v, top_i = jtopk(gates, k)
        jax.debug.callback(lambda i: jseen.append(np.asarray(i)), top_i, ordered=True)
        return top_v, top_i

    def trecording(gates, k):
        out = ttopk(gates, k)
        tseen.append((gates.clone(), out[1].clone()))
        return out

    monkeypatch.setattr(jmoe, "_topk", jrecording)
    monkeypatch.setattr(moe, "_topk", trecording)
    jstep = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, S)
    jdec = []
    for t in range(S):
        lg, cache = jstep(jp, jnp.asarray(batch["tokens"][:, t:t + 1]), cache, t)
        jdec.append(np.asarray(lg[:, 0]))
    jax.effects_barrier()
    tdec = _port_decode(tm, tp, torch.from_numpy(np.array(batch["tokens"], copy=True)))
    torch.testing.assert_close(tdec, torch.from_numpy(np.stack(jdec, 1)), atol=5e-5, rtol=0)
    assert len(tseen) == len(jseen) == (S * cfg.num_layers if cfg.moe is not None else 0)
    for (tg, ti), ji in zip(tseen, jseen):
        np.testing.assert_array_equal(ti.numpy(), ji)
        top = torch.sort(tg, dim=-1, descending=True).values
        k = cfg.moe.num_experts_per_tok
        assert float((top[:, k - 1] - top[:, k]).min()) > 1e-5


def test_absorbed_mla_decode_matches_plain_mla_decode(built):
    _, _, _, batch, _, tm, tp, _ = built("mla")
    toks = torch.from_numpy(np.array(batch["tokens"], copy=True))
    torch.testing.assert_close(_port_decode(tm, tp, toks, absorbed=True),
                               _port_decode(tm, tp, toks), atol=1e-4, rtol=0)


def test_encoder_memory_reaches_the_decoder(built):
    """Decode against the encoder's memory equals the forward's positions."""
    cfg, _, _, batch, _, tm, tp, _ = built("encoder")
    tb = _port_batch(batch)
    with torch.no_grad():
        full = tm.forward(tp, tb)["logits"]
        memory = tm.encode(tp, tb["frames"])
        cache, out = tm.init_cache(B, S), []
        for t in range(S):
            lg, cache = tm.decode_step(tp, tb["tokens"][:, t:t + 1], cache, t, memory=memory)
            out.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(out, 1), full, atol=DECODE_ATOL, rtol=0)


def test_prefill_step_is_the_forward_last_position(built):
    _, _, _, batch, jout, tm, tp, _ = built("debug-moe")
    with torch.no_grad():
        last = make_prefill_step(tm)(tp, _port_batch(batch))
    assert last.shape == (B, 1, jout["logits"].shape[-1])
    torch.testing.assert_close(last, torch.from_numpy(jout["logits"][:, -1:]), **FWD_TOL)


@pytest.mark.parametrize("partitionable", [False, True])
def test_serve_prompts_are_the_reference_draw(partitionable):
    """``fold_in(PRNGKey(seed), 1)`` then ``randint``: the reference serving
    driver's prompts, bit for bit, under both threefry modes."""
    for seed, vocab in ((0, 512), (3, 513)):
        with threefry(partitionable):
            ref = jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(seed), 1),
                                     (4, 32), 0, vocab)
        got = serve.draw_prompts(seed, 4, 32, vocab, partitionable=partitionable, device=CPU)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("arch", ["debug-dense", "debug-moe"])
def test_serve_main_runs_on_the_cpu_when_asked(arch, capsys):
    assert serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "6", "--gen", "4",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"[serve] {jconfigs.get_config(arch).name}" in out and "tok/s" in out


def test_serve_batched_example_runs_on_the_cpu_when_asked():
    # one thread: the process runs beside the test workers' own
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_serve_batched.py"),
                          "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "[serve] debug-moe: batch=2 prompt=16 gen=12" in out.stdout
