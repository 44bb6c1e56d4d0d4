"""The port's training substrate against the JAX package's.

On the CPU in fp32 with TF32 off:

  * ``adamw_update``: two steps on the same numpy tree and gradients as
    JAX's, with the gradient clipped and not, within ``OPT_RTOL`` (the
    same expressions in fp32; ``pow``/``sqrt`` may differ by an ulp);
    ``cosine_lr`` over warmup and decay;
  * ``make_train_batch`` equal to JAX's, whisper's ``enc_emb`` included;
  * ``Trainer``: from JAX's llama3-8b smoke weights bridged over, its
    first update equals JAX's wherever JAX's gradient clears
    ``GRAD_FLOOR`` of its leaf's largest (below it AdamW's first step is
    ``±lr`` by the gradient's sign, which two frameworks need not share),
    and its 5-step loss curve matches JAX's ``Trainer`` within
    ``CURVE_TOL``;
  * checkpoints: one written by either package loads in the other bit
    for bit, with the same keys and dtypes; a run resumed from a
    checkpoint takes the uninterrupted run's next step exactly;
  * ``python -m repro_torch.launch.train``: trains with ``--device cpu``
    and refuses to run without a card by default;
  * the three tests of ``tests/test_training.py`` on the port.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.training import Trainer as JaxTrainer
from repro.training import adamw_update as jax_adamw_update
from repro.training import init_adamw as jax_init_adamw
from repro.training import load_checkpoint as jax_load_checkpoint
from repro.training import save_checkpoint as jax_save_checkpoint
from repro.training.data import make_train_batch as jax_make_train_batch
from repro.training.optimizer import cosine_lr as jax_cosine_lr
from repro_torch.configs import get_config
from repro_torch.models.api import build_model
from repro_torch.models.bridge import params_from_numpy, params_to_numpy
from repro_torch.training import (AdamWConfig, Trainer, adamw_update,
                                  init_adamw, load_checkpoint,
                                  save_checkpoint)
from repro_torch.training.data import make_train_batch
from repro_torch.training.optimizer import cosine_lr
from repro_torch.training.tree import flatten

ROOT = Path(__file__).resolve().parents[1]
OPT_RTOL = 1e-6
GRAD_FLOOR = 1e-2
CURVE_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np(tree):
    return {k: np.asarray(v) for k, v in flatten(tree).items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _model(arch="llama3-8b"):
    cfg = get_config(arch, smoke=True)
    return build_model(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))


# ---------------------------------------------------------------------------
# optimizer and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(grad_scale):
    rng = np.random.default_rng(0)
    params = {"a": {"w": rng.standard_normal((8, 16))},
              "b": rng.standard_normal((16,)),
              "embed": rng.standard_normal((32, 8))}
    params = jax.tree.map(lambda x: x.astype(np.float32), params)
    grads = [jax.tree.map(lambda x: (rng.standard_normal(x.shape)
                                     * grad_scale).astype(np.float32),
                          params) for _ in range(2)]
    cfg = AdamWConfig(lr=0.1, warmup_steps=1, total_steps=4)
    jp, js = jax.tree.map(jnp.asarray, params), jax_init_adamw(params)
    tp, ts = _torch(params), init_adamw(_torch(params))
    for g in grads:
        jp, js, jstats = jax_adamw_update(cfg, jp, jax.tree.map(
            jnp.asarray, g), js)
        tp, ts, tstats = adamw_update(cfg, tp, _torch(g), ts)
        assert (float(jstats["grad_norm"]) > 1.0) == (grad_scale > 1)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=OPT_RTOL)
        assert int(ts["step"]) == int(js["step"])
        for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            got, want = _np(got), _np(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=OPT_RTOL,
                                           atol=1e-7, err_msg=k)


def test_cosine_lr_matches_jax():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=3, total_steps=11)
    steps = np.arange(14, dtype=np.int32)
    np.testing.assert_allclose(
        cosine_lr(cfg, torch.from_numpy(steps)).numpy(),
        np.asarray(jax_cosine_lr(cfg, jnp.asarray(steps))), rtol=OPT_RTOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-base"])
def test_make_train_batch_equals_jax(arch):
    for step in (0, 7):
        got = make_train_batch(get_config(arch, smoke=True), 3, 20, step)
        want = jax_make_train_batch(jax_get_config(arch, smoke=True), 3, 20,
                                    step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the trainer against JAX's
# ---------------------------------------------------------------------------

def test_trainer_matches_jax():
    """The first update where JAX's gradient clears the floor, and the
    5-step loss curve, from JAX's initial weights."""
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    jmodel = jax_build_model(jax_get_config("llama3-8b", smoke=True))
    jtr = JaxTrainer(jmodel, opt, batch_size=4, seq_len=32)
    jp0, jo0 = jtr.init(0)
    tree = jax.tree.map(np.asarray, jp0)
    cfg = get_config("llama3-8b", smoke=True)
    tp0 = params_from_numpy(tree, cfg, device="cpu")
    ttr = Trainer(build_model(cfg, tp0, device="cpu"), opt, batch_size=4,
                  seq_len=32)
    to0 = init_adamw(tp0)

    jgrads = _np(jax.grad(jmodel.loss)(jp0, jax.tree.map(
        jnp.asarray, make_train_batch(cfg, 4, 32, 0))))
    jp1 = _np(jtr.run(jp0, jo0, 1, log=None)[0])
    tp1 = _np(params_to_numpy(ttr.run(tp0, to0, 1, log=None)[0]))
    p0 = _np(tree)
    for k, g in jgrads.items():
        sure = np.abs(g) > GRAD_FLOOR * np.abs(g).max()
        assert sure.any(), k
        np.testing.assert_allclose((tp1[k] - p0[k])[sure],
                                   (jp1[k] - p0[k])[sure], rtol=1e-3,
                                   atol=1e-7, err_msg=k)

    jlosses = jtr.run(jp0, jo0, 5, log=None)[2]
    tlosses = ttr.run(tp0, to0, 5, log=None)[2]
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=CURVE_TOL)
    assert tlosses[-1] < tlosses[0]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoints_load_bit_equal_across_packages(tmp_path):
    cfg = get_config("mamba2-780m", smoke=True)
    jmodel = jax_build_model(jax_get_config("mamba2-780m", smoke=True))
    jtr = JaxTrainer(jmodel, AdamWConfig(), batch_size=2, seq_len=16)
    jp, jo, _ = jtr.run(*jtr.init(0), 1, log=None)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    to = {"step": torch.tensor(int(jo["step"]), dtype=torch.int32),
          "m": _torch(jax.tree.map(np.asarray, jo["m"])),
          "v": _torch(jax.tree.map(np.asarray, jo["v"]))}

    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jax_save_checkpoint(jpath, jp, jo, 1)
    save_checkpoint(tpath, tp, to, 1)
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            assert jz[k].dtype == tz[k].dtype, k
            assert jz[k].tobytes() == tz[k].tobytes(), k

    p, o, step = load_checkpoint(jpath, tp, to)
    assert step == 1 and o["step"].dtype == torch.int32
    for got, want in ((p, jp), (o, jo)):
        got, want = _np(params_to_numpy(got)), _np(want)
        assert set(got) == set(want)
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k
    p, o, step = jax_load_checkpoint(tpath, jp, jo)
    assert step == 1
    for got, want in ((p, tp), (o, to)):
        got, want = _np(got), _np(params_to_numpy(want))
        for k in want:
            assert got[k].tobytes() == want[k].tobytes(), k


def test_resumed_run_takes_the_uninterrupted_step(tmp_path):
    """Save after step 3, load into a fresh trainer, take step 4: the
    loss, parameters and state of the run that never stopped, bit for bit
    (deterministic algorithms on: the embedding's accumulating backward
    on the CPU is not deterministic run to run)."""
    path = str(tmp_path / "ck.npz")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    torch.use_deterministic_algorithms(True)
    try:
        tr = Trainer(_model(), opt, batch_size=2, seq_len=16)
        p, o = tr.init(0)
        p, o, _ = tr.run(p, o, 3, log=None)
        save_checkpoint(path, p, o, 3)
        p, o, want = tr.run(p, o, 1, log=None, start=3)
        fresh = Trainer(_model(), opt, batch_size=2, seq_len=16)
        tp, to = fresh.init(1)
        tp, to, step = load_checkpoint(path, tp, to)
        tp, to, got = fresh.run(tp, to, 1, log=None, start=step)
    finally:
        torch.use_deterministic_algorithms(False)
    assert step == 3 and got == want
    for a, b in ((tp, p), (to, o)):
        fa, fb = flatten(a), flatten(b)
        for k in fb:
            assert torch.equal(fa[k], fb[k]), k


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("PYTHONSTARTUP", None)
    return env


def test_launcher_trains_on_the_cpu_and_needs_a_card_by_default(tmp_path):
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--steps",
            "20"]
    ck = str(tmp_path / "ck.npz")
    run = subprocess.run(argv + ["--device", "cpu", "--ckpt", ck],
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr
    final, start = map(float, re.search(
        r"final loss (\S+) \(start (\S+)\)", run.stdout).groups())
    assert final < start
    with np.load(ck) as z:
        assert int(z["meta/step"]) == 20 and int(z["opt/step"]) == 20
        assert "params/layers/attn/wq" in z.files
    if torch.cuda.is_available():
        return
    run = subprocess.run(argv, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert run.returncode != 0 and "no CUDA device" in run.stderr
    assert "final loss" not in run.stdout


# ---------------------------------------------------------------------------
# tests/test_training.py on the port
# ---------------------------------------------------------------------------

def test_loss_decreases(tmp_path):
    tr = Trainer(_model(), AdamWConfig(lr=1e-3, warmup_steps=5,
                                       total_steps=60),
                 batch_size=8, seq_len=32)
    params, opt = tr.init()
    params, opt, losses = tr.run(params, opt, 30, log=None)
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])

    ck = str(tmp_path / "ckpt.npz")
    save_checkpoint(ck, params, opt, 30)
    p2, o2, step = load_checkpoint(ck, params, opt)
    assert step == 30
    for k, v in flatten(params).items():
        assert torch.equal(v, flatten(p2)[k])


def test_adamw_grad_clip_and_decay():
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}   # huge grad -> clipped
    cfg = AdamWConfig(lr=0.1, grad_clip=1.0, weight_decay=0.0,
                      warmup_steps=0, total_steps=10)
    state = init_adamw(params)
    new_p, new_s, stats = adamw_update(cfg, params, grads, state)
    assert float(stats["grad_norm"]) > 1.0
    delta = (new_p["w"] - params["w"]).abs()
    assert delta.max() < 0.2  # clip bounded the step
    assert int(new_s["step"]) == 1


def test_enc_dec_training_step():
    tr = Trainer(_model("whisper-base"),
                 AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                 batch_size=4, seq_len=16)
    params, opt = tr.init()
    params, opt, losses = tr.run(params, opt, 6, log=None)
    assert np.isfinite(losses).all()
