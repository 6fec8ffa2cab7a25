"""A whole run of the small cells on the CPU: sound, it is correct and
loads nothing of JAX; with the timed path broken underneath (a step that
leaves its state unchanged, half of each batch left out, a served token
altered where it is produced), ``correct`` comes out false; without a card
the command prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch

from gale_bench import _testing, control, registry, run
from gale_bench.harness import context, run_cell
from repro_torch.launch import steps
from repro_torch.models import lm

ROOT = registry.ROOT
SECONDS = 0.2
REAL_STEP = steps.make_train_step
REAL_PREFILL = lm.prefill_fn


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The small cells' operations are tiny: one thread runs them fastest,
    and stays fast beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _testing.write_tree(tmp_path_factory.mktemp("bench"))


def _run(tree, cell, seed=3):
    return run_cell(cell, seed, SECONDS, False, device="cpu",
                    backend="torch", root=tree)


def test_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(os, "environ", dict(os.environ))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "prefill.deepseek-7b-l4.c32", "--seed",
                     "1", "--seconds", "1"])
    assert code != 0 and capsys.readouterr().out.strip() == ""


def test_sound_run_loads_no_jax(tree):
    """In a process of its own (this one may hold JAX from other tests)."""
    code = (
        "import json, sys; sys.path[:0] = ['src', '.']\n"
        "from gale_bench.harness import run_cell\n"
        "from gale_bench.run import forbidden_modules\n"
        f"r = run_cell('prefill.tiny-dense', 4, {SECONDS}, False, "
        f"device='cpu', backend='torch', root={str(tree)!r})\n"
        "print(json.dumps({'found': forbidden_modules(), 'r': r}))\n")
    env = dict(os.environ, USE_FLAX="0", OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["found"] == []
    r = out["r"]
    assert r["correct"] and list(r)[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "prefill_tokens_per_s" in r["metrics"]


@pytest.mark.parametrize("cell", sorted(_testing.TINY_CELLS))
def test_sound_run_is_correct(tree, cell):
    r = _run(tree, cell)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) >= {"setup_s"}


def _unchanged_state(cfg, opt_cfg, backend=None, **kw):
    def step(params, opt_state, batch):
        loss, _ = steps.loss_and_grads(params, batch, cfg, backend)
        return params, opt_state, {"loss": loss}
    return step


def _half_batch(cfg, opt_cfg, backend=None, **kw):
    real = REAL_STEP(cfg, opt_cfg, backend, **kw)

    def step(params, opt_state, batch):
        half = batch["tokens"].shape[0] // 2
        return real(params, opt_state, {k: v[:half] for k, v in
                                        batch.items()})
    return step


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch])
def test_training_faults_are_caught(tree, monkeypatch, fault):
    monkeypatch.setattr(steps, "make_train_step", fault)
    r = _run(tree, "train.tiny")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["prefill.tiny-dense", "prefill.tiny-moe"])
def test_altered_token_is_caught(tree, monkeypatch, cell):
    def altered(params, batch, cfg, backend=None, rt=None):
        logits, state = REAL_PREFILL(params, batch, cfg, backend, rt)
        last = logits[:, -1]
        wrong = (last.argmax(-1) + 1) % last.shape[-1]
        bump = torch.zeros_like(last).scatter_(
            1, wrong[:, None], float(last.abs().max()) * 4 + 1)
        return (last + bump)[:, None], state
    monkeypatch.setattr(lm, "prefill_fn", altered)
    r = _run(tree, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["prefill.tiny-dense", "prefill.tiny-moe"])
def test_one_altered_row_is_caught(tree, monkeypatch, cell):
    """A fault in one slot of each batch (its first row's logits scaled)
    fails the check, though most rows are sound."""
    def one_row(params, batch, cfg, backend=None, rt=None):
        logits, state = REAL_PREFILL(params, batch, cfg, backend, rt)
        scale = torch.ones_like(logits)
        scale[0] = 1.5
        return logits * scale, state
    monkeypatch.setattr(lm, "prefill_fn", one_row)
    r = _run(tree, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", sorted(_testing.TINY_CELLS))
def test_control_fails(tree, cell):
    """The reference in float8 in the program's place (and, training, the
    reference on half of each batch) fails a limit; the program passes."""
    c = registry.cell(cell, root=tree)
    job = registry.job(c.kind).Job(context(c, 1, "cpu", "torch"))
    job.setup()
    job.window(SECONDS)
    job.drain()
    job.release()
    r = control.readings(job, c.kind, True)
    assert all(v <= c.limits[k] for k, v in r["program"].items()
               if k in c.limits), r
    for who in set(r) - {"program"}:
        assert any(not r[who][k] <= lim for k, lim in c.limits.items()), \
            (who, r)
