"""Whole runs on the CPU at a tiny size, past the harness's look for a
card: a sound run comes out correct, and each fault a cell can have,
planted underneath the timed path, makes ``correct`` false. (Every cell
takes one card, so no cell has an exchange between cards to leave out.)"""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import tiny_config, tiny_traffic
from vidsum_tpu_torch.serve import dispatch
from vidsum_tpu_torch.train import steps

TRAIN_CELLS = ["pretrain-b256", "finetune-long"]


def _run(cell, seed=11):
    spec = harness.load_spec()
    entry = harness.find_cell(spec, cell)
    names = [m["name"] for m in harness.cell_metrics(spec, cell, False)]
    return harness.run_cell(tiny_config(entry["config"]), tiny_traffic(cell),
                            names, seed, 0.5, False, "cpu", 0.0)


def _broken_steps(monkeypatch, wrap):
    for name in ("make_pretrain_step", "make_finetune_step"):
        real = getattr(steps, name)

        def make(*a, _real=real, **kw):
            return wrap(_real(*a, **kw))

        monkeypatch.setattr(steps, name, make)


@pytest.mark.parametrize("cell", TRAIN_CELLS + ["serve-long"])
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_state_left_unchanged_fails(cell, monkeypatch):
    def wrap(step):
        def unchanged(model, optimizer, *a, **kw):
            before = [p.detach().clone() for p in model.parameters()]
            out = step(model, optimizer, *a, **kw)
            with torch.no_grad():
                for p, b in zip(model.parameters(), before):
                    p.copy_(b)
            return out
        return unchanged

    _broken_steps(monkeypatch, wrap)
    res = _run(cell)
    assert not res["correct"]
    upd = res["checks"]["update_median"]
    assert upd["value"] > upd["limit"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_the_batch_left_out_fails(cell, monkeypatch):
    def wrap(step):
        def half(model, optimizer, x, y, mask, generator, **kw):
            k = x.shape[0] // 2
            return step(model, optimizer, x[:k], y[:k], mask[:k], generator,
                        **kw)
        return half

    _broken_steps(monkeypatch, wrap)
    assert not _run(cell)["correct"]


def test_altered_answer_fails(monkeypatch):
    real = dispatch.finish_request

    def altered(svc, r, scores):
        scores = scores.copy()
        scores[len(scores) // 2] += 1e-3
        return real(svc, r, scores)

    monkeypatch.setattr(dispatch, "finish_request", altered)
    res = _run("serve-long")
    assert not res["correct"]
    assert res["checks"]["scores"]["value"] > res["checks"]["scores"]["limit"]


def test_altered_summary_fails(monkeypatch):
    real = dispatch.generate_summary

    def altered(*a, **kw):
        out = real(*a, **kw)
        out[0] = out[0].copy()
        out[0][0] ^= 1
        return out

    monkeypatch.setattr(dispatch, "generate_summary", altered)
    res = _run("serve-long")
    assert not res["correct"]
    assert res["checks"]["summaries"]["value"] > 0
