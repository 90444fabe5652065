"""A whole run at tiny sizes on the host, with the timed path broken
underneath, must come out not correct: once for each fault the cells
can have.  (No cell spans chips, so none can leave an exchange out.)"""
from __future__ import annotations

import time

import pytest
import torch

from chipbench import harness

from .conftest import tiny_spec


def _run(cell: str) -> dict:
    return harness.run_spec(tiny_spec(cell), 11, 0.3, False,
                            torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", ["chain-route", "zamba2-prefill",
                                  "zamba2-decode"])
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_chain_answer_altered_where_produced(monkeypatch):
    from repro_torch.kernels import ref
    scan = ref.ssd_scan_ref

    def altered(*args, **kw):
        y, S = scan(*args, **kw)
        y = y.clone()
        y.view(-1)[7] += 0.01 * float(y.abs().max())
        return y, S
    monkeypatch.setattr(ref, "ssd_scan_ref", altered)
    assert not _run("chain-route")["correct"]


def _patch_model(monkeypatch, fault: str):
    from repro_torch.models import model as M
    prefill, step = M.prefill, M.decode_step

    def token_altered(*args, **kw):
        logits, cache = step(*args, **kw)
        top = logits.argmax(-1, keepdim=True)
        return logits.scatter(-1, top, float(logits.min()) - 1.0), cache

    def state_unchanged(cfg, params, cache, batch, *args, **kw):
        kw.pop("donate", None)
        logits, _ = step(cfg, params, cache, batch, *args, **kw)
        return logits, cache

    def half_batch(cfg, params, batch, *args, **kw):
        B = batch["tokens"].shape[0]
        half = {"tokens": batch["tokens"][:B // 2 + B % 2]}
        logits, cache = prefill(cfg, params, half, *args, **kw)
        full, cache_full = prefill(cfg, params, batch, *args, **kw)
        full[B // 2 + B % 2:] = logits[:B // 2]
        return full, cache_full

    if fault == "prefill":
        monkeypatch.setattr(M, "prefill", half_batch)
    else:
        monkeypatch.setattr(M, "decode_step", {
            "token": token_altered, "state": state_unchanged}[fault])


@pytest.mark.parametrize("cell", ["zamba2-prefill", "zamba2-decode"])
@pytest.mark.parametrize("fault", ["token", "state", "prefill"])
def test_generate_faults(monkeypatch, cell, fault):
    _patch_model(monkeypatch, fault)
    assert not _run(cell)["correct"]
