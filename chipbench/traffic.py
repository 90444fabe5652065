"""The one traffic generator and its closed loops.

A cell's traffic is a data file (``workloads/<cell>.json``, key
``traffic``) of parameters that this module reads; its ``kind`` picks
the loop:

* ``closed_route``: one client sends requests back to back, each the
  next of ``inputs`` inputs that the configuration draws from the seed,
  cycled.  A request is staged, executed and waited for.
* ``closed_generate``: one client sends batches back to back, each of
  ``batch`` prompts of ``prompt_len`` token ids drawn from the seed,
  greedy for ``new_tokens`` tokens: the prefill gives the first token
  (its time to the host is each prompt's time to first token), each
  further token is one decode step fed the argmax of the last.

A loop runs units (requests, batches) while the window is open and
waits for the last one it started, so every unit it started counts and
the window is the time until it ended.  It keeps a sample of the units
for the check, drawn from the seed by reservoir sampling over every
unit it ran.  In a traced run the loop runs instead the fixed piece of
traffic that ``trace`` names and keeps its sample from that: routes, all
traced; whole batches of which the traced windows hold each prefill to
its first token on the host (``prefills``); or one batch of which the
window holds the decode steps ``decode_steps`` [first, end).
"""
from __future__ import annotations

import time

import numpy as np

from .trace import Tracer

# routes run under the profiler before a traced window opens
PROFILER_WARM = 2


class Reservoir:
    """A uniform sample of ``k`` of the units offered, drawn from ``rng``;
    whether a unit is kept is known before it runs."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.slots: list = []
        self.seen = 0

    def offer(self) -> int | None:
        """The slot the next unit goes to, or None."""
        n = self.seen
        self.seen += 1
        if n < self.k:
            self.slots.append(None)
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k else None

    def put(self, slot: int | None, item) -> None:
        if slot is not None:
            self.slots[slot] = item

    def items(self) -> list:
        return [s for s in self.slots if s is not None]


def _add(total: dict, work: dict) -> None:
    for k, v in work.items():
        total[k] = total.get(k, 0) + v


def run(system, traffic: dict, seconds: float, trace: bool,
        rng: np.random.Generator, seed: int) -> dict:
    """The loop of ``traffic["kind"]`` over ``system``; its record.
    ``rng`` draws the sample the check keeps, ``seed`` the prompts."""
    loops = {"closed_route": closed_route, "closed_generate": closed_generate}
    if traffic["kind"] not in loops:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}; "
                         f"known: {sorted(loops)}")
    return loops[traffic["kind"]](system, traffic, seconds, trace, rng, seed)


def closed_route(system, traffic: dict, seconds: float, trace: bool,
                 rng: np.random.Generator, seed: int) -> dict:
    """Requests back to back through ``system.request(j)``, which stages
    input ``j`` (drawn by the system from its seed), runs it and waits;
    returns the loop's record."""
    n_inputs = traffic["inputs"]
    keep = Reservoir(traffic["check_requests"], rng)
    rec = {"units": 0, "requests": 0}
    tracer = Tracer(trace)
    if trace:
        from repro_torch import kernels
        last = {}
        with tracer:
            # the profiler's start-up falls outside the window
            for n in range(PROFILER_WARM):
                system.request(n % n_inputs)
            kernels.reset_launch_counts()
            with tracer.window():
                t0 = time.perf_counter()
                for n in range(traffic["trace"]["requests"]):
                    slot = keep.offer()
                    outs = system.request(n % n_inputs)
                    keep.put(slot, (n % n_inputs, outs))
                    last[n % n_inputs] = outs
                rec["seconds"] = time.perf_counter() - t0
            launches = kernels.launch_counts()
        work: dict = {}
        for n in range(traffic["trace"]["requests"]):
            _add(work, system.work(last[n % n_inputs]))
        rec["trace"] = {**tracer.summary, "launches": launches, "work": work,
                        "units": traffic["trace"]["requests"]}
        rec["units"] = rec["requests"] = traffic["trace"]["requests"]
    else:
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            slot = keep.offer()
            outs = system.request(n % n_inputs)
            keep.put(slot, (n % n_inputs, outs))
            n += 1
        rec["seconds"] = time.perf_counter() - t0
        rec["units"] = rec["requests"] = n
    rec["kept"] = keep.items()
    return rec


def prompt_stream(traffic: dict, vocab: int, seed: int, device):
    """A function giving the next batch of prompts: ``batch`` x
    ``prompt_len`` ids uniform over the vocabulary, drawn on the device
    from the seed."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    shape = (traffic["batch"], traffic["prompt_len"])

    def nxt():
        return torch.randint(0, vocab, shape, generator=gen, device=device,
                             dtype=torch.int32)
    return nxt


def _generate_batch(system, tokens, new_tokens: int, rows, rec: dict,
                    traced=None):
    """One batch: the prefill, the first token to the host, then
    ``new_tokens - 1`` decode steps and the tokens to the host.  Adds to
    ``rec``'s times; returns (served (B, new_tokens) on the host, the
    program's logits of the prompts ``rows`` (len(rows), new_tokens, V)
    or None).  ``traced`` is (first, end, start, stop): the batch's
    phases [first, end), phase 0 the prefill to its first token on the
    host and phase s + 1 decode step s, run between ``start()`` and
    ``stop()``."""
    import torch

    def begin(phase):
        if traced is not None and phase == traced[0]:
            traced[2]()

    def end(phase):
        if traced is not None and phase == traced[1] - 1:
            traced[3]()

    B, T = tokens.shape
    begin(0)
    t0 = time.perf_counter()
    logits, cache = system.prefill(tokens, T + new_tokens)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    tok.cpu()
    t1 = time.perf_counter()
    end(0)
    rec["ttft_s"].extend([t1 - t0] * B)
    rec["prefill_s"].append(t1 - t0)
    served, kept = [tok], []
    if rows is not None:
        kept.append(logits[rows, -1].clone())
    for s in range(new_tokens - 1):
        begin(s + 1)
        logits, cache = system.step(cache, tok)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        served.append(tok)
        if rows is not None:
            kept.append(logits[rows, -1].clone())
        end(s + 1)
    out = torch.cat(served, dim=1).cpu()
    t2 = time.perf_counter()
    rec["decode_s"] += t2 - t1
    rec["decode_steps"] += new_tokens - 1
    return out, (None if rows is None else torch.stack(kept, dim=1))


def closed_generate(system, traffic: dict, seconds: float, trace: bool,
                    rng: np.random.Generator, seed: int) -> dict:
    """Batches back to back through ``system.prefill`` and
    ``system.step``; returns the loop's record."""
    B, M = traffic["batch"], traffic["new_tokens"]
    prompts = prompt_stream(traffic, system.vocab, seed, system.device)
    keep = Reservoir(traffic["check_batches"], rng)
    rec = {"units": 0, "requests": 0, "ttft_s": [], "prefill_s": [],
           "decode_s": 0.0, "decode_steps": 0}

    def batch(traced=None):
        slot = keep.offer()
        rows = None
        if slot is not None:
            rows = sorted(rng.choice(B, traffic["check_rows"],
                                     replace=False).tolist())
        tokens = prompts()
        served, logits = _generate_batch(system, tokens, M, rows, rec,
                                         traced)
        if rows is not None:
            keep.put(slot, (tokens[rows], served[rows], logits))
        rec["units"] += 1
        rec["requests"] += B

    if trace:
        from repro_torch import kernels
        plan, T = traffic["trace"], traffic["prompt_len"]
        if "prefills" in plan:
            # each batch's prefill, dispatch to first token on the host
            n_batches, phases = plan["prefills"], (0, 1)
        else:
            s0, s1 = plan["decode_steps"]
            if not 0 <= s0 < s1 <= M - 1:
                raise ValueError(f"traced decode steps [{s0}, {s1}) are not "
                                 f"among a batch's {M - 1}")
            n_batches, phases = 1, (s0 + 1, s1 + 1)
        tracer = Tracer(True)
        got = {"seconds": 0.0, "windows": 0, "launches": {}}

        def start():
            got["window"] = tracer.window()
            got["window"].__enter__()
            got["before"] = dict(kernels.launch_counts())
            got["t0"] = time.perf_counter()

        def stop():
            got["window"].__exit__(None, None, None)
            got["seconds"] += time.perf_counter() - got["t0"]
            for k, v in kernels.launch_counts().items():
                n = v - got["before"].get(k, 0)
                got["launches"][k] = got["launches"].get(k, 0) + n
            got["windows"] += 1
            if got["windows"] == n_batches:
                tracer.__exit__(None, None, None)

        # the profiler runs from before the first batch to the end of the
        # last window; its start-up falls outside every window, in the
        # decode steps before the first traced one, or in a batch of its
        # own before the traced prefills
        tracer.__enter__()
        if phases[0] == 0:
            batch()
        for _ in range(n_batches):
            batch((*phases, start, stop))
        rec["seconds"], launches = got["seconds"], got["launches"]
        work: dict = {}
        if phases[0] == 0:
            for _ in range(n_batches):
                _add(work, system.work("prefill", B, T))
            units = {"prefills": n_batches,
                     "prefill_s": rec["prefill_s"][-n_batches:]}
        else:
            for s in range(s0, s1):
                _add(work, system.work("decode", B, T + s))
            units = {"decode_steps": s1 - s0}
        rec["trace"] = {**tracer.summary, "launches": launches, "work": work,
                        **units}
    else:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            batch()
        rec["seconds"] = time.perf_counter() - t0
    rec["kept"] = keep.items()
    return rec
