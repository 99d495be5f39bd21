"""The port's timing helpers (``atmonr_tpu_torch/utils/benchmark.py``)
against the JAX package's ``atmonr_tpu/utils/benchmark.py``: the same
scripted iterations under a scripted clock (``time.perf_counter`` patched)
give the same returned step, the same ``on_block`` calls, the same
``[warmup]`` lines on stderr and the same seconds."""

import time

import pytest

from atmonr_tpu.utils import benchmark as jbench
from atmonr_tpu_torch.utils import benchmark as tbench


class _Clock:
    """A clock that moves only when an iteration runs: step ``s`` takes
    ``durations(s)`` seconds."""

    def __init__(self, durations):
        self.now = 100.0
        self.durations = durations
        self.steps = []
        self.fetched = []

    def perf_counter(self):
        return self.now

    def one_iter(self, step):
        self.steps.append(step)
        self.now += self.durations(step)
        return ("out", step)

    def fetch(self, out):
        self.fetched.append(out)


def _run_warm(module, monkeypatch, capsys, durations, **kwargs):
    clock = _Clock(durations)
    monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
    blocks = []
    step = module.warm_until_steady(clock.one_iter, clock.fetch,
                                    on_block=lambda n, dt: blocks.append((n, dt)), **kwargs)
    monkeypatch.undo()
    return {"step": step, "blocks": blocks, "steps": clock.steps, "fetched": clock.fetched,
            "stderr": capsys.readouterr().err}


# step durations: converge at the second block; a slow first block; a drift
# that never settles (max_iters); a spread just outside and just inside tol
WARM_CASES = {
    "steady": (lambda s: 0.01, {}),
    "slow_start": (lambda s: 0.05 if s < 10 else 0.01, {"block": 10}),
    "never_steady": (lambda s: 0.01 * (1.2 ** (s // 5)), {"block": 5, "max_iters": 40}),
    "outside_tol": (lambda s: 0.01 * (1.06 ** (s // 4)), {"block": 4, "max_iters": 24}),
    "inside_tol": (lambda s: 0.01 * (1.04 ** (s // 4)), {"block": 4, "tol": 0.05}),
    "start_step": (lambda s: 0.02 if s < 33 else 0.01, {"start_step": 7, "block": 13}),
    "max_below_block": (lambda s: 0.01, {"block": 50, "max_iters": 30}),
}


@pytest.mark.parametrize("case", sorted(WARM_CASES))
def test_warm_until_steady_matches_jax(case, monkeypatch, capsys):
    """Returned step, every ``on_block`` call (iterations, seconds), the
    steps run, the fetches and the stderr lines: equal."""
    durations, kwargs = WARM_CASES[case]
    want = _run_warm(jbench, monkeypatch, capsys, durations, **kwargs)
    got = _run_warm(tbench, monkeypatch, capsys, durations, **kwargs)
    assert got == want
    assert got["blocks"] and got["stderr"].count("[warmup] block ending at step") == len(
        got["blocks"])


@pytest.mark.parametrize("start_step,iters", [(0, 1), (5, 250), (17, 50)])
def test_timed_window_matches_jax(start_step, iters, monkeypatch):
    """The seconds, the steps run and the one fetch at the end: equal."""
    out = {}
    for name, module in (("jax", jbench), ("port", tbench)):
        clock = _Clock(lambda s: 0.001 * (1 + s % 7))
        monkeypatch.setattr(time, "perf_counter", clock.perf_counter)
        sec = module.timed_window(clock.one_iter, clock.fetch, start_step=start_step,
                                  iters=iters)
        monkeypatch.undo()
        out[name] = (sec, clock.steps, clock.fetched)
    assert out["port"] == out["jax"]
    assert out["port"][1] == list(range(start_step, start_step + iters))
    assert out["port"][2] == [("out", start_step + iters - 1)]
