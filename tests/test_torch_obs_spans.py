"""The program's own spans on the CPU (``repro_torch.obs.trace``, attached
by ``Strategy.attach_tracer``): ``h2d`` once an epoch, one
``replay.<body>`` on the device lane for each run of a body, both inside
their ``dispatch`` span, ``val_loss`` once a call, and a program that
holds and records nothing untraced.  The card's path (a pair of CUDA
timing events a replay from a pool, placed on the tracer's clock through
an anchor event) runs here against stub events on a stub device clock."""

import time

import numpy as np
import pytest
import torch

from repro_torch import optim as TO
from repro_torch.core.partition import cnn_adapter
from repro_torch.core.strategies import engine as ENG
from repro_torch.core.strategies import make_strategy
from repro_torch.data.synthetic import make_cxr_clients
from repro_torch.models.cnn import DenseNetConfig, build_densenet
from repro_torch.obs import Tracer
from repro_torch.obs.trace import TID_DEVICE

torch.set_num_threads(2)

TINY = DenseNetConfig(growth=4, blocks=(1, 1), stem_ch=8, cut_layer=1)
EPOCHS = 2


@pytest.fixture(scope="module")
def clients():
    return make_cxr_clients(seed=0, train_per_client=[9, 6, 8],
                            val_per_client=5, test_per_client=2,
                            image_size=16, n_clients=3)


def _strategy(method, **kw):
    return make_strategy(method, cnn_adapter(build_densenet(TINY)),
                         lambda: TO.adam(1e-3), 3, device="cpu", **kw)


def _calls(st) -> dict:
    out = {}
    for p in st._programs.values():
        for k, n in p.calls.items():
            out[k] = out.get(k, 0) + n
    return out


def _run(st, clients, state):
    return st.run(state, [c.train for c in clients],
                  np.random.default_rng(1), 2, EPOCHS)


@pytest.mark.parametrize("method, kw", [
    ("sflv3_ac", {}), ("fl", {}), ("sl_am", {}), ("centralized", {}),
    ("sflv3_ac", {"shard": True, "devices": [torch.device("cpu")] * 2}),
    ("fl", {"shard": True, "devices": [torch.device("cpu")] * 2})],
    ids=["sflv3", "fl", "slam", "centralized", "sflv3-placed", "fl-placed"])
def test_replay_spans_count_and_nest(clients, method, kw):
    st = _strategy(method, **kw)
    state = st.setup(0)
    state, _ = _run(st, clients, state)        # the programs exist
    before = _calls(st)
    tracer = st.attach_tracer(Tracer())
    _run(st, clients, state)
    calls = {k: n - before.get(k, 0) for k, n in _calls(st).items()}
    ev = tracer.events
    # every event is a complete span with a start and a length (no
    # Chrome counter): the benchmark reads ``dur`` of each
    assert all(e["ph"] == "X" and e["dur"] > 0 and "ts" in e for e in ev)
    replays = [e for e in ev if e["name"].startswith("replay.")]
    assert all(e["tid"] == TID_DEVICE for e in replays)
    counted = {}
    for e in replays:
        body = e["name"][len("replay."):]
        counted[body] = counted.get(body, 0) + 1
    assert counted == {k: n for k, n in calls.items() if n}
    # a placed SFLv3 step replays its phases (``front``, ``server``,
    # ``back``), no ``step`` body
    assert counted.get("step", 0) == calls.get("step", 0)
    assert replays and counted.get("step", 1) > 0
    (dispatch,) = [e for e in ev if e["name"] == "dispatch"]
    lo, hi = dispatch["ts"], dispatch["ts"] + dispatch["dur"]
    inner = [e for e in ev if e["name"] == "h2d"] + replays
    assert len(inner) == EPOCHS + len(replays)
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e-3
               for e in inner)
    # the replays follow one another on the lane (a placed run's chunk
    # programs place theirs one program after another)
    ends = sorted((e["ts"], e["ts"] + e["dur"]) for e in replays)
    assert all(b <= a2 + 1e-3 for (_, b), (a2, _) in zip(ends, ends[1:]))
    for p in st._programs.values():
        assert p.tracer is None and p._replays == [] and p._events == []


def test_val_loss_one_span_a_call(clients):
    st = _strategy("sflv3_ac")
    state = st.setup(0)
    st.val_loss(state, clients)
    tracer = st.attach_tracer(Tracer())
    losses = [st.val_loss(state, clients) for _ in range(3)]
    assert [e["name"] for e in tracer.events] == ["val_loss"] * 3
    assert all(e["tid"] == 1 and e["args"]["depth"] == 0
               for e in tracer.events)
    st.attach_tracer(None)
    assert st.val_loss(state, clients) == losses[0]
    assert len(tracer.events) == 3


def test_untraced_programs_hold_no_events(clients, monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("an untraced run made a CUDA event")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    st = _strategy("sflv3_ac")
    state = st.setup(0)
    _run(st, clients, state)
    st.val_loss(state, clients)
    (prog,) = st._programs.values()
    assert prog.tracer is None and prog._replays == []
    assert prog._events == [] and prog._anchor is None


# -- the card's path, on stub events -------------------------------------------

class _Clock:
    """A device clock: the host's, 5 s ahead."""

    def __init__(self, tracer):
        self.tracer = tracer

    def now(self):
        return self.tracer.now() + 5.0


class _Event:
    made = 0
    clock = None

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        assert stream == "stream"
        self.t = self.clock.now()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _Graph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


class _Counter(ENG.Program):
    bodies = ("step", "round")

    def __init__(self):
        super().__init__(torch.device("cpu"))
        self.n = 0

    def _step(self):
        time.sleep(2e-3)          # a body of 2 ms
        self.n += 1

    def _round(self):
        self.n += 100


def test_card_stamps_on_the_tracer_clock(monkeypatch):
    tracer = Tracer()
    _Event.made, _Event.clock = 0, _Clock(tracer)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "stream")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    prog = _Counter()
    prog.device = torch.device("cuda", 0)

    def capture(name):
        prog._launch_deltas[name] = []
        prog.graphs[name] = _Graph(getattr(prog, "_" + name))
        return prog.graphs[name]
    monkeypatch.setattr(prog, "_capture", capture)

    def run(n_steps):
        t0 = tracer.now()
        prog.tracer = tracer
        for _ in range(n_steps):
            prog("step")
        prog("round")
        prog.place_replays()
        prog.tracer = None
        return t0, tracer.now()

    prog("step")                  # untraced: no event
    assert _Event.made == 0 and prog.n == 1
    run(3)                        # the round's first call captures: unstamped
    assert [e["name"] for e in tracer.events] == ["replay.step"] * 3
    assert _Event.made == 6 + 1   # a pair a stamped replay, and the anchor
    tracer.events.clear()
    t0, t1 = run(2)
    assert _Event.made == 7       # the pool serves a shorter run
    assert [e["name"] for e in tracer.events] == ["replay.step"] * 2 + [
        "replay.round"]
    # on the tracer's clock, in order, each step 2 ms of device time
    ev = tracer.events
    assert all(e["tid"] == TID_DEVICE for e in ev)
    assert t0 * 1e6 <= ev[0]["ts"] and ev[-1]["ts"] + ev[-1]["dur"] <= (
        t1 * 1e6 + 1e3)
    assert all(2e3 <= e["dur"] < 50e3 for e in ev[:2])
    assert all(a["ts"] + a["dur"] <= b["ts"] + 1e-3
               for a, b in zip(ev, ev[1:]))
    tracer.events.clear()
    run(5)                        # grown to the longest run
    assert _Event.made == 7 + 6 and len(prog._events) == 12
    assert prog.calls == {"step": 11, "round": 3} and prog.n == 311
