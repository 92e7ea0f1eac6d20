"""A run of a small cell on the CPU (the harness's look for a card skipped)
comes out correct, and comes out NOT correct when the timed path is broken
underneath: here a step that returns its state unchanged.  (The cells run
on one card, so there is no exchange between cards to leave out.)"""

from conftest import mini_parts

from perfbench import harness


def run(seed=12345):
    parts = mini_parts()
    return harness.run("mini", seed, 0.1, False, 0.0, device="cpu",
                       b=harness.bench(), parts=parts)


def test_sound_run_is_correct(cpu_threads):
    out = run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_unchanged_state_is_not_correct(cpu_threads, monkeypatch):
    from repro_torch.core.strategies import splitfed

    make = splitfed.sflv3_step_fn

    def frozen(*a, **kw):
        step = make(*a, **kw)

        def f(clients, server, c_opts, s_opt, batches, draws=None):
            out = step(clients, server, c_opts, s_opt, batches, draws)
            return (clients, server, c_opts, s_opt, *out[4:])
        return f
    monkeypatch.setattr(splitfed, "sflv3_step_fn", frozen)
    out = run()
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == 1.0
