"""As ``test_perfbench_faults_state``: faults in how the window's program
lays out its epoch make a run of a small cell on the CPU come out NOT
correct.  The small cell's hospitals hold three or four batches, so the
short ones wrap around in the epoch's last step, as the paper's small
hospitals do in the cells."""

from conftest import mini_parts

from perfbench import harness


def run(seed=2 ** 32 + 11):
    return harness.run("mini", seed, 0.1, False, 0.0, device="cpu",
                       b=harness.bench(), parts=mini_parts())


def test_short_hospital_not_wrapping_is_not_correct(cpu_threads, monkeypatch):
    from repro_torch.core.strategies import engine

    def no_wrap(n_batches, nb_max, steps):
        # a short hospital repeats its last batch instead of its first
        return [[c * nb_max + min(s, nb - 1) for c, nb in enumerate(n_batches)]
                for s in range(steps)]
    monkeypatch.setattr(engine, "sync_rows", no_wrap)
    out = run()
    assert not out["correct"]
    # the epoch's last step, where a hospital wraps around
    assert out["checks"]["epoch_loss_gap"]["value"] > out["checks"][
        "epoch_loss_gap"]["limit"]


def test_unshuffled_epoch_is_not_correct(cpu_threads, monkeypatch):
    from repro_torch.core.strategies import engine

    pack = engine.pack_participation_run

    def unshuffled(client_data, batch_size, rng, *a, **kw):
        return pack(client_data, batch_size, None, *a, **kw)
    monkeypatch.setattr(engine, "pack_participation_run", unshuffled)
    out = run()
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"][
        "limit"]
