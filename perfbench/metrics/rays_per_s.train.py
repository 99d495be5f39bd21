"""rays_per_s.train (rays/s, higher; host clock; layer trainer; moves
setup_s, whose compared and warm-up steps are this work; train cells):
every ray of every ``Trainer.step`` in the window over the window's
seconds, the window opened and closed on a device synchronisation;
occupancy refreshes, progress scatters and epoch wraps in it included.
Per layer and not end to end: the step is bound by host launch work, and
its rate follows the shared host's speed from run to run by more than
the largest bound allows (PERF.md)."""


def read(run):
    return run.work["rays"] / run.window_s
