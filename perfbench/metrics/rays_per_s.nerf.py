"""rays_per_s.nerf (rays/s, higher; host clock; layer trainer; moves
setup_s, whose compared and warm-up steps are this work; NeRF train
cells): every ray of every ``Trainer.step`` in the window over the
window's seconds, the window opened and closed on a device
synchronisation."""


def read(run):
    return run.work["rays"] / run.window_s
