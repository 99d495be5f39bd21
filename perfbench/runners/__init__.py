"""Traffic runners, one module a kind of traffic, found by the ``runner``
name in a traffic file. Each has ``run(run, seed, seconds, trace, t0)``,
which fills the ``harness.Run`` record."""
