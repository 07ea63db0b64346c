"""The general loops: a traffic file's `driver` names one of these
modules, and its parameters drive it. Each module's `run(run)` sets the
program up from the seed, warms the shapes the traffic uses, measures
for the run's seconds, judges the window's answers against the plain
reference and returns a `core.Outcome`."""
