"""Command-line entry points: ``train`` (the training driver, with the RNS
gradient all-reduce), ``serve`` (the serve CLI) and ``dryrun`` (one step
of each (arch, shape, mesh) cell on ``meta`` DTensors over a fake process
group, with ``costs`` and ``roofline_report``); ``mesh`` builds the
device meshes and ``profiling`` the profiler window."""
