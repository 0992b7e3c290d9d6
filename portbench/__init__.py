"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
training step a cell, timed whole on the card and checked against a plain
reference.  ``portbench/README.md`` says how to run a cell and how to add
a configuration, a traffic mix, a cell or a per-layer metric as files."""
